"""TPC-H queries on the port's torch engine, with the shape of every join probe.

    python3 -m ballista_tpu_torch.tools.tpch_join_shapes [--sf 1] [--device cuda] [q3 q5 ...]

Generates the eight tables with the port's generator (seed 42, ``--parts``
files per large table) under ``--data``, then runs each query (all 22 by
default) cold and warm and prints: the walls, the device stages, the host
fallbacks and the operator kinds that ran on host kernels, and for each join
(kind, collected build or partitioned, keys) the probes made, the largest
duplicate bucket, and the largest probe and build pads. ``--explain`` also
prints each query's physical plan. A stage that falls back to the host is
named with the reason. The shapes are what a hand-written probe kernel
would be sized for.
"""
from __future__ import annotations

import argparse
import os
import time
import traceback

_KINDS = ("FilterExec", "ProjectExec", "HashAggregateExec", "SortExec",
          "HashJoinExec", "CrossJoinExec", "WindowExec")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("queries", nargs="*", default=[f"q{i}" for i in range(1, 23)])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--data", default=".chip_smoke_data")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--explain", action="store_true")
    args = ap.parse_args()

    import ballista_tpu_torch.engine.torch_engine as TE
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.models.tpch import generate_tpch

    t0 = time.time()
    tables = generate_tpch(os.path.join(args.data, f"tpch_sf{args.sf:g}_p{args.parts}"),
                           sf=args.sf, parts_per_table=args.parts)
    print(f"tables at sf={args.sf:g}: {time.time() - t0:.1f} s", flush=True)

    shapes: dict = {}
    real_probe, real_stage = TE._probe_join, TE.TorchEngine._timed_stage

    def probe(plan, probe_db, build_dev, bk_sorted, max_dup):
        key = (plan.how, "collected" if plan.collect_build else "partitioned", repr(plan.on))
        s = shapes.setdefault(key, [0, 0, 0, 0])
        s[0] += 1
        s[1] = max(s[1], max_dup)
        s[2] = max(s[2], probe_db.n_pad)
        s[3] = max(s[3], build_dev.n_pad)
        return real_probe(plan, probe_db, build_dev, bk_sorted, max_dup)

    def stage(self, plan, part):
        try:
            return real_stage(self, plan, part)
        except (TE._HostFallback, TE.KT.DeviceUnsupported) as e:
            where = traceback.extract_tb(e.__traceback__)[-1]
            print(f"  host fallback: {type(plan).__name__} partition {part}, "
                  f"{type(e).__name__} {e} at {where.name}:{where.lineno}", flush=True)
            raise

    TE._probe_join, TE.TorchEngine._timed_stage = probe, stage
    ctx = BallistaContext.standalone(device=args.device)
    for name, path in tables.items():
        ctx.register_parquet(name, path)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for q in args.queries:
        with open(os.path.join(root, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        if args.explain:
            print(ctx.sql("explain " + sql).collect().column("plan")[1].as_py(), flush=True)
        walls = []
        for _ in ("cold", "warm"):
            shapes.clear()
            t0 = time.time()
            ctx.sql(sql).collect()
            walls.append(time.time() - t0)
        m = ctx.last_engine_metrics
        host = sorted({k.split(".")[1] for k in m
                       if k.endswith(".time_s") and k.split(".")[1] in _KINDS})
        print(f"{q}: wall cold {walls[0]:.3f} s, warm {walls[1]:.3f} s; device stages "
              f"{m.get('op.DeviceExecute.count', 0.0):g}; host fallbacks "
              f"{m.get('op.HostFallback.count', 0.0):g}, on host kernels {host}", flush=True)
        for (how, side, on), (n, dup, ppad, bpad) in shapes.items():
            print(f"  {how} join, {side} build, on {on}: {n} probes, duplicate bucket "
                  f"{dup}, probe pad {ppad}, build pad {bpad}", flush=True)


if __name__ == "__main__":
    main()
