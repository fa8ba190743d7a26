"""Interactive SQL REPL.

Reference analog: ``ballista-cli`` (``arrow-ballista: ballista-cli/src/
{main.rs,exec.rs,command.rs}``): ``--host/--port`` remote or in-process
standalone, dot-commands, file execution (``-f``), timing toggle.
Run: ``python -m ballista_tpu_torch.client.cli [--host H --port P] [-f script.sql]``.

A standalone CLI runs the torch engine on ``--device``, ``cuda`` unless
``--device cpu`` is given (``--backend numpy`` runs the host engine). Without
CUDA and without ``--device cpu`` it exits with status 2 and names the
reason: it never falls back to the CPU. ``--format`` applies to a ``-f``
script's results too (the JAX package's CLI prints those as tables).
"""
from __future__ import annotations

import argparse
import sys
import time

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.errors import BallistaError


def _print_table(table, max_rows: int = 100, fmt: str = "table") -> None:
    # output formats (reference: print format options in ballista-cli)
    if fmt == "csv":
        import io

        import pyarrow.csv as pacsv

        buf = io.BytesIO()
        pacsv.write_csv(table, buf)
        print(buf.getvalue().decode(), end="")
        return
    if fmt == "json":
        import json

        for row in table.to_pylist():
            print(json.dumps(row, default=str))
        return
    df = table.to_pandas()
    total = len(df)
    if total > max_rows:
        df = df.head(max_rows)
    print(df.to_string(index=False))
    print(f"({total} row{'s' if total != 1 else ''})")


HELP = """\
.help               show this help
.tables             list registered tables
.schema <table>     show a table's columns and types
.format table|csv|json   set the output format
.timing on|off      toggle query timing
.quit | .exit       leave the REPL
Any other input is executed as SQL (terminate with ';' or newline).
"""


def run_command(ctx: BallistaContext, line: str, timing: bool, fmt: str = "table") -> None:
    t0 = time.time()
    df = ctx.sql(line)
    table = df.collect()
    _print_table(table, fmt=fmt)
    if fmt == "table":
        # submission-time plan analyzer warnings (EXPLAIN VERIFY rule set)
        for w in getattr(ctx, "last_warnings", []):
            print(f"WARNING {w}", file=sys.stderr)
    if timing and fmt == "table":
        print(f"Query took {time.time() - t0:.3f} seconds")


def repl(ctx: BallistaContext, timing: bool = True) -> None:
    print("ballista-tpu SQL REPL — .help for commands")
    buf: list[str] = []
    fmt = "table"
    while True:
        try:
            prompt = "ballista> " if not buf else "       -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        stripped = line.strip()
        if not buf and stripped.startswith("."):
            cmd = stripped.split()
            if cmd[0] in (".quit", ".exit"):
                return
            if cmd[0] == ".help":
                print(HELP)
            elif cmd[0] == ".tables":
                for n in ctx.catalog.names():
                    print(n)
            elif cmd[0] == ".schema" and len(cmd) > 1:
                try:
                    for f in ctx.catalog.get(cmd[1]).schema:
                        print(f"  {f.name}  {f.dtype.value}")
                except Exception as e:
                    print(f"error: {e}")
            elif cmd[0] == ".format" and len(cmd) > 1 and cmd[1] in ("table", "csv", "json"):
                fmt = cmd[1]
                print(f"format {fmt}")
            elif cmd[0] == ".timing" and len(cmd) > 1:
                timing = cmd[1] == "on"
                print(f"timing {'on' if timing else 'off'}")
            else:
                print(f"unknown command {cmd[0]!r}; .help for help")
            continue
        buf.append(line)
        if stripped.endswith(";") or (stripped and not buf[:-1]):
            sql = "\n".join(buf)
            buf = []
            if not sql.strip().rstrip(";").strip():
                continue
            try:
                run_command(ctx, sql, timing, fmt)
            except BallistaError as e:
                print(f"error: {e}")
            except Exception as e:  # noqa: BLE001
                print(f"error: {type(e).__name__}: {e}")


def main() -> None:
    p = argparse.ArgumentParser("ballista-tpu SQL CLI (PyTorch/CUDA port)")
    p.add_argument("--host", default=None, help="scheduler host (omit for standalone)")
    p.add_argument("--port", type=int, default=50050)
    p.add_argument("--backend", choices=["torch", "numpy"], default="torch",
                   help="standalone engine backend")
    p.add_argument("--device", default="cuda",
                   help="the standalone torch engine's device (default cuda; "
                        "'cpu' runs it on the host)")
    p.add_argument("-f", "--file", default=None, help="execute a SQL script and exit")
    p.add_argument("-c", "--command", default=None, help="execute one SQL statement and exit")
    p.add_argument("--format", choices=["table", "csv", "json"], default="table")
    p.add_argument("--plugin-dir", default=None,
                   help="UDF plugin modules to load (client parses SQL, so it "
                        "must know plugin function names)")
    args = p.parse_args()

    config = None
    if args.plugin_dir:
        from ballista_tpu_torch.config import BALLISTA_PLUGIN_DIR, BallistaConfig

        config = BallistaConfig().set(BALLISTA_PLUGIN_DIR, args.plugin_dir)
    if args.host:
        ctx = BallistaContext.remote(args.host, args.port, config=config)
    else:
        try:
            ctx = BallistaContext.standalone(config=config, backend=args.backend,
                                             device=args.device)
        except BallistaError as e:
            print(f"ballista-cli: {e}", file=sys.stderr, flush=True)
            sys.exit(2)

    if args.command:
        run_command(ctx, args.command, timing=False, fmt=args.format)
        return
    if args.file:
        text = open(args.file).read()
        for stmt in [s.strip() for s in text.split(";") if s.strip()]:
            print(f"> {stmt[:80]}{'...' if len(stmt) > 80 else ''}")
            run_command(ctx, stmt, timing=True, fmt=args.format)
        return
    repl(ctx)


if __name__ == "__main__":
    main()
