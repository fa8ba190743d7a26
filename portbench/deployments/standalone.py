"""``BallistaContext.standalone()``: the engine in the benchmark's process,
on one card. One context per stream, each with the tables registered.

What a window observes: the engines' operator metrics of every query
(``ctx.last_engine_metrics``, folded), the leaf caches' hits and misses
(``torch_engine._ENC_CACHE`` and ``_DEV_CACHE``), and with a trace the
device profile and grouped_sums' bytes. The peak of device memory is
``devtrace.PeakWatch``'s.
"""
from __future__ import annotations

import devtrace
import roofline


def fold(into: dict, metrics: dict) -> None:
    """Adds an engine's operator metrics to ``into`` (peaks: the largest)."""
    for k, v in metrics.items():
        if k.endswith(".max_bytes"):
            into[k] = max(into.get(k, 0.0), float(v))
        else:
            into[k] = into.get(k, 0.0) + float(v)


class GroupedSumsRecorder:
    """Counts the bytes of every card call of ``grouped_sums_multi`` made
    while installed (warm runs of the compile service excluded)."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0
        self._real = None

    def install(self) -> None:
        import ballista_tpu_torch.ops.grouped_sums as GS

        real = self._real = GS.grouped_sums_multi

        def recorded(vals, masks, ids, k):
            if ids.device.type == "cuda" and not GS.is_warming():
                self.calls += 1
                self.bytes += roofline.grouped_sums_bytes(vals, masks, ids, k)
            return real(vals, masks, ids, k)

        GS.grouped_sums_multi = recorded

    def remove(self) -> None:
        import ballista_tpu_torch.ops.grouped_sums as GS

        if self._real is not None:
            GS.grouped_sums_multi = self._real
            self._real = None


class Standalone:
    def __init__(self, device: str, settings: dict, streams: int):
        from ballista_tpu_torch.client.context import BallistaContext
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.engine import torch_engine as TE

        self.TE = TE
        self.peaks = devtrace.PeakWatch(device.startswith("cuda"))
        self.contexts = [BallistaContext.standalone(BallistaConfig(dict(settings)), device=device)
                         for _ in range(streams)]
        self.device = device
        self.tracer = self.recorder = None

    def register(self, paths: dict) -> None:
        for ctx in self.contexts:
            for name, path in paths.items():
                ctx.register_parquet(name, path)

    def warm(self, rounds: list, rotations: int) -> None:
        """The first ``rotations`` rounds of set-up's instances."""
        for instances in rounds[:rotations]:
            for inst in instances:
                self.contexts[0].sql(inst.sql).collect()

    def _caches(self) -> tuple:
        c = (self.TE._ENC_CACHE, self.TE._DEV_CACHE)
        return sum(x.hits for x in c), sum(x.misses for x in c)

    def begin(self, trace: bool) -> None:
        self.engine: dict = {}
        self.leaf0 = self._caches()
        if trace:
            self.recorder = GroupedSumsRecorder()
            self.recorder.install()
            if self.device.startswith("cuda"):
                self.tracer = devtrace.Tracer()
                self.tracer.start()

    def run(self, stream: int, sql: str):
        ctx = self.contexts[stream]
        table = ctx.sql(sql).collect()
        fold(self.engine, ctx.last_engine_metrics)
        return table

    def end(self) -> dict:
        hits, misses = (b - a for a, b in zip(self.leaf0, self._caches()))
        out = {"engine": self.engine, "leaf": {"hits": hits, "misses": misses}}
        if self.tracer is not None:
            out["profile"] = devtrace.reduce(self.tracer.stop())
            self.tracer = None
        if self.recorder is not None:
            self.recorder.remove()
            out["grouped_sums"] = {"calls": self.recorder.calls, "bytes": self.recorder.bytes}
            self.recorder = None
        return out

    def peak_bytes(self) -> int:
        return self.peaks.read()

    def close(self) -> None:
        if self.contexts:
            self.contexts = []
            self.TE.clear_caches()
            self.peaks.remove()
            import torch

            if torch.cuda.is_available():
                torch.cuda.empty_cache()


def start(config: dict, device: str, settings: dict, work_dir: str, streams: int):
    return Standalone(device, settings, streams)
