#!/usr/bin/env python3
"""One executor of the ``cluster`` deployment: the port's executor binary
(``ballista_tpu_torch.executor``'s ``main()``) in this process, with the
benchmark's device trace and memory peak beside it.

    python3 portbench/cluster_executor.py <executor options>

The executor options are the binary's own. ``PORTBENCH_CONTROL`` names a
directory the deployment and this process share:

- ``begin`` (written by the deployment; ``trace`` or ``notrace``): with
  ``trace`` on a card, ``devtrace.Tracer`` starts, and ``started`` is
  written with its start (``time.time_ns()``);
- ``end`` (written by the deployment): the tracer stops, and ``result.json``
  holds the window's events (names interned) and the allocator's peak over
  the whole process (``devtrace.PeakWatch``).

The files are watched from a thread, so a main thread blocked in the
executor's loop answers at once; SIGTERM stops the executor as it stops the
binary. Exits with 5 after the executor stops when a module of JAX or of the
JAX package was loaded (``run.py`` checks only its own process; the
deployment raises on that code when it stops the executor).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import devtrace  # noqa: E402
import run  # noqa: E402

# how often the control directory is looked at, in seconds
WATCH_S = 0.02


def _write(path: str, text: str) -> None:
    """``text`` into ``path`` whole: written beside it, then renamed."""
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def _interned(events: list) -> dict:
    """The trace's events with each name once: ``names`` and ``events`` of
    ``[name index, on device, start ns, end ns]``."""
    index: dict = {}
    rows = []
    for name, on_device, a, b in events:
        rows.append([index.setdefault(name, len(index)), bool(on_device), a, b])
    return {"names": list(index), "events": rows}


def watch(control: str, on_card: bool, peaks: "devtrace.PeakWatch", stop: threading.Event) -> None:
    """Answers the deployment's ``begin`` and ``end`` (module docstring)."""
    tracer = None
    begun = False
    while not stop.wait(WATCH_S):
        if not begun and os.path.exists(os.path.join(control, "begin")):
            begun = True
            with open(os.path.join(control, "begin")) as f:
                traced = f.read().strip() == "trace"
            start_ns = time.time_ns()
            if traced and on_card:
                tracer = devtrace.Tracer()
                tracer.start()
                start_ns = tracer.start_ns
            _write(os.path.join(control, "started"), str(start_ns))
        if begun and os.path.exists(os.path.join(control, "end")):
            out = {"peak_bytes": peaks.read(), "trace": None}
            if tracer is not None:
                trace = tracer.stop()
                out["trace"] = dict(_interned(trace["events"]), start_ns=trace["start_ns"],
                                    end_ns=trace["end_ns"])
            _write(os.path.join(control, "result.json"), json.dumps(out))
            return


def main() -> int:
    control = os.environ["PORTBENCH_CONTROL"]
    device = "cuda"
    if "--device" in sys.argv:
        device = sys.argv[sys.argv.index("--device") + 1]
    import torch

    on_card = device.startswith("cuda") and torch.cuda.is_available()
    # before any engine runs: every stage resets the allocator's peak
    peaks = devtrace.PeakWatch(on_card)
    stop = threading.Event()
    watcher = threading.Thread(target=watch, args=(control, on_card, peaks, stop),
                               daemon=True, name="portbench-watch")
    watcher.start()
    from ballista_tpu_torch.executor.__main__ import main as executor_main

    sys.argv = ["ballista-executor"] + sys.argv[1:]
    try:
        executor_main()
    finally:
        stop.set()
    bad = run.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr, flush=True)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
