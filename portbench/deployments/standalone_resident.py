"""``standalone`` over a warehouse that its one card holds whole: the
deployment of ``BallistaContext.standalone()`` whose scan leaves and fused
inputs stay on the card between queries.

The configuration names the bytes its rotation keeps on the card
(``resident_bytes``). Before any data is made, a run on a card checks that
the program's device leaf cache may hold them: what a CUDA engine sizes it
to (``memory_model.device_cache_bytes`` of the card's budget), or its fixed
capacity where the program has no such rule. A cache smaller than the
working set of a cyclic rotation never hits: every query would scan,
encode and copy its leaves again, which is another deployment (the ad-hoc
one) and outlasts a run. The run then stops at once, with the reason and
exit code 1. Everything else is ``standalone``'s.
"""
from __future__ import annotations

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "portbench_deployments_standalone_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "standalone.py"))
standalone = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(standalone)


def device_cache_bytes(device: str) -> int:
    """The bytes the program's leaf caches may keep on ``device``."""
    from ballista_tpu_torch.engine import memory_model as MM
    from ballista_tpu_torch.engine import torch_engine as TE

    rule = getattr(MM, "device_cache_bytes", None)
    if rule is None:
        return int(TE._DEV_CACHE.capacity)
    return int(rule(MM.detect_device_budget_bytes(device)))


def start(config: dict, device: str, settings: dict, work_dir: str, streams: int):
    if device.startswith("cuda"):
        need = int(config["resident_bytes"])
        have = device_cache_bytes(device)
        if have < need:
            raise SystemExit(
                f"portbench: the program's device leaf cache holds {have} bytes, less than "
                f"the {need} this deployment keeps on the card; every query would scan and "
                "encode its leaves again: not run")
    return standalone.start(config, device, settings, work_dir, streams)
