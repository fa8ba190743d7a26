"""Shared fixtures of the benchmark's tests. Run from the repository root:

    python -m pytest portbench/tests            # CPU
    python -m pytest portbench/tests -m cuda    # on a card

The harness's modules are imported from ``portbench/``; card tests decide
inside the ``card`` fixture whether there is one."""
import os
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
for _p in (ROOT, PORTBENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# a small scale factor the CPU runs every cell at
SF = 0.01


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def restore_port():
    """Puts back every module attribute a fault replaces."""
    from ballista_tpu_torch.engine import torch_engine as TE
    from ballista_tpu_torch.ops import grouped_sums as GS

    saved = [(GS, "grouped_sums_multi"), (TE, "_leaf_cache_key")]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    yield
    for m, a, v in saved:
        setattr(m, a, v)
