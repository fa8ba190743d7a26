"""ballista_tpu_torch: the PyTorch/CUDA port of ballista_tpu.

A second package beside the JAX one, which stays the reference. The SQL
front end, plan IR and host kernels are the JAX package's device-neutral
modules, copied; the device stages run as PyTorch tensor programs on one
device (CUDA unless the caller asks for the CPU), and the JAX package's
Pallas kernel is a hand-written CUDA kernel for Hopper (``csrc/``). The port
imports neither ``jax`` nor ``ballista_tpu``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy exports so importing the package stays cheap (no torch import)
    if name == "BallistaContext":
        from ballista_tpu_torch.client.context import BallistaContext

        return BallistaContext
    if name == "BallistaConfig":
        from ballista_tpu_torch.config import BallistaConfig

        return BallistaConfig
    raise AttributeError(name)
