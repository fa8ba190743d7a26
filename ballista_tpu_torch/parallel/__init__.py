"""Device-resident exchanges over a world of devices.

The port of ``ballista_tpu/parallel``. A fused exchange is written for any
number of devices, with the collective passed in: an object whose
``all_to_all(buf)`` takes this device's send buffer ``[n_dev, cap]`` (row
``j`` goes to device ``j``) and returns the rows received ``[n_dev, cap]``
(row ``j`` from device ``j``), and whose ``all_sum(x)`` sums a scalar over
the world. The port supplies the world of one device, where both are the
identity; a world of several GPUs needs a process group, which is not ported
yet.
"""
from __future__ import annotations

from ballista_tpu_torch.errors import ExecutionError


class SingleDevice:
    """The world of one device: every collective is the identity."""

    n_dev = 1

    def all_to_all(self, buf):
        return buf

    def all_sum(self, x):
        return x


def collective_for(n_dev: int) -> SingleDevice:
    """The collective of an ``n_dev``-device exchange in this process. Raises
    for more than one device: a multi-GPU exchange needs a process group,
    and the port never falls back to a materialized exchange in its place."""
    if n_dev == 1:
        return SingleDevice()
    raise ExecutionError(
        f"a fused exchange over {n_dev} devices needs a torch.distributed process group, "
        "which is not ported yet: run the torch engine with mesh_devices = 1"
    )
