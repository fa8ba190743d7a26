"""The pluggable stage-execution seam.

Reference analog: the ``ExecutionEngine`` trait
(``arrow-ballista: ballista/executor/src/execution_engine.rs:31-54``) — the
executor's hook for swapping the kernel backend. Implementations here:

* ``NumpyEngine`` — host columnar kernels; the CPU baseline and the TPU-free
  backend for scheduler/executor tests (survey §4's ``FakeDeviceBackend``).
* ``TorchEngine`` — stages run as PyTorch tensor programs on one device
  (CUDA by default), with hand-written kernels where the JAX package had
  Pallas ones.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from ballista_tpu_torch.config import BallistaConfig

if TYPE_CHECKING:
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan.physical import PhysicalPlan


class ExecutionEngine:
    """Executes physical plan subtrees partition-by-partition."""

    name = "base"

    def execute_partition(self, plan: "PhysicalPlan", partition: int) -> "ColumnBatch":
        raise NotImplementedError

    def execute_partition_stream(self, plan: "PhysicalPlan", partition: int):
        """Yield the partition as a stream of ``ColumnBatch`` chunks. Engines
        that can pipeline (chunked shuffle ingest, fold-style aggregates)
        override this for bounded-memory execution; the default materialises.
        (Reference: operators stream record batches — shuffle_reader.rs:136.)"""
        yield self.execute_partition(plan, partition)

    def execute_all(self, plan: "PhysicalPlan") -> list["ColumnBatch"]:
        return [
            self.execute_partition(plan, i) for i in range(plan.output_partitions())
        ]


def create_engine(
    backend: str, config: BallistaConfig | None = None, device: str | None = None
) -> ExecutionEngine:
    """``device`` applies to the torch backend only (see
    ``TorchEngine.__init__``: None means ``cuda``)."""
    if backend == "numpy":
        from ballista_tpu_torch.engine.numpy_engine import NumpyEngine

        engine: ExecutionEngine = NumpyEngine(config)
    elif backend == "torch":
        from ballista_tpu_torch.engine.torch_engine import TorchEngine

        engine = TorchEngine(config, device=device)
    else:
        raise ValueError(f"unknown engine backend {backend!r}")
    if config is not None:
        from ballista_tpu_torch.config import BALLISTA_DATA_CACHE

        engine.data_cache_enabled = bool(config.get(BALLISTA_DATA_CACHE))
    return engine
