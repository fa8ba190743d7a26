"""PyBallista-compatible API surface.

Reference analog: the PyO3 binding (``arrow-ballista: python/src/context.rs:
43-120``, ``pyballista/tests/test_context.py``): ``SessionContext(host, port)``
with ``sql`` / ``read_csv`` / ``read_parquet`` / ``register_csv`` /
``register_parquet`` / ``execute_logical_plan``. This build is native Python,
so the "binding" is a thin naming shim over BallistaContext — drop-in for
PyBallista user code. A standalone ``SessionContext`` runs the torch engine
on ``cuda`` unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from typing import Optional

from ballista_tpu_torch.client.context import BallistaContext, DataFrame


class SessionContext:
    def __init__(self, host: Optional[str] = None, port: int = 50050, backend: str = "torch",
                 device: Optional[str] = None):
        if host:
            self._ctx = BallistaContext.remote(host, port)
        else:
            # the torch engine runs on cuda unless device="cpu" (raises
            # without CUDA)
            self._ctx = BallistaContext.standalone(backend=backend, device=device)

    # reference: PySessionContext::sql
    def sql(self, query: str) -> DataFrame:
        return self._ctx.sql(query)

    def read_parquet(self, path: str) -> DataFrame:
        return self._ctx.read_parquet(path)

    def read_csv(self, path: str, has_header: bool = True) -> DataFrame:
        return self._ctx.read_csv(path, has_header=has_header)

    def read_json(self, path: str) -> DataFrame:
        return self._ctx.read_json(path)

    def read_avro(self, path: str) -> DataFrame:
        # a DataFrame over the registered table, as read_parquet gives
        name = f"__read_{len(self._ctx.catalog.tables)}"
        self._ctx.register_avro(name, path)
        return self._ctx.table(name)

    def register_parquet(self, name: str, path: str) -> None:
        self._ctx.register_parquet(name, path)

    def register_csv(self, name: str, path: str, has_header: bool = True) -> None:
        self._ctx.register_csv(name, path, has_header=has_header)

    def register_json(self, name: str, path: str) -> None:
        self._ctx.register_json(name, path)

    def table(self, name: str) -> DataFrame:
        return self._ctx.table(name)

    def tables(self) -> list[str]:
        return self._ctx.catalog.names()

    def execute_logical_plan(self, plan) -> DataFrame:
        return DataFrame(self._ctx, plan)
