"""Scalar UDF registry + plugin discovery.

Reference analog: the dlopen plugin manager + UDF plugin trait
(``arrow-ballista: ballista/core/src/plugin/{mod.rs,plugin_manager.rs,udf.rs}``
— ``plugin_manager.rs:30-80`` scans a plugin dir at startup, version-checks
each library, and registers what it exports). Python needs no dynamic
linking: UDFs register as vectorized callables (numpy in / numpy out) with a
declared signature, get injected into the SQL planner's function namespace,
and evaluate host-side (device stages treat UDF-bearing expressions as host
work). A version guard mirrors the reference's rustc/core version check.

Discovery, mirroring the reference's two loading shapes:

- **Plugin dir** (``ballista.plugin_dir`` / ``--plugin-dir``):
  ``load_plugin_dir`` imports every ``*.py`` in the directory. A plugin
  module declares either a module-level ``UDFS`` list of :class:`ScalarUdf`
  or a ``register_udfs(registry)`` hook. Errors are fatal (the operator
  explicitly configured the dir).
- **Entry points** (``importlib.metadata``, group ``ballista_tpu_torch.udfs``):
  each entry point resolves to a ScalarUdf, an iterable of them, or a
  callable taking the registry. A broken third-party distribution logs and
  is skipped rather than killing the process.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

from ballista_tpu_torch import __version__
from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.schema import DataType

logger = logging.getLogger(__name__)

ENTRY_POINT_GROUP = "ballista_tpu_torch.udfs"


@dataclass(frozen=True)
class ScalarUdf:
    name: str
    fn: Callable  # (*np.ndarray) -> np.ndarray
    arg_types: tuple[DataType, ...]
    return_type: DataType
    framework_version: str = __version__


class UdfRegistry:
    def __init__(self):
        self._udfs: dict[str, ScalarUdf] = {}

    def register(self, udf: ScalarUdf) -> None:
        if udf.framework_version.split(".")[0] != __version__.split(".")[0]:
            raise PlanningError(
                f"udf {udf.name!r} built for framework {udf.framework_version}, "
                f"this is {__version__}"
            )
        self._udfs[udf.name.lower()] = udf

    def register_function(
        self, name: str, fn: Callable, arg_types: list[DataType], return_type: DataType
    ) -> None:
        self.register(ScalarUdf(name, fn, tuple(arg_types), return_type))

    def get(self, name: str) -> Optional[ScalarUdf]:
        return self._udfs.get(name.lower())

    def names(self) -> list[str]:
        return sorted(self._udfs)


# process-global registry (the reference's global plugin manager)
GLOBAL_UDFS = UdfRegistry()


def _register_exports(obj, registry: UdfRegistry, origin: str) -> list[str]:
    """Register whatever shape ``obj`` is (ScalarUdf | iterable | hook)."""
    if isinstance(obj, ScalarUdf):
        registry.register(obj)
        return [obj.name]
    if callable(obj):
        before = set(registry.names())
        obj(registry)
        return sorted(set(registry.names()) - before)
    if isinstance(obj, Iterable):
        names = []
        for u in obj:
            if not isinstance(u, ScalarUdf):
                raise PlanningError(f"{origin}: UDFS entries must be ScalarUdf, got {type(u).__name__}")
            registry.register(u)
            names.append(u.name)
        return names
    raise PlanningError(f"{origin}: cannot register {type(obj).__name__} as a UDF export")


def load_plugin_dir(plugin_dir: str, registry: UdfRegistry = GLOBAL_UDFS) -> list[str]:
    """Import every ``*.py`` module under ``plugin_dir`` and register its UDFs.

    Returns the registered UDF names. Missing dir or a broken plugin raises
    (the dir was explicitly configured — fail loudly, like the reference's
    startup plugin scan).
    """
    import importlib.util

    if not os.path.isdir(plugin_dir):
        raise PlanningError(f"plugin dir {plugin_dir!r} does not exist")
    loaded: list[str] = []
    for fname in sorted(os.listdir(plugin_dir)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(plugin_dir, fname)
        modname = f"ballista_tpu_plugin_{fname[:-3]}"
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            raise PlanningError(f"plugin {path}: import failed: {e}") from e
        export = getattr(mod, "register_udfs", None) or getattr(mod, "UDFS", None)
        if export is None:
            raise PlanningError(
                f"plugin {path}: defines neither register_udfs(registry) nor UDFS"
            )
        loaded += _register_exports(export, registry, path)
    logger.info("loaded %d UDFs from plugin dir %s: %s", len(loaded), plugin_dir, loaded)
    return loaded


def load_entry_point_udfs(
    registry: UdfRegistry = GLOBAL_UDFS, group: str = ENTRY_POINT_GROUP, entry_points=None
) -> list[str]:
    """Register UDFs advertised through ``importlib.metadata`` entry points.

    ``entry_points`` is injectable for tests. Per-entry failures are logged
    and skipped: a broken third-party distribution must not take down an
    executor that never asked for it.
    """
    if entry_points is None:
        import importlib.metadata as _md

        entry_points = _md.entry_points(group=group)
    loaded: list[str] = []
    for ep in entry_points:
        try:
            loaded += _register_exports(ep.load(), registry, f"entry point {ep.name}")
        except Exception:
            logger.exception("skipping broken UDF entry point %r", ep.name)
    if loaded:
        logger.info("loaded %d UDFs from entry points: %s", len(loaded), loaded)
    return loaded


def load_plugins(plugin_dir: Optional[str], registry: UdfRegistry = GLOBAL_UDFS) -> list[str]:
    """Startup discovery: entry points always, plugin dir when configured."""
    loaded = load_entry_point_udfs(registry)
    if plugin_dir:
        loaded += load_plugin_dir(plugin_dir, registry)
    return loaded
