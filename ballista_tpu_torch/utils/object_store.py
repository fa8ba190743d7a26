"""Object-store registry: URL-scheme dispatch to filesystems.

Reference analog: ``BallistaObjectStoreRegistry``
(``arrow-ballista: ballista/core/src/object_store_registry/mod.rs:38-147``):
local FS / S3 / GCS / Azure / HDFS behind feature flags, injected into the
runtime. Here the backends are pyarrow filesystems — GCS first (TPU VMs live
next to GCS), S3 via pyarrow's S3FileSystem; unknown schemes raise with the
scheme named.
"""
from __future__ import annotations

import os
from typing import Optional
from urllib.parse import urlparse

from ballista_tpu_torch.errors import PlanningError


class ObjectStoreRegistry:
    def __init__(self):
        self._custom: dict[str, object] = {}

    def register(self, scheme: str, filesystem) -> None:
        self._custom[scheme] = filesystem

    def resolve(self, url: str) -> tuple[object, str]:
        """Returns (pyarrow filesystem, path-within-store)."""
        import pyarrow.fs as pafs

        parsed = urlparse(url)
        scheme = parsed.scheme or "file"
        if scheme in self._custom:
            return self._custom[scheme], parsed.netloc + parsed.path
        if scheme == "file" or (len(scheme) == 1 and url[1] == ":"):  # plain/windows path
            return pafs.LocalFileSystem(), url if not parsed.scheme else parsed.path
        if scheme in ("gs", "gcs"):
            return pafs.GcsFileSystem(), parsed.netloc + parsed.path
        if scheme in ("s3", "s3a"):
            return pafs.S3FileSystem(), parsed.netloc + parsed.path
        if scheme == "hdfs":
            return pafs.HadoopFileSystem(parsed.hostname or "default", parsed.port or 8020), parsed.path
        raise PlanningError(
            f"no object store registered for scheme {scheme!r} (url {url!r}); "
            "register one via ObjectStoreRegistry.register"
        )


GLOBAL_OBJECT_STORES = ObjectStoreRegistry()


def list_parquet_files(url: str) -> tuple[object, list[str]]:
    """List parquet files under a URL on its object store."""
    import pyarrow.fs as pafs

    fs, path = GLOBAL_OBJECT_STORES.resolve(url)
    info = fs.get_file_info(path)
    if info.type == pafs.FileType.Directory:
        sel = pafs.FileSelector(path, recursive=False)
        files = sorted(
            f.path for f in fs.get_file_info(sel)
            if f.type == pafs.FileType.File and f.path.endswith(".parquet")
        )
    elif info.type == pafs.FileType.File:
        files = [path]
    else:
        raise PlanningError(f"no such path: {url}")
    # re-attach the scheme so downstream readers (pyarrow URI support) work
    scheme = urlparse(url).scheme
    if scheme and scheme != "file":
        files = [f"{scheme}://{f}" for f in files]
    return fs, files


# ---- shuffle object-store tier (reference: ObjectStoreRemote, shuffle_reader.rs:340) --
def shuffle_object_url(base_url: str, piece_path: str) -> str:
    """Object URL for one shuffle piece, derived by CONVENTION from the
    piece's local path (``.../<job>/<stage>/<out_partition>/<basename>`` —
    the writer layout, shuffle_writer.rs:68-84). Deriving instead of shipping
    a URL per piece keeps the wire protocol unchanged: every consumer knows
    the session's object-store root and the piece's local path."""
    parts = piece_path.replace(os.sep, "/").split("/")
    return base_url.rstrip("/") + "/" + "/".join(parts[-4:])


def upload_file(local_path: str, url: str) -> None:
    import posixpath
    import shutil
    import uuid

    import pyarrow.fs as pafs

    fs, path = GLOBAL_OBJECT_STORES.resolve(url)
    parent = posixpath.dirname(path)
    if parent:
        fs.create_dir(parent, recursive=True)
    if not isinstance(fs, pafs.LocalFileSystem):
        # GCS/S3-class stores commit the object atomically on stream close
        # (multipart/resumable upload) — a preempted producer leaves nothing;
        # tmp+move would just double the server-side write cost
        with open(local_path, "rb") as src, fs.open_output_stream(path) as out:
            shutil.copyfileobj(src, out, 1 << 20)
        return
    # local filesystems write in place: tmp + move so a producer preempted
    # mid-upload never leaves a truncated object at the conventional path
    # (a consumer falling back to it would FetchFail into a stage re-run)
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    try:
        with open(local_path, "rb") as src, fs.open_output_stream(tmp) as out:
            shutil.copyfileobj(src, out, 1 << 20)
        fs.move(tmp, path)
    except BaseException:
        try:
            fs.delete_file(tmp)
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass
        raise


def delete_prefix(url: str) -> None:
    """Best-effort recursive delete of a directory-like object prefix —
    shuffle cleanup for the object-store tier (ADVICE r4: uploaded shuffle
    objects must not outlive their job; mirrors the executor's local
    work-dir job cleanup, executor_server.rs remove_job_data)."""
    fs, path = GLOBAL_OBJECT_STORES.resolve(url)
    try:
        fs.delete_dir(path)
    except FileNotFoundError:
        pass
    except Exception:  # noqa: BLE001 - cleanup is best-effort by contract
        import logging

        logging.getLogger("ballista.object_store").debug(
            "object prefix cleanup failed for %s", url, exc_info=True
        )


def download_file(url: str, dest: str) -> str:
    import shutil
    import uuid

    fs, path = GLOBAL_OBJECT_STORES.resolve(url)
    tmp = f"{dest}.tmp-{uuid.uuid4().hex[:8]}"
    with fs.open_input_stream(path) as src, open(tmp, "wb") as out:
        shutil.copyfileobj(src, out, 1 << 20)
    os.replace(tmp, dest)
    return dest


# ---- optional disk read-through cache (reference: cache_layer file medium) --------
import threading as _threading

_IO_CACHE = None
_IO_CACHE_MU = _threading.Lock()


def io_cached_path(url: str) -> str:
    """Local path for a remote file when BALLISTA_IO_CACHE_DIR is set: the
    file is copied next to this executor ONCE (DiskFileCache, LRU byte
    budget) and later scans read it locally. Local paths pass through."""
    import os

    d = os.environ.get("BALLISTA_IO_CACHE_DIR")
    if not d or "://" not in url:
        return url
    global _IO_CACHE
    with _IO_CACHE_MU:
        if _IO_CACHE is None or _IO_CACHE.dir != d:
            from ballista_tpu_torch.utils.cache import DiskFileCache

            _IO_CACHE = DiskFileCache(
                d, int(os.environ.get("BALLISTA_IO_CACHE_BYTES", 16 * 1024**3))
            )
        cache = _IO_CACHE
    return cache.get_local(url)
