"""Shuffle piece integrity: per-piece crc32 checksums, verified on fetch.

Before this layer a bit-flipped shuffle file produced WRONG RESULTS: a flip
in an lz4 block usually raises on decode (already a fetch failure), but a
flip in decoded data values sails straight into the aggregation. The chaos
layer's ``shuffle.write:corrupt`` schedule makes this failure mode routine,
so every piece now carries a checksum and a mismatch surfaces as
``FetchFailed`` for the map partition — the EXISTING lineage rollback then
re-runs the producer partition (new attempt => new ``-aN`` path => fresh
bytes + fresh checksum) instead of returning corrupt rows.

Mechanics: the writer computes crc32 over the finished IPC file's bytes and
writes it to a tiny JSON sidecar (``<piece>.crc``) next to the piece — a
detached footer (the Arrow IPC file format closes with its own footer +
magic, so the checksum cannot live inside the file without breaking
``ipc.open_file``). Verification happens at every consumption edge:

* the Flight server verifies a piece before streaming it (``do_get``);
* local fast-path readers verify before the memory-mapped read;
* object-store fallbacks verify downloads against the uploaded sidecar.

A missing sidecar skips verification (files from older builds, checksums
disabled via ``ballista.shuffle.checksum=false``). Retry loops detect the
``checksum mismatch`` marker in error text and short-circuit: corruption is
deterministic, so burning the Flight backoff budget on it only delays the
rollback that actually fixes it.
"""
from __future__ import annotations

import json
import os
import uuid
import zlib

import threading
from collections import OrderedDict

from ballista_tpu_torch.errors import BallistaError

CRC_SUFFIX = ".crc"
_CHUNK = 1 << 20

# pieces are immutable after seal, so a full crc pass per FETCH would double
# data-plane disk reads for hot pieces (N reducers, retry rounds). Verified
# pieces are remembered by (path, size, mtime_ns) — an in-place bit-flip
# after a verify leaves size intact but bumps mtime, so re-verification
# still catches it; a re-written path (new attempt) has a new identity.
_VERIFIED_CAP = 8192
_verified: "OrderedDict[tuple, None]" = OrderedDict()
_verified_lock = threading.Lock()

# the marker retry loops grep for; keep it stable across error re-wrapping
MISMATCH_MARKER = "checksum mismatch"


class ChecksumMismatch(BallistaError):
    """A shuffle piece's bytes do not match its recorded checksum."""

    def __init__(self, path: str, expected: int, actual: int):
        self.path = path
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"{MISMATCH_MARKER} for {path}: expected crc32 {expected:#010x}, "
            f"got {actual:#010x}"
        )


def is_integrity_error(e: BaseException) -> bool:
    """Whether an exception (possibly a Flight re-wrap of the server's
    error) reports a checksum mismatch — deterministic, not worth retrying."""
    return MISMATCH_MARKER in str(e)


def checksum_path(path: str) -> str:
    return path + CRC_SUFFIX


def crc32_of_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def crc32_of_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def write_checksum(path: str) -> int:
    """Record ``path``'s crc32 in its sidecar (atomic tmp+rename — a reader
    racing the write sees either no sidecar or a complete one). Returns the
    crc. The extra read-back of just-written bytes rides the page cache."""
    crc = crc32_of_file(path)
    payload = json.dumps(
        {"algo": "crc32", "crc32": crc, "num_bytes": os.path.getsize(path)}
    ).encode()
    sidecar = checksum_path(path)
    tmp = f"{sidecar}.tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, sidecar)
    return crc


def parse_sidecar(data: bytes) -> int | None:
    """Decode sidecar payload bytes to the recorded crc32, or None when
    malformed — the ONE place the sidecar format is interpreted (local
    reads and object-store downloads both go through it)."""
    try:
        meta = json.loads(data.decode())
        return int(meta["crc32"]) & 0xFFFFFFFF
    except (ValueError, KeyError, TypeError, AttributeError):
        return None


def expected_checksum(path: str) -> int | None:
    """The recorded crc32 for a piece, or None when no (readable) sidecar
    exists — verification is then skipped, never failed."""
    try:
        with open(checksum_path(path), "rb") as f:
            return parse_sidecar(f.read())
    except OSError:
        return None


def _piece_identity(path: str) -> tuple | None:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (path, st.st_size, st.st_mtime_ns)


def verify_piece(path: str) -> None:
    """Verify a piece against its sidecar; raises ChecksumMismatch. Pieces
    without a sidecar pass (checksums are an additive integrity tier). A
    piece already verified at its current (size, mtime) identity passes on
    a cache hit — one crc pass per sealed piece per process, not per fetch."""
    ident = _piece_identity(path)
    if ident is not None:
        with _verified_lock:
            if ident in _verified:
                _verified.move_to_end(ident)
                return
    expected = expected_checksum(path)
    if expected is None:
        return
    actual = crc32_of_file(path)
    if actual != expected:
        raise ChecksumMismatch(path, expected, actual)
    if ident is not None:
        with _verified_lock:
            _verified[ident] = None
            while len(_verified) > _VERIFIED_CAP:
                _verified.popitem(last=False)


def verify_bytes(path: str, data: bytes, expected: int | None) -> None:
    """Verify in-memory piece bytes (object-store fallback reads) against a
    known checksum; None skips."""
    if expected is None:
        return
    actual = crc32_of_bytes(data)
    if actual != expected:
        raise ChecksumMismatch(path, expected, actual)


def remote_expected_checksum(object_store_url: str, piece_path: str) -> int | None:
    """The crc32 recorded in a piece's UPLOADED sidecar, or None when the
    store has no (readable) sidecar — the ONE verification edge both
    object-store fallback tiers (in-memory fetch and to-file download)
    share."""
    from ballista_tpu_torch.utils.object_store import (
        GLOBAL_OBJECT_STORES,
        shuffle_object_url,
    )

    try:
        fs, opath = GLOBAL_OBJECT_STORES.resolve(
            shuffle_object_url(object_store_url, checksum_path(piece_path))
        )
        with fs.open_input_file(opath) as f:
            return parse_sidecar(f.read())
    except Exception:  # noqa: BLE001 - no sidecar uploaded: unverified
        return None


def verify_downloaded(object_store_url: str, piece_path: str, dest: str) -> None:
    """Verify a piece downloaded from the object store to ``dest`` against
    its uploaded sidecar; missing sidecar skips."""
    expected = remote_expected_checksum(object_store_url, piece_path)
    if expected is None:
        return
    actual = crc32_of_file(dest)
    if actual != expected:
        raise ChecksumMismatch(dest, expected, actual)
