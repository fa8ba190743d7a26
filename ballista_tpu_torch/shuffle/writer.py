"""Shuffle writer: materialize hash-partitioned stage output as Arrow IPC files.

Reference analog: ``ShuffleWriterExec::execute_shuffle_write``
(``arrow-ballista: ballista/core/src/execution_plans/shuffle_writer.rs:174-336``):
file layout ``work_dir/<job>/<stage>/<out_partition>/data-<in_partition>.arrow``,
compressed IPC, per-partition {path,rows,bytes} stats returned to the scheduler.

The split uses the native ``partition_order`` single-pass slicing (one
argsort-equivalent pass over the batch, N zero-copy-ish takes), and the N
per-output-partition IPC files are written CONCURRENTLY on a bounded pool —
lz4 encode + file IO release the GIL, so a 16-way exchange no longer
serializes 16 compress+write legs behind one another. Object-store uploads
(the producer-loss redundancy tier) are launched per file as it lands,
overlapped with the remaining writes rather than tacked on after.
"""
from __future__ import annotations

import functools
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import pyarrow as pa
import pyarrow.ipc as ipc

from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.ops.kernels_np import hash_partition
from ballista_tpu_torch.plan.physical import ShuffleWriterExec

# shuffle compression is a session knob now (ballista.shuffle.compression,
# docs/shuffle.md): '' = uncompressed (default), 'lz4' / 'zstd' compress the
# piece files, the Flight wire AND the streamed-fetch spill files. pyarrow
# bundles both codecs; an unknown/unavailable name degrades to uncompressed
# with a warning rather than failing the task.
SUPPORTED_CODECS = ("lz4", "zstd")


def codec_of(name: str):
    """Validated Arrow IPC codec name for a knob value, or None (off).
    Memoized: this sits on per-piece write and per-fetch-attempt paths, so
    the availability probe runs (and the unavailable warning logs) once per
    distinct knob value, not once per piece."""
    return _codec_of_cached((name or "").strip().lower())


@functools.lru_cache(maxsize=16)
def _codec_of_cached(name: str):
    if name in ("", "off", "none", "false", "0"):
        return None
    if name in SUPPORTED_CODECS:
        try:
            if pa.Codec.is_available(name):
                return name
        except Exception:  # noqa: BLE001 - probe failure = unavailable
            pass
    logging.getLogger("ballista.shuffle").warning(
        "shuffle compression codec %r unavailable; writing uncompressed", name
    )
    return None


def spill_write_options(codec: str) -> ipc.IpcWriteOptions:
    """IpcWriteOptions for spill files / the Flight wire, honoring the
    session codec (shared by stream.py and flight.py)."""
    return ipc.IpcWriteOptions(compression=codec_of(codec))
# record-batch granularity inside shuffle files: readers mmap and decompress
# per batch, so this bounds consumer memory per piece (the reference streams
# 8192-row batches; 64k keeps the columnar kernels vectorised at ~1/100 the
# per-batch overhead)
IPC_MAX_CHUNK_ROWS = 65_536
# bounded write/upload fan-out per task (disk+NIC bound, not CPU bound)
WRITE_CONCURRENCY = 8


@dataclass
class ShuffleWriteStats:
    output_partition: int
    path: str
    num_rows: int
    num_bytes: int
    write_time_s: float = 0.0


def piece_suffix(stage_attempt: int, task_attempt: int = 0) -> str:
    """Attempt suffix of a shuffle piece filename: ``""``, ``-a<sa>`` or
    ``-a<sa>t<ta>``. Stage attempts namespace re-runs after rollbacks;
    TASK attempts namespace retries and — crucially — speculative BACKUP
    attempts (task_attempt >= SPECULATIVE_ATTEMPT_OFFSET), so the loser of
    a speculation race can never clobber or alias the winner's sealed file
    anywhere (local dir or the shared object-store prefix). Equivalent-
    attempt launch twins share both numbers and therefore still write
    byte-identical paths, which the scheduler's twin acceptance relies on."""
    if not stage_attempt and not task_attempt:
        return ""
    s = f"-a{stage_attempt}"
    return f"{s}t{task_attempt}" if task_attempt else s


def write_shuffle_partitions(
    plan: ShuffleWriterExec,
    input_partition: int,
    batch: ColumnBatch,
    work_dir: str,
    stage_attempt: int = 0,
    object_store_url: str = "",
    checksums: bool = True,
    dict_codes: bool = True,
    task_attempt: int = 0,
    compression: str = "",
) -> list[ShuffleWriteStats]:
    """Partition one input partition's output and write one IPC file per
    output partition — files written concurrently (bounded pool), uploads
    overlapped. ``stage_attempt`` namespaces the file so a zombie task of a
    rolled-back attempt can never truncate a newer attempt's registered file
    (readers get the exact path from the task's reported locations). When
    ``object_store_url`` is set, each finished file is ALSO uploaded so
    consumers survive producer loss without a stage re-run (reference:
    PartitionReaderEnum::ObjectStoreRemote, shuffle_reader.rs:340-363)."""
    from ballista_tpu_torch.obs.tracing import Phase, ambient_span

    # wire codes apply only to INTERNAL hash exchanges: pass-through stages
    # (partitioning None) include the job's RESULT stage, whose files are
    # served verbatim to external Flight SQL clients — those must stay plain
    # Arrow strings, not engine-private code columns
    dict_codes = dict_codes and plan.partitioning is not None
    t0 = time.time()
    with Phase("ballista.shuffle.write"), ambient_span(
        "shuffle-write", "shuffle",
        {"stage": plan.stage_id, "input_partition": input_partition},
    ) as span:
        if plan.partitioning is None:
            # pass-through: this task's output partition IS its input partition
            parts = {input_partition: batch}
        else:
            parts = dict(
                enumerate(hash_partition(batch, list(plan.partitioning.exprs), plan.partitioning.n))
            )
        opts = ipc.IpcWriteOptions(compression=codec_of(compression))
        suffix = piece_suffix(stage_attempt, task_attempt)

        def write_one(out_idx: int, part: ColumnBatch) -> ShuffleWriteStats:
            from ballista_tpu_torch.ops.batch import to_wire_table

            d = os.path.join(work_dir, plan.job_id, str(plan.stage_id), str(out_idx))
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"data-{input_partition}{suffix}.arrow")
            # shared-dictionary string columns ride as int32 codes + a
            # dictionary reference (docs/strings.md) — fewer bytes on Flight,
            # crc over codes; the reader rebuilds identical strings.
            # refs_only: code only PLAN-claimed columns — the consumer's
            # serde payload ships exactly those dictionaries
            table = to_wire_table(part, getattr(plan, "dict_refs", None),
                                  dict_codes, refs_only=True)
            with pa.OSFile(path, "wb") as f:
                with ipc.new_file(f, table.schema, options=opts) as w:
                    w.write_table(table, max_chunksize=IPC_MAX_CHUNK_ROWS)
            seal_piece(path, checksums)
            return ShuffleWriteStats(
                out_idx, path, part.num_rows, os.path.getsize(path), time.time() - t0
            )

        items = sorted(parts.items())
        if len(items) == 1:
            stats = [write_one(*items[0])]
            if object_store_url:
                upload_shuffle_file(stats[0].path, object_store_url)
        else:
            stats_by_idx: dict[int, ShuffleWriteStats] = {}
            # uploads get their OWN pool: sharing the write pool would queue
            # them behind pending writes instead of overlapping (NIC-bound
            # uploads and disk-bound writes contend on nothing)
            uploader = (
                ThreadPoolExecutor(
                    max_workers=min(WRITE_CONCURRENCY, len(items)),
                    thread_name_prefix="shuffle-upload",
                )
                if object_store_url
                else None
            )
            try:
                upload_futs = []
                with ThreadPoolExecutor(
                    max_workers=min(WRITE_CONCURRENCY, len(items)),
                    thread_name_prefix="shuffle-write",
                ) as pool:

                    def write_and_upload(out_idx: int, part: ColumnBatch) -> ShuffleWriteStats:
                        s = write_one(out_idx, part)
                        if uploader is not None:
                            # overlap the (best-effort) upload with sibling writes
                            upload_futs.append(
                                uploader.submit(upload_shuffle_file, s.path, object_store_url)
                            )
                        return s

                    for out_idx, s in zip(
                        (i for i, _ in items),
                        pool.map(lambda it: write_and_upload(*it), items),
                    ):
                        stats_by_idx[out_idx] = s
                for f in upload_futs:
                    f.result()  # best-effort inside; never raises
            finally:
                if uploader is not None:
                    uploader.shutdown(wait=True)
            stats = [stats_by_idx[i] for i, _ in items]
        if span is not None:
            span.set("bytes", sum(s.num_bytes for s in stats))
            span.set("rows", sum(s.num_rows for s in stats))
            span.set("partitions", len(stats))
        return stats


def seal_piece(path: str, checksums: bool) -> None:
    """Finalize one written shuffle piece: record its crc32 sidecar, then
    run the ``shuffle.write`` corruption fault point. Order matters — the
    checksum describes the TRUE bytes, so an injected bit-flip afterwards
    is exactly the silent-disk-corruption scenario the fetch-side
    verification exists to catch."""
    from ballista_tpu_torch.shuffle.integrity import write_checksum
    from ballista_tpu_torch.utils import faults

    if checksums:
        write_checksum(path)
    faults.corrupt_file("shuffle.write", path)


def upload_shuffle_file(path: str, object_store_url: str) -> None:
    """BEST-EFFORT upload of one finished shuffle file to the object-store
    tier. Failures are logged, never raised: the tier is redundancy for
    producer loss — a store outage must not turn into a new single point of
    failure for tasks whose local files are fine (consumers fall back to
    Flight, and to FetchFailed-driven recovery, exactly as if the tier were
    disabled). The crc32 sidecar rides along so fallback downloads verify
    against the same checksum as Flight fetches."""
    from ballista_tpu_torch.shuffle.integrity import checksum_path
    from ballista_tpu_torch.utils.object_store import shuffle_object_url, upload_file

    try:
        upload_file(path, shuffle_object_url(object_store_url, path))
        sidecar = checksum_path(path)
        if os.path.exists(sidecar):
            upload_file(sidecar, shuffle_object_url(object_store_url, sidecar))
    except Exception:  # noqa: BLE001 - best effort by design
        logging.getLogger("ballista.shuffle").warning(
            "object-store upload of %s failed; consumers will rely on "
            "Flight + lineage recovery", path, exc_info=True,
        )


def read_ipc_file(path: str) -> pa.Table:
    with pa.OSFile(path, "rb") as f:
        with ipc.open_file(f) as r:
            return r.read_all()
