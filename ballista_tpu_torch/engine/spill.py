"""Disk spill for bounded-memory execution.

Three users (VERDICT r4 #4 — the 1e9-row q5 OOM):

* the standalone in-process hash exchange (`NumpyEngine._repartitioned`)
  switches from in-memory accumulation to per-output-partition IPC files
  once the input exceeds ``ballista.exchange.spill_rows`` — the reference's
  materialized shuffle as memory relief valve
  (arrow-ballista: ballista/core/src/execution_plans/shuffle_writer.rs:233-329
  streams batches to per-partition writers, never holding the exchange);
* streamed final aggregates spill partial-aggregate STATES to hash buckets
  once the resident fold exceeds ``ballista.agg.spill_state_rows``, then
  merge bucket-by-bucket (two-phase bucketed aggregation) — resident memory
  is bounded by one bucket, not by the distinct-group count;
* the paged device join (``TorchEngine._paged_join``): both sides of a join
  whose program cannot fit the device budget are hash-split into buckets and
  joined one bucket pair at a time.

Files are Arrow IPC, compressed with the session's shuffle codec, read back memory-mapped batch-by-batch (same discipline
as shuffle/stream.py). A spill owns a TemporaryDirectory; close() or GC
removes it.
"""
from __future__ import annotations

import os
import tempfile
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

from ballista_tpu_torch.ops.batch import ColumnBatch


class PartitionSpill:
    """Append ColumnBatches hash-split over ``n`` output partitions (or
    directly to a chosen partition), then read one partition at a time."""

    def __init__(self, n: int, exprs, base_dir: Optional[str] = None,
                 salted: bool = False, compression: str = ""):
        from ballista_tpu_torch.shuffle.writer import IPC_MAX_CHUNK_ROWS, codec_of

        self.n = n
        self.exprs = list(exprs)
        self.salted = salted
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
        self._tmp = tempfile.TemporaryDirectory(prefix="spill-", dir=base_dir or None)
        # ballista.shuffle.compression governs spill files too (docs/shuffle.md)
        self._opts = ipc.IpcWriteOptions(compression=codec_of(compression))
        self._max_chunk = IPC_MAX_CHUNK_ROWS
        self._writers: dict[int, ipc.RecordBatchFileWriter] = {}
        self._files: dict[int, pa.OSFile] = {}
        self._rows = [0] * n
        self._schema: Optional[pa.Schema] = None
        self._finished = False
        self.spilled_rows = 0
        self.spilled_bytes = 0

    # SALTED bucket hash (``salted=True``, the agg-state spill): spilled
    # aggregate states were produced by an upstream hash exchange over the
    # SAME keys with the SAME splitmix64 — reusing that hash % n would
    # collapse a partition's states into 16/gcd(n_parts, n) buckets (ONE
    # bucket when n_parts is a multiple of 16), silently reloading the whole
    # spill in the merge phase. One extra salted finalizer round decorrelates
    # the bucket choice from the exchange's partition choice. The EXCHANGE
    # spill must stay UNSALTED: its in-memory accumulation prefix used the
    # standard hash, and mixing the two would split groups across partitions.
    _SALT = np.uint64(0xD6E8FEB86659FD93)

    def _bucket_ids(self, batch: ColumnBatch) -> np.ndarray:
        from ballista_tpu_torch.ops.kernels_np import (
            combined_key, evaluate, hash_partition_indices, splitmix64,
        )

        if not self.salted:
            return hash_partition_indices(batch, self.exprs, self.n)
        key, _valid = combined_key([evaluate(e, batch) for e in self.exprs])
        mixed = splitmix64(key.view(np.uint64) ^ self._SALT)
        return (mixed % np.uint64(self.n)).astype(np.int64)

    # ---- write ----------------------------------------------------------------------
    def append_split(self, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        ids = self._bucket_ids(batch)
        for idx in np.unique(ids):
            part = batch.take(np.nonzero(ids == idx)[0])
            if part.num_rows:
                self.append_to(int(idx), part)

    def append_to(self, idx: int, batch: ColumnBatch) -> None:
        assert not self._finished
        table = batch.to_arrow()
        if self._schema is None:
            self._schema = table.schema
        elif table.schema != self._schema:
            table = table.cast(self._schema)
        w = self._writers.get(idx)
        if w is None:
            f = pa.OSFile(self._path(idx), "wb")
            w = ipc.new_file(f, self._schema, options=self._opts)
            self._writers[idx] = w
            self._files[idx] = f
        w.write_table(table, max_chunksize=self._max_chunk)
        self._rows[idx] += batch.num_rows
        self.spilled_rows += batch.num_rows

    def finish(self) -> None:
        for idx, w in self._writers.items():
            w.close()
            self._files[idx].close()
            self.spilled_bytes += os.path.getsize(self._path(idx))
        self._writers.clear()
        self._files.clear()
        self._finished = True

    # ---- read -----------------------------------------------------------------------
    def rows(self, idx: int) -> int:
        return self._rows[idx]

    def read_chunks(self, idx: int) -> Iterator[ColumnBatch]:
        """Memory-mapped batch-by-batch read of one partition."""
        assert self._finished
        path = self._path(idx)
        if not os.path.exists(path):
            return
        with pa.memory_map(path, "rb") as source:
            reader = ipc.open_file(source)
            for i in range(reader.num_record_batches):
                yield ColumnBatch.from_arrow(
                    pa.Table.from_batches([reader.get_batch(i)])
                )

    def read_all(self, idx: int, schema) -> ColumnBatch:
        chunks = list(self.read_chunks(idx))
        if not chunks:
            return ColumnBatch.empty(schema)
        return chunks[0] if len(chunks) == 1 else ColumnBatch.concat(chunks)

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        for f in self._files.values():
            f.close()
        self._writers.clear()
        self._files.clear()
        self._tmp.cleanup()

    def _path(self, idx: int) -> str:
        return os.path.join(self._tmp.name, f"part-{idx}.arrow")


class SpilledParts:
    """Lazy stand-in for the in-memory ``list[ColumnBatch]`` a materialized
    exchange produces: ``parts[i]`` reads partition i back from disk on
    demand — the exchange never lives in RAM at once."""

    def __init__(self, spill: PartitionSpill, schema):
        self.spill = spill
        self.schema = schema

    def __len__(self) -> int:
        return self.spill.n

    def __getitem__(self, idx: int) -> ColumnBatch:
        if not 0 <= idx < self.spill.n:
            raise IndexError(idx)  # list semantics: mask no partition-count bugs
        return self.spill.read_all(idx, self.schema)
