"""Device (PyTorch) columnar kernels.

The port of ``ballista_tpu/ops/kernels_jax.py``: the same column model and
the same semantics, as plain functions on torch tensors that run on whatever
device their inputs lie on (the engine carries the device; nothing here holds
global device state). Semantics mirror ``kernels_np`` exactly — the numpy
engine is the oracle.

Execution model:
* a partition lives on the device as fixed-width tensors padded to a
  power-of-two bucket with a ``row_valid`` mask — filters AND into the mask
  instead of compacting;
* strings never reach the device: they travel as int32 dictionary codes with a
  host-side dictionary; string predicates become lookup tables evaluated on
  the (tiny) dictionary and gathered by code on the device;
* grouping: direct mixed-radix segment ids when key cardinality is provably
  small (dictionary sizes / value ranges), else sort-based segmentation over
  the splitmix64 hash of the keys (``group_ids_sorted``);
* keys hash with splitmix64 in int64 (torch has no uint64 shift or
  multiply): the bits equal ``kernels_np.splitmix64``'s uint64, so device
  join probes meet host-hashed build keys and ``hash_bucket_dev`` buckets
  rows as ``kernels_np.hash_partition_indices`` does;
* segment sums and counts over at most ``MASKED_SEG_K`` groups go through the
  hand-written CUDA kernel ``grouped_sums`` (``ops/grouped_sums.py``): an
  aggregate stage gathers them in ``SegSums`` and makes one multi-column
  call per accumulator type.

PyTorch runs eagerly, so every function here dispatches its ops as it goes;
the only host syncs are the ones ``to_host`` needs to size its fetch.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.batch import Column, ColumnBatch
# the decimal sniff is shared with the host kernels' exact decimal windows
from ballista_tpu_torch.ops.kernels_np import (  # noqa: F401
    MAX_DECIMAL_SCALE, lit_decimal_scale, sniff_decimal,
)
from ballista_tpu_torch.plan.expr import (
    Alias, BinaryOp, Case, Cast, Col, Expr, Func, InList, IsNull, Like, Lit, Not,
)
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

# ---- native-dtype (decimal) policy -------------------------------------------------
# FLOAT64 columns whose values are exact short decimals enter the device as
# SCALED INT64 (data = value * 10^scale, ``DeviceCol.scale``); exact
# arithmetic (compare / + / - / * / min / max / SUM) stays in int64, so sums
# are exact and sort keys and group radices are native integer ops. Division,
# AVG output and transcendentals descale to f32; non-decimal FLOAT64 data
# downcasts to f32 when that is lossless. The host engine keeps f64 (it is
# the semantics oracle) and ``to_host`` descales at the boundary. Trace-time
# overflow analysis on propagated value ranges rescales (or falls back to the
# host) before an int64 sum could wrap. Config ``ballista.tpu.native_dtypes``
# (set by TorchEngine) turns the policy off.
NATIVE_DTYPES = True
_I64_SAFE = 1 << 62     # headroom bound for scaled-int64 intermediates

_TORCH_OF = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def tdtype(np_dt) -> torch.dtype:
    """The torch dtype of a numpy dtype (a DataType's ``to_numpy()``)."""
    return _TORCH_OF[np.dtype(np_dt)]


def _fdiv(a, b):
    """Floor division (``jnp.floor_divide``); never truncation."""
    return torch.div(a, b, rounding_mode="floor")


def _i64(u: int) -> int:
    """The signed int64 holding the bits of the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64's constants (kernels_np / kernels_jax hold them as uint64)
_GOLDEN = _i64(0x9E3779B97F4A7C15)
_C1 = _i64(0xBF58476D1CE4E5B9)
_C2 = _i64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64_dev(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 holding uint64 bits: the adds and
    multiplies wrap in two's complement, which leaves the low 64 bits of the
    unsigned result, so the output bits equal ``kernels_np.splitmix64``'s."""
    x = x.to(torch.int64)
    x = x + _GOLDEN
    x = x ^ _shr(x, 30)
    x = x * _C1
    x = x ^ _shr(x, 27)
    x = x * _C2
    x = x ^ _shr(x, 31)
    return x


def bucket_size(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


# ---- device column/batch ----------------------------------------------------------
@dataclass
class DeviceCol:
    dtype: DataType
    data: torch.Tensor             # numeric value, or int32 dictionary codes for strings
    null: Optional[torch.Tensor] = None  # True where NULL
    dictionary: Optional[np.ndarray] = None  # host strings; present iff dtype==STRING
    # static value range (lo, span): all non-null values lie in [lo, lo+span).
    # Captured host-side at encode time (bucketed) — it bounds GROUP BY
    # cardinality, turning int keys into direct radix codes. For scaled
    # decimals the range is in SCALED units and also drives int64-overflow
    # analysis before sums/products.
    range: Optional[tuple[int, int]] = None
    # decimal scale: data is int64 holding value * 10^scale (native-dtype
    # policy). None = data is stored at its natural dtype.
    scale: Optional[int] = None
    # subset-sum bound (scaled units): sum(|v|) over all rows, bucketed — the
    # tight overflow bound for segment sums (any group's sum lies in
    # [-ssum, ssum] however rows are grouped)
    ssum: Optional[int] = None
    # catalog-shared dictionary reference (see engine/dictionaries.py)
    dict_id: Optional[str] = None

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    @property
    def abs_bound(self) -> Optional[int]:
        """Trace-time bound on |value| in scaled units, from the static range."""
        if self.range is None:
            return None
        lo, span = self.range
        return max(abs(int(lo)), abs(int(lo) + int(span)))


@dataclass
class DeviceBatch:
    schema: Schema
    cols: list[DeviceCol]
    row_valid: torch.Tensor  # bool [n_pad]
    n_rows: int              # logical rows (<= n_pad)

    def col(self, name: str) -> DeviceCol:
        return self.cols[self.schema.index_of(name)]

    @property
    def n_pad(self) -> int:
        return int(self.row_valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_valid.device


# ---- decimal scaling helpers -------------------------------------------------------
def f32_exact(vals: np.ndarray, valid: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """f32 re-encode of an f64 column when LOSSLESS: every valid value
    round-trips f64->f32->f64 bit-identically. NaN columns stay f64."""
    v = vals if valid is None else np.where(valid, vals, 0.0)
    f32 = v.astype(np.float32)
    chk = f32.astype(np.float64)
    ok = chk == v if valid is None else (chk == v) | ~valid
    if not np.all(ok):
        return None
    return f32


def descale_f32(c: DeviceCol) -> torch.Tensor:
    """Scaled int64 -> approximate f32 values (division/transcendental path)."""
    assert c.scale is not None
    return _as_float(c, torch.float32)


def _round_half_even_div(x: torch.Tensor, div: int) -> torch.Tensor:
    """round(x / div) with ties-to-even on int64 — matches np.round semantics
    so scaled-path rounding agrees with the host kernels."""
    q = _fdiv(x, div)
    r = x - q * div
    r2 = 2 * r
    up = (r2 > div) | ((r2 == div) & (torch.remainder(q, 2) != 0))
    return q + up.to(torch.int64)


def rescale_down(c: DeviceCol, new_scale: int) -> DeviceCol:
    """Reduce a scaled column's scale (rounding half-to-even)."""
    assert c.scale is not None and new_scale <= c.scale
    if new_scale == c.scale:
        return c
    div = 10 ** (c.scale - new_scale)
    data = _round_half_even_div(c.data, div)
    rng = None
    if c.range is not None:
        lo, span = c.range
        rng = bucket_range(int(lo) // div - 1, (int(lo) + int(span)) // div + 1)
    # per-row rounding adds up to 0.5 ulp each: the subset-sum bound would
    # need the row count to stay sound, so drop it
    return replace(c, data=data, range=rng, scale=new_scale, ssum=None)


def rescale_up(c: DeviceCol, new_scale: int) -> DeviceCol:
    """Raise a scaled column's scale exactly (int64 multiply). Caller must
    have verified headroom via ``abs_bound``."""
    assert c.scale is not None and new_scale >= c.scale
    if new_scale == c.scale:
        return c
    mul = 10 ** (new_scale - c.scale)
    rng = None
    if c.range is not None:
        lo, span = c.range
        rng = bucket_range(int(lo) * mul, (int(lo) + int(span)) * mul)
    return replace(c, data=c.data * mul, range=rng, scale=new_scale,
                   ssum=None if c.ssum is None else c.ssum * mul)


def convert_repr(c: DeviceCol, to: DataType) -> DeviceCol:
    """Scale-aware dtype conversion — shared by Cast evaluation and projection
    output coercion (torch_engine._coerce_dev)."""
    if c.dtype is to or c.is_string:
        return c if c.dtype is to else replace(c, dtype=to)
    if c.scale is not None:
        if to.is_floating:
            return replace(c, dtype=to)  # representation unchanged
        if to.is_integer:
            # SQL float->int cast truncates toward zero
            q = torch.div(c.data, 10**c.scale, rounding_mode="trunc")
            rng = None
            rp = _range_pair(c)
            if rp is not None:
                d = 10**c.scale
                rng = bucket_range(rp[0] // d - 1, rp[1] // d + 1)
            return DeviceCol(to, q, c.null, range=rng)
        return DeviceCol(to, descale_f32(c).to(tdtype(to.to_numpy())), c.null)
    if NATIVE_DTYPES and to.is_floating:
        if c.dtype.is_integer or c.dtype is DataType.BOOL:
            # int -> float becomes a scale-0 decimal: stays exact
            return DeviceCol(to, c.data.to(torch.int64), c.null,
                             range=c.range, scale=0)
        if c.dtype.is_floating:
            return replace(c, dtype=to)  # keep the data width
    return DeviceCol(
        to, c.data.to(tdtype(to.to_numpy())), c.null,
        range=c.range if (c.dtype.is_integer and to.is_integer) else None,
    )


def as_scaled(c: DeviceCol) -> Optional[DeviceCol]:
    """View a column as scaled-int64: scaled columns as-is; integer/bool
    columns as scale 0. None for genuinely-float (unscaled) columns."""
    if c.scale is not None:
        return c
    if c.dtype in (DataType.INT32, DataType.INT64, DataType.BOOL):
        return replace(c, data=c.data.to(torch.int64), scale=0)
    return None


def align_scales(a: DeviceCol, b: DeviceCol) -> Optional[tuple[DeviceCol, DeviceCol, int]]:
    """Bring two scaled-like columns to a common scale with exact up-scaling.
    None when up-scaling cannot be proven int64-safe."""
    s = max(a.scale, b.scale)
    out = []
    for c in (a, b):
        if c.scale < s:
            bound = c.abs_bound if c.abs_bound is not None else (1 << 53)
            if bound * 10 ** (s - c.scale) >= _I64_SAFE:
                return None
            c = rescale_up(c, s)
        out.append(c)
    return out[0], out[1], s


# ---- host <-> device ---------------------------------------------------------------
def host_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """One host array to the device: through pinned memory with a
    non-blocking copy on CUDA (the caching host allocator keeps the pinned
    buffer alive until the copy has run); shared memory on the CPU."""
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True)
    t = torch.from_numpy(arr)
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def fetch_to_host(tensors: list, wait=contextlib.nullcontext) -> list:
    """Device tensors to numpy arrays in one batch: every copy is issued
    non-blocking and the stream is synchronized once, inside ``wait()``."""
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type == "cpu":
        return [t.numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    with wait():
        torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


def to_device(batch: ColumnBatch, device) -> DeviceBatch:
    """A host ColumnBatch on ``device``, in the encode_host_batch layout."""
    enc = encode_host_batch(batch)
    return device_batch_from_encoded(enc, [host_to_device(a, device) for a in enc.arrays])


# below this many payload bytes a straight fetch beats the extra round trip
# the compaction path spends on reading the valid-row count
_COMPACT_FETCH_BYTES = 4 * 1024 * 1024


def to_host(db: DeviceBatch, wait=contextlib.nullcontext) -> ColumnBatch:
    """The batch on the host. Each wait of the host on the device (the
    valid-row count of a compacted fetch, the fetch's synchronize) runs
    inside ``wait()``."""
    # one batched fetch, never per-array round trips; for wide padded
    # outputs, compact to the valid rows on the device first — a sparse
    # aggregate output can be n_pad slots with a handful valid
    arrays = [c.data for c in db.cols] + [c.null for c in db.cols if c.null is not None]
    payload = sum(a.numel() * a.element_size() for a in arrays)
    if payload > _COMPACT_FETCH_BYTES and db.n_pad:
        # host sync: nonzero sizes its output from the device count
        with wait():
            idx = torch.nonzero(db.row_valid).squeeze(1)
        if idx.shape[0] < db.n_pad:
            fetch = []
            for c in db.cols:
                fetch.append(c.data[idx])
                if c.null is not None:
                    fetch.append(c.null[idx])
            fetched = iter(fetch_to_host(fetch, wait))
            cols = []
            for f, c in zip(db.schema, db.cols):
                data = next(fetched)
                null = next(fetched) if c.null is not None else None
                cols.append(_host_col(f, c, data, null))
            return ColumnBatch(db.schema, cols)

    fetch = [db.row_valid]
    for c in db.cols:
        fetch.append(c.data)
        if c.null is not None:
            fetch.append(c.null)
    fetched = iter(fetch_to_host(fetch, wait))
    valid = next(fetched)
    cols = []
    for f, c in zip(db.schema, db.cols):
        data = next(fetched)[valid]
        null = next(fetched)[valid] if c.null is not None else None
        cols.append(_host_col(f, c, data, null))
    return ColumnBatch(db.schema, cols)


def _host_col(f, c: DeviceCol, data: np.ndarray, null: Optional[np.ndarray]) -> Column:
    import pyarrow as pa

    if c.is_string:
        vals = (
            np.where(null, None, c.dictionary[np.where(null, 0, data)])
            if null is not None
            else c.dictionary[data]
        )
        return Column(DataType.STRING, pa.array(vals.tolist(), type=pa.string()),
                      dict_id=c.dict_id)
    data = np.asarray(data)
    if c.scale is not None:
        # descale on the host (f64 is free here): exact recovery for sniffed
        # values, correctly-rounded nearest-f64 for computed products/sums
        data = data.astype(np.float64) / 10.0**c.scale
    return Column(
        f.dtype,
        data.astype(f.dtype.to_numpy(), copy=False),
        None if null is None else ~np.asarray(null),
    )


def sorted_dictionary_encode(arr) -> tuple[np.ndarray, np.ndarray]:
    """(sorted dictionary as object array, int32 codes) for a pyarrow string
    array, via pyarrow's C++ dictionary encoder. The dictionary is SORTED so
    code order == lexicographic order (string comparisons on the device work
    directly on codes)."""
    import pyarrow.compute as pc

    enc = pc.dictionary_encode(arr)
    dict_vals = np.asarray(enc.dictionary).astype(object)
    idx = np.asarray(enc.indices)
    if len(dict_vals) == 0:
        return dict_vals, np.zeros(len(arr), np.int32)
    order = np.argsort(dict_vals, kind="stable")
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return dict_vals[order], rank[idx]


def sorted_unique(arr) -> np.ndarray:
    """Sorted unique values of a pyarrow string array as an object array:
    the dictionary of ``sorted_dictionary_encode`` without the codes."""
    import pyarrow.compute as pc

    return np.sort(np.asarray(pc.unique(arr)).astype(object), kind="stable")


def _codes_in_dictionary(
    arr, dictionary: np.ndarray, strict: bool = False,
    dict_id: Optional[str] = None,
) -> Optional[np.ndarray]:
    """int32 codes of a pyarrow string array against an externally-agreed
    sorted dictionary. With ``strict``, a value outside the dictionary
    returns None (the caller falls back to per-batch encoding)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    value_set = None
    if dict_id:
        from ballista_tpu_torch.ops.batch import _pa_dictionary

        value_set = _pa_dictionary(dict_id)
    if value_set is None or len(value_set) != len(dictionary):
        value_set = pa.array(dictionary, type=pa.string())
    got = pc.index_in(arr, value_set=value_set)
    if strict and got.null_count:
        return None
    return np.asarray(got.fill_null(0)).astype(np.int32)


# ---- host encoding for a device stage ---------------------------------------------
@dataclass
class EncodedBatch:
    """A ColumnBatch split into (flat numpy arrays, static metadata): the
    arrays become the stage's device tensors, the metadata (dtypes,
    dictionaries, scales, ranges) drives the stage's trace-time decisions."""

    schema: Schema
    n_rows: int
    n_pad: int
    arrays: list[np.ndarray]  # per col: data [+ null]; final entry: row_valid
    # per col: (dtype, has_null, dictionary, decimal_scale) — scale is not
    # None iff the data array is scaled int64 (native-dtype policy)
    col_meta: list[tuple[DataType, bool, Optional[np.ndarray], Optional[int]]]
    int_ranges: Optional[list] = None  # per col: (lo, span) or None (see DeviceCol.range)
    ssums: Optional[list] = None  # per col: subset-sum bound or None (DeviceCol.ssum)
    dict_ids: Optional[list] = None  # per col: shared dict_id or None

    def dict_id_of(self, i: int) -> Optional[str]:
        return self.dict_ids[i] if self.dict_ids else None


def stand_ins(enc: EncodedBatch) -> bool:
    """Whether the encoding's arrays are storage-free stand-ins."""
    return bool(enc.arrays) and isinstance(enc.arrays[-1], torch.Tensor)


def with_stand_ins(enc: EncodedBatch) -> EncodedBatch:
    """The encoding with its arrays (numpy or tensors) replaced by ``meta``
    tensors of the same shapes and dtypes: its metadata alone."""
    return replace(enc, arrays=[
        torch.empty(a.shape, device="meta", dtype=a.dtype if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.empty(0, a.dtype)).dtype) for a in enc.arrays])


def shard_pad(n: int, n_dev: int) -> int:
    """The pad of ``n`` rows in ``n_dev`` equal power-of-two shards."""
    return bucket_size(max(1, -(-n // n_dev))) * n_dev


def encode_host_batch(batch: ColumnBatch, pad: Optional[int] = None,
                      dictionaries: Optional[list] = None,
                      force_null: Optional[list] = None,
                      force_scales: Optional[list] = None) -> EncodedBatch:
    """``dictionaries``, ``force_null``, ``force_scales`` and ``pad`` pin the
    layout from outside: the processes of a mesh group encode their own rows
    with one agreed layout (``parallel.multihost``), so that every process
    makes the same data-dependent decisions in the program. Per column:
    ``dictionaries[i]`` a sorted string dictionary to code against;
    ``force_null[i]`` a null array even without nulls; ``force_scales[i]``
    an int for scaled int64 at that scale, ``"f32"`` for a downcast, None
    for the natural dtype (no decimal sniff, no downcast). Without them the
    layout follows the batch's own data."""
    n = batch.num_rows
    if pad is None:
        pad = bucket_size(n)
    assert pad >= n, (pad, n)
    arrays: list[np.ndarray] = []
    col_meta = []
    int_ranges: list = []
    ssums: list = []
    dict_ids: list = []
    for i, (f, c) in enumerate(zip(batch.schema, batch.columns)):
        forced = force_null is not None and force_null[i]
        ssums.append(None)
        dict_ids.append(None)
        int_ranges.append(
            _int_range(c) if f.dtype in (DataType.INT32, DataType.INT64,
                                         DataType.DATE32, DataType.BOOL) else None
        )
        if f.dtype is DataType.STRING:
            null = np.asarray(c.data.is_null()) if c.data.null_count else None
            filled = c.data.fill_null("")
            inv = None
            pinned = dictionaries is not None and dictionaries[i] is not None
            if pinned:
                dictionary = np.asarray(dictionaries[i], dtype=object)
                inv = _codes_in_dictionary(filled, dictionary)
            elif getattr(c, "dict_id", None):
                # catalog-shared dictionary: stable codes across partitions
                from ballista_tpu_torch.engine.dictionaries import REGISTRY

                shared = REGISTRY.get(c.dict_id)
                if shared is not None:
                    inv = _codes_in_dictionary(filled, shared, strict=True,
                                               dict_id=c.dict_id)
                    if inv is not None:
                        dictionary = shared
                        dict_ids[-1] = c.dict_id
            if inv is None:
                dictionary, inv = sorted_dictionary_encode(filled)
            if not pinned and n > 0:
                # a pinned encode is neither shared nor per batch
                from ballista_tpu_torch.engine.dictionaries import REGISTRY

                REGISTRY.note_encode(dict_ids[-1] is not None)
            arrays.append(_padded(inv.astype(np.int32), pad))
            has_null = null is not None or forced
            if has_null:
                arrays.append(_padded(null if null is not None else np.zeros(n, bool), pad))
            col_meta.append((f.dtype, has_null, dictionary.astype(object), None))
        else:
            vals = np.asarray(c.data)
            scale = None
            if force_scales is not None:
                fs = force_scales[i]
                if isinstance(fs, int):
                    zeroed = vals if c.valid is None else np.where(c.valid, vals, 0.0)
                    vals = np.round(zeroed * 10.0**fs).astype(np.int64)
                    scale = fs
                    lo = int(vals.min()) if n else 0
                    hi = int(vals.max()) if n else 0
                    int_ranges[-1] = bucket_range(lo, hi)
                    ssums[-1] = _pow2_at_least(abs_sum_bound(vals))
                elif fs == "f32":
                    vals = vals.astype(np.float32)
            elif NATIVE_DTYPES and f.dtype is DataType.FLOAT64:
                # sniff failure keeps f64 unless f32 is LOSSLESS: silently
                # downcasting genuinely-f64 data would change group identity
                sniffed = sniff_decimal(vals, c.valid)
                if sniffed is not None:
                    scale, vals, (lo, hi) = sniffed
                    int_ranges[-1] = bucket_range(lo, hi)
                    ssums[-1] = _pow2_at_least(abs_sum_bound(vals))
                else:
                    f32 = f32_exact(vals, c.valid)
                    if f32 is not None:
                        vals = f32
            arrays.append(_padded(vals, pad))
            has_null = (c.valid is not None and not c.valid.all()) or forced
            if has_null:
                arrays.append(_padded(~c.valid if c.valid is not None else np.zeros(n, bool),
                                      pad))
            col_meta.append((f.dtype, has_null, None, scale))
    arrays.append(np.arange(pad) < n)
    return EncodedBatch(batch.schema, n, pad, arrays, col_meta, int_ranges, ssums,
                        dict_ids if any(dict_ids) else None)


def encoded_from_reference(arrays, col_meta, n_rows: int, **attrs) -> EncodedBatch:
    """The port's EncodedBatch from the numpy arrays and metadata of a JAX
    package ``EncodedBatch``, so one encoding can feed both packages. Enum
    and schema objects of the other package are converted by value (duck
    typed: this module imports nothing of it). ``attrs`` takes ``schema``,
    ``int_ranges``, ``ssums`` and ``dict_ids``."""
    meta = [(DataType(dt.value), bool(has_null), dictionary, scale)
            for dt, has_null, dictionary, scale in col_meta]
    schema = attrs.pop("schema", None)
    if schema is not None and not isinstance(schema, Schema):
        schema = Schema(tuple(Field(f.name, DataType(f.dtype.value), f.nullable)
                              for f in schema))
    arrays = list(arrays)
    return EncodedBatch(schema, n_rows, len(arrays[-1]), arrays, meta, **attrs)


def encode_device_batches(parts: list, n_dev: int, wait=contextlib.nullcontext,
                          max_rows: int = 0):
    """What ``encode_host_batch`` gives for ``parts`` (stage outputs on one
    device) fetched to the host and concatenated, padded to ``n_dev`` equal
    power-of-two shards, made on the device: the valid rows compacted in
    part order, each decimal at the least scale holding all its values
    exactly (the host's ``sniff_decimal``), integer ranges and subset-sum
    bounds from exact reductions, shared-dictionary codes kept. Every
    statistic and each part's row count come back in one wait (``wait()``).

    Returns (row counts, EncodedBatch, its arrays on the device); the
    encoding's own arrays are storage-free ``meta`` stand-ins. Both are None
    for zero rows, or past ``max_rows`` when it is set. Returns None where
    the host's encoding could differ: a float column not held as a scaled
    decimal or that needs a scale past MAX_DECIMAL_SCALE, a scaled value (at
    any part's scale) at or past 2^51 or a subset sum at or past 2^53 (below
    them the host's scale search and float sum are exact), a string column
    without a registered shared dictionary or with NULLs."""
    from ballista_tpu_torch.engine.dictionaries import REGISTRY

    schema = parts[0].schema
    kinds = [_device_encode_kind(f.dtype, [p.cols[i] for p in parts], REGISTRY)
             for i, f in enumerate(schema)]
    if None in kinds:
        return None
    if sum(p.n_pad for p in parts) == 0:
        return [0] * len(parts), None, None
    # the parts' rows after one invalid row; cum[j]: the valid rows of the
    # first j rows of the parts
    flags = torch.cat([torch.zeros(1, dtype=torch.bool, device=parts[0].device)]
                      + [p.row_valid for p in parts])
    cum = torch.cumsum(flags, 0)
    rv = flags[1:]
    # the statistics, stacked for the one wait: int64 scalars in ``ints``
    # (first the valid rows up to each part's end), the decimals' float64
    # sums of |value| in ``sums``
    ints = [cum[int(e)] for e in np.cumsum([p.n_pad for p in parts])]
    sums: list = []
    cols = []
    for i, (f, kind) in enumerate(zip(schema, kinds)):
        pcols = [p.cols[i] for p in parts]
        col = {"kind": kind, "null": None, "dictionary": pcols[0].dictionary,
               "dict_id": pcols[0].dict_id, "scale": None}
        if kind == "dec":
            # every part at the largest scale: a part at a lower one is
            # multiplied up, its exact range checked after the wait
            col["scale"] = max(c.scale for c in pcols)
            col["raised"] = []
            data = []
            for c, p in zip(pcols, parts):
                d = col["scale"] - c.scale
                if d:
                    part_live = p.row_valid if c.null is None else p.row_valid & ~c.null
                    col["raised"].append((d, len(ints)))
                    ints += [torch.where(part_live, c.data, _I64_MAX).min(),
                             torch.where(part_live, c.data, _I64_MIN).max()]
                data.append(c.data * 10**d if d else c.data)
            col["data"] = torch.cat(data)
        else:
            want = torch.int32 if kind == "str" else tdtype(f.dtype.to_numpy())
            col["data"] = torch.cat([c.data.to(want) for c in pcols])
        live = rv
        if any(c.null is not None for c in pcols):
            col["null"] = torch.cat([c.null if c.null is not None
                                     else torch.zeros_like(p.row_valid)
                                     for c, p in zip(pcols, parts)])
            col["null_at"] = len(ints)
            ints.append((rv & col["null"]).any())
            live = rv & ~col["null"]
        if kind != "str":
            x = col["data"].to(torch.int64)
            col["lo_at"] = len(ints)
            ints += [torch.where(live, x, _I64_MAX).min(), torch.where(live, x, _I64_MIN).max()]
        if kind == "dec":
            col["sum_at"] = len(sums)
            sums.append(torch.where(live, x.abs(), 0).to(torch.float64).sum())
            # flags: some value is not a multiple of 10^j, j = 1..scale
            col["nd_at"] = len(ints)
            ints += [(live & (torch.remainder(x, 10**j) != 0)).any()
                     for j in range(1, col["scale"] + 1)]
        cols.append(col)
    stacked = [torch.stack([t.to(torch.int64) for t in ints])]
    if sums:
        stacked.append(torch.stack(sums))
    got = fetch_to_host(stacked, wait)
    got_i = [int(v) for v in got[0]]
    got_s = [float(v) for v in got[1]] if sums else []
    counts = np.diff(got_i[:len(parts)], prepend=0).tolist()
    n = got_i[len(parts) - 1]
    if n == 0 or (max_rows and n > max_rows):
        return counts, None, None

    pad = shard_pad(n, n_dev)
    # each valid row's slot in the output; every other row lands on slot pad
    dest = torch.where(rv, cum[1:] - 1, pad)

    def compact(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(pad + 1, dtype=x.dtype, device=x.device)
        return out.index_copy_(0, dest, x)[:pad]

    arrays: list = []
    col_meta, int_ranges, ssums, dict_ids = [], [], [], []
    for f, col in zip(schema, cols):
        has_null = "null_at" in col and got_i[col["null_at"]] != 0
        data = col["data"]
        rng = ssum = scale = None
        dictionary = did = None
        if col["kind"] == "str":
            if has_null:
                return None  # the host codes a NULL as "", perhaps outside the dictionary
            dictionary, did = np.asarray(col["dictionary"], dtype=object), col["dict_id"]
        else:
            lo, hi = got_i[col["lo_at"]], got_i[col["lo_at"] + 1]
            if lo > hi:  # no valid non-null value
                lo = hi = 0
            if col["kind"] == "int":
                rng = bucket_range(lo, hi)
            else:
                nd = got_i[col["nd_at"]:col["nd_at"] + col["scale"]]
                k = nd.index(1) if 1 in nd else col["scale"]
                scale = col["scale"] - k
                if (scale > MAX_DECIMAL_SCALE or not -_EXACT_SCALED < lo <= hi < _EXACT_SCALED
                        or got_s[col["sum_at"]] >= _EXACT_F64
                        or not all(_raised_exactly(got_i[at], got_i[at + 1], d)
                                   for d, at in col["raised"])):
                    return None
                div = 10**k
                if k:
                    data = _fdiv(data, div)
                if col["null"] is not None:
                    data = torch.where(col["null"], 0, data)
                rng = bucket_range(lo // div, hi // div)
                ssum = _pow2_at_least(_sum_margin(float(int(got_s[col["sum_at"]]) // div)))
        arrays.append(compact(data))
        if has_null:
            arrays.append(compact(col["null"]))
        col_meta.append((f.dtype, has_null, dictionary, scale))
        int_ranges.append(rng)
        ssums.append(ssum)
        dict_ids.append(did)
    arrays.append(torch.arange(pad, device=rv.device) < n)
    enc = with_stand_ins(EncodedBatch(schema, n, pad, arrays, col_meta, int_ranges, ssums,
                                      dict_ids if any(dict_ids) else None))
    return counts, enc, arrays


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
# scaled values below this round-trip the host's descale and scale search
# exactly (two bits of margin under float64's 2^53)
_EXACT_SCALED = 1 << 51
# integer sums below this are exact in float64, in any order of addition
_EXACT_F64 = float(1 << 53)


def _raised_exactly(lo: int, hi: int, d: int) -> bool:
    """Whether a part's scaled values in [lo, hi] (lo > hi: none), times
    10^d, stay below _EXACT_SCALED in magnitude: the multiply wrapped none."""
    return lo > hi or -_EXACT_SCALED < lo * 10**d <= hi * 10**d < _EXACT_SCALED


def _device_encode_kind(dtype: DataType, cols: list, registry) -> Optional[str]:
    """How ``encode_device_batches`` encodes a column given as ``cols`` (one
    per part): "str" (codes of a registered shared dictionary), "int", "dec"
    (a scaled decimal), or None where it cannot match the host."""
    c0 = cols[0]
    if dtype is DataType.STRING:
        shared = registry.get(c0.dict_id)
        if shared is not None and all(
                c.dict_id == c0.dict_id
                and (c.dictionary is shared or np.array_equal(c.dictionary, shared))
                for c in cols):
            return "str"
        return None
    if any(c.is_string for c in cols):
        return None
    if (dtype in (DataType.INT32, DataType.INT64, DataType.DATE32, DataType.BOOL)
            and all(c.scale is None for c in cols)):
        return "int"
    if (dtype is DataType.FLOAT64 and NATIVE_DTYPES
            and all(c.scale is not None and 10**c.scale <= _I64_MAX for c in cols)):
        return "dec"
    return None


def _pow2_at_least(v: int) -> int:
    """Round a content-derived bound up to a power of two."""
    return 1 << max(0, int(v).bit_length())


def abs_sum_bound(scaled: np.ndarray) -> int:
    """Sound UPPER bound on sum(|scaled|): float64 pairwise summation of
    <2^53 elements has ~1e-13 relative error, so a 0.1% upward margin is
    safely conservative (an int64 sum could wrap)."""
    return _sum_margin(float(np.abs(scaled.astype(np.float64)).sum()))


def _sum_margin(s: float) -> int:
    return int(s * 1.001) + 1


def decode_encoded_batch(enc: EncodedBatch) -> ColumnBatch:
    """Host ColumnBatch back out of an EncodedBatch (inverse of
    ``encode_host_batch``)."""
    import pyarrow as pa

    valid = enc.arrays[-1].astype(bool)
    cols = []
    i = 0
    for ci, ((dt, has_null, dictionary, scale), f) in enumerate(
        zip(enc.col_meta, enc.schema)
    ):
        data = enc.arrays[i][valid]
        i += 1
        null = None
        if has_null:
            null = enc.arrays[i][valid].astype(bool)
            i += 1
        if dt is DataType.STRING:
            vals = (dictionary[np.clip(data, 0, max(0, len(dictionary) - 1))]
                    if len(dictionary) else np.full(len(data), "", object))
            if null is not None and null.any():
                vals = np.where(null, None, vals)
            cols.append(Column(DataType.STRING, pa.array(vals.tolist(), type=pa.string()),
                               dict_id=enc.dict_id_of(ci)))
        else:
            if scale is not None:
                data = data.astype(np.float64) / 10.0**scale
            cols.append(
                Column(dt, data.astype(dt.to_numpy(), copy=False),
                       None if null is None or not null.any() else ~null)
            )
    return ColumnBatch(enc.schema, cols)


def bucket_range(lo: int, hi: int) -> tuple[int, int]:
    """Bucketed static (lo, span) covering [lo, hi]: span a power of two, lo
    floored to a span multiple once, then the span only extends (re-aligning
    after each doubling never terminates for ranges straddling zero)."""
    span = 1
    while span < hi - lo + 1:
        span <<= 1
    lo_b = (lo // span) * span
    while lo_b + span <= hi:
        span <<= 1
    return (lo_b, span)


def raw_int_range(c: Column) -> Optional[tuple[int, int]]:
    """Exact (lo, hi) over non-null values, or None for no data."""
    data = np.asarray(c.data)
    if data.size == 0:
        return None
    if c.valid is not None:
        if not c.valid.any():
            return None
        data = data[c.valid]
    return (int(data.min()), int(data.max()))


def _int_range(c: Column) -> Optional[tuple[int, int]]:
    raw = raw_int_range(c)
    if raw is None:
        return (0, 1)
    return bucket_range(*raw)


def device_batch_from_encoded(enc: EncodedBatch, tensors: list) -> DeviceBatch:
    """A DeviceBatch from an encoding's device tensors + static metadata."""
    cols = []
    i = 0
    ranges = enc.int_ranges or [None] * len(enc.col_meta)
    ssums = enc.ssums or [None] * len(enc.col_meta)
    dids = enc.dict_ids or [None] * len(enc.col_meta)
    for (dt, has_null, dictionary, scale), rng, sb, did in zip(
        enc.col_meta, ranges, ssums, dids
    ):
        data = tensors[i]
        i += 1
        null = None
        if has_null:
            null = tensors[i]
            i += 1
        cols.append(DeviceCol(dt, data, null, dictionary, rng, scale, sb, did))
    return DeviceBatch(enc.schema, cols, tensors[i], enc.n_rows)


def flatten_device_batch(db: DeviceBatch):
    """Inverse direction for stage outputs: (flat tensors, rebuild-meta)."""
    arrays = []
    meta = []
    for c in db.cols:
        arrays.append(c.data)
        if c.null is not None:
            arrays.append(c.null)
        meta.append((c.dtype, c.null is not None, c.dictionary, c.scale, c.dict_id))
    arrays.append(db.row_valid)
    return arrays, (db.schema, meta)


def device_batch_from_outputs(out_meta, arrays, n_rows: int) -> DeviceBatch:
    schema, meta = out_meta
    cols = []
    i = 0
    for dt, has_null, dictionary, scale, did in meta:
        data = arrays[i]
        i += 1
        null = None
        if has_null:
            null = arrays[i]
            i += 1
        cols.append(DeviceCol(dt, data, null, dictionary, scale=scale, dict_id=did))
    return DeviceBatch(schema, cols, arrays[i], n_rows)


def _padded(a: np.ndarray, pad: int) -> np.ndarray:
    if len(a) == pad:
        return a
    out = np.zeros(pad, dtype=a.dtype)
    out[: len(a)] = a
    return out


# ---- device expression evaluation --------------------------------------------------
_CMP = {"=": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}


def _arith(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One arithmetic op (eager torch evaluates only what it is asked for,
    so this never builds the dict of every op that the traced JAX code
    could afford). ``%`` is floor mod, as ``jnp``'s is."""
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return torch.remainder(a, b)
    raise ExecutionError(f"device arithmetic op {op!r}")


def _zeros(n: int, dtype, device) -> torch.Tensor:
    return torch.zeros(n, dtype=dtype, device=device)


def _ones_bool(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


def eval_dev(expr: Expr, db: DeviceBatch) -> DeviceCol:
    dev = db.device
    if isinstance(expr, Alias):
        return eval_dev(expr.expr, db)
    if isinstance(expr, Col):
        return db.col(expr.col)
    if isinstance(expr, Lit):
        if expr.dtype is DataType.STRING:
            # constant string column: single-entry dictionary
            return DeviceCol(DataType.STRING, _zeros(db.n_pad, torch.int32, dev), None,
                             np.array([expr.value], dtype=object))
        t_dt = tdtype(expr.dtype.to_numpy())
        if NATIVE_DTYPES and expr.dtype.is_floating:
            if expr.value is None:
                return DeviceCol(expr.dtype, _zeros(db.n_pad, torch.int64, dev),
                                 _ones_bool(db.n_pad, dev), range=(0, 1), scale=0)
            sc = lit_decimal_scale(float(expr.value))
            if sc is not None:
                iv = int(round(float(expr.value) * 10**sc))
                return DeviceCol(expr.dtype,
                                 torch.full((db.n_pad,), iv, dtype=torch.int64, device=dev),
                                 range=bucket_range(iv, iv), scale=sc)
            # non-decimal literal (NaN / >12 digits): natural float width
            return DeviceCol(expr.dtype,
                             torch.full((db.n_pad,), expr.value, dtype=t_dt, device=dev))
        if expr.value is None:
            # a NULL literal is an ALL-NULL column (CASE ... ELSE NULL)
            return DeviceCol(expr.dtype, _zeros(db.n_pad, t_dt, dev),
                             _ones_bool(db.n_pad, dev))
        rng = None
        if expr.dtype in (DataType.INT32, DataType.INT64, DataType.BOOL):
            rng = bucket_range(int(expr.value), int(expr.value))
        return DeviceCol(expr.dtype,
                         torch.full((db.n_pad,), expr.value, dtype=t_dt, device=dev),
                         range=rng)
    if isinstance(expr, BinaryOp):
        return _eval_binary_dev(expr, db)
    if isinstance(expr, Not):
        c = eval_dev(expr.expr, db)
        return DeviceCol(DataType.BOOL, ~c.data.to(torch.bool), c.null)
    if isinstance(expr, IsNull):
        c = eval_dev(expr.expr, db)
        isnull = c.null if c.null is not None else _zeros(db.n_pad, torch.bool, dev)
        return DeviceCol(DataType.BOOL, ~isnull if expr.negated else isnull)
    if isinstance(expr, (Like, InList)):
        vals, null = eval_dev_predicate(expr, db)
        return DeviceCol(DataType.BOOL, vals, null)
    if isinstance(expr, Case):
        return _eval_case_dev(expr, db)
    if isinstance(expr, Cast):
        c = eval_dev(expr.expr, db)
        if c.dtype is expr.to:
            return c
        if c.is_string or expr.to is DataType.STRING:
            raise ExecutionError("device cast between strings unsupported")
        return convert_repr(c, expr.to)
    if isinstance(expr, Func):
        return _eval_func_dev(expr, db)
    raise ExecutionError(f"device eval unsupported for {expr!r}")


def _lut_gather(lut: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """Gather a host lookup table by device codes."""
    return torch.as_tensor(lut).to(codes.device)[codes]


def _string_lut(c: DeviceCol, fn) -> torch.Tensor:
    """Evaluate a host predicate over the dictionary, gather by code."""
    if len(c.dictionary) == 0:  # empty partition: no codes to look up
        return _zeros(c.data.shape[0], torch.bool, c.data.device)
    lut = np.asarray(fn(c.dictionary), dtype=bool)
    return _lut_gather(lut, c.data)


def eval_dev_predicate(expr: Expr, db: DeviceBatch) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (bool values, null mask) for a predicate expression."""
    if isinstance(expr, Like):
        c = eval_dev(expr.expr, db)
        if not c.is_string:
            raise ExecutionError("LIKE over non-string")
        import pyarrow as pa
        import pyarrow.compute as pc

        def match(d):
            return np.asarray(pc.match_like(pa.array(d.tolist(), pa.string()), expr.pattern))

        got = _string_lut(c, match)
        if expr.negated:
            got = ~got
        if c.null is not None:
            got = got & ~c.null
        return got, None
    if isinstance(expr, InList):
        c = eval_dev(expr.expr, db)
        vals = [v.value for v in expr.values]
        if c.is_string:
            got = _string_lut(c, lambda d: np.isin(d.astype(object), np.array(vals, object)))
        elif c.scale is not None:
            got = _zeros(db.n_pad, torch.bool, db.device)
            for v in vals:
                sc = lit_decimal_scale(float(v), max_scale=c.scale)
                if sc is None:
                    continue  # not representable at the column's scale: never equal
                got = got | (c.data == int(round(float(v) * 10**c.scale)))
        else:
            got = _zeros(db.n_pad, torch.bool, db.device)
            for v in vals:
                got = got | (c.data == v)
        if expr.negated:
            got = ~got
        if c.null is not None:
            got = got & ~c.null
        return got, None
    c = eval_dev(expr, db)
    return c.data.to(torch.bool), c.null


def _cmp_strings(op: str, l: DeviceCol, r: DeviceCol) -> torch.Tensor:
    if isinstance(r.dictionary, np.ndarray) and len(r.dictionary) == 1:
        target = r.dictionary[0]

        def fn(d):
            return {
                "=": d == target, "!=": d != target, "<": d < target,
                "<=": d <= target, ">": d > target, ">=": d >= target,
            }[op]

        return _string_lut(l, fn)
    # general string-vs-string compare: map both into one dictionary order
    merged = np.unique(np.concatenate([l.dictionary, r.dictionary]).astype(object))
    lmap = _lut_gather(np.searchsorted(merged, l.dictionary.astype(object)).astype(np.int32), l.data)
    rmap = _lut_gather(np.searchsorted(merged, r.dictionary.astype(object)).astype(np.int32), r.data)
    return _CMP[op](lmap, rmap)


def _eval_binary_dev(expr: BinaryOp, db: DeviceBatch) -> DeviceCol:
    op = expr.op
    if op in ("and", "or"):
        lv, ln = eval_dev_predicate(expr.left, db)
        rv, rn = eval_dev_predicate(expr.right, db)
        out = lv & rv if op == "and" else lv | rv
        null = None
        if ln is not None or rn is not None:
            lnull = ln if ln is not None else torch.zeros_like(lv)
            rnull = rn if rn is not None else torch.zeros_like(rv)
            if op == "and":
                known = (~lv & ~lnull) | (~rv & ~rnull)  # known false
            else:
                known = (lv & ~lnull) | (rv & ~rnull)    # known true
            null = (lnull | rnull) & ~known
        return DeviceCol(DataType.BOOL, out, null)

    l = eval_dev(expr.left, db)
    r = eval_dev(expr.right, db)
    null = _merge_null(l.null, r.null)
    if l.is_string or r.is_string:
        if op not in _CMP:
            raise ExecutionError(f"string op {op} on device")
        return DeviceCol(DataType.BOOL, _cmp_strings(op, l, r), null)
    a, b = l.data, r.data
    if l.scale is not None or r.scale is not None:
        got = _binary_scaled_dev(op, l, r, null, expr, db)
        if got is not None:
            return got
        # no exact int64 form: float value arithmetic at the widest unscaled
        # operand's width (f64 keeps f64; pure-decimal division runs f32)
        ft = _float_width((l, r))
        a = _as_float(l, ft)
        b = _as_float(r, ft)
    if op in _CMP:
        return DeviceCol(DataType.BOOL, _CMP[op](a, b), null)
    dt = expr.data_type(db.schema)
    if NATIVE_DTYPES and dt.is_floating:
        # plain-int / plain-int division keeps f64: id-scale quotients need
        # exactness beyond f32's 24-bit mantissa
        int_div = (
            op == "/"
            and l.scale is None and r.scale is None
            and l.dtype.is_integer and r.dtype.is_integer
        )
        ft = (
            torch.float64
            if (a.dtype == torch.float64 or b.dtype == torch.float64 or int_div)
            else torch.float32
        )
        return DeviceCol(dt, _arith(op, a.to(ft), b.to(ft)), null)
    if op == "/":
        out = a.to(torch.float64) / b
    else:
        out = _arith(op, a, b)
    return DeviceCol(dt, out.to(tdtype(dt.to_numpy())), null)


def _float_width(cols) -> torch.dtype:
    """f64 when any unscaled operand is f64 (host-parity precision), else the
    native f32."""
    for c in cols:
        if c.scale is None and c.data.dtype == torch.float64:
            return torch.float64
    return torch.float32


def _as_float(c: DeviceCol, ft: torch.dtype) -> torch.Tensor:
    data = c.data.to(ft)
    if c.scale is not None:
        # the divisor is a tensor of the working width, as jnp's
        # ``ft(10.0**scale)`` is: CUDA divides by a Python scalar as a
        # multiply by its reciprocal, which can miss by an ulp
        return data / torch.full_like(data, 10.0**c.scale)
    return data


def _eb(c: DeviceCol) -> int:
    """Effective trace-time |value| bound in scaled units: the exact range
    when known, else 2^53 (the encode-time magnitude guarantee)."""
    b = c.abs_bound
    return b if b is not None else (1 << 53)


def _range_pair(c: DeviceCol) -> Optional[tuple[int, int]]:
    if c.range is None:
        return None
    lo, span = c.range
    return int(lo), int(lo) + int(span)


def _binary_scaled_dev(
    op: str, l: DeviceCol, r: DeviceCol, null, expr: BinaryOp, db: DeviceBatch
) -> Optional[DeviceCol]:
    """Exact int64 arithmetic/comparison on scaled-decimal operands (ints are
    scale-0 decimals). None when no exact int64 form exists — the caller
    then falls back to float value arithmetic. Every scaled result carries a
    verified headroom range."""
    sl, sr = as_scaled(l), as_scaled(r)
    if sl is None or sr is None:
        return None
    if op in _CMP:
        al = align_scales(sl, sr)
        if al is None:
            return None
        return DeviceCol(DataType.BOOL, _CMP[op](al[0].data, al[1].data), null)
    dt = expr.data_type(db.schema)
    if op in ("+", "-"):
        al = align_scales(sl, sr)
        if al is None:
            return None
        x, y, s = al
        if _eb(x) + _eb(y) >= _I64_SAFE:
            return None
        data = x.data + y.data if op == "+" else x.data - y.data
        rng = None
        rx, ry = _range_pair(x), _range_pair(y)
        if rx is not None and ry is not None:
            if op == "+":
                rng = bucket_range(rx[0] + ry[0], rx[1] + ry[1])
            else:
                rng = bucket_range(rx[0] - ry[1], rx[1] - ry[0])
        return DeviceCol(dt, data, null, range=rng, scale=s)
    if op == "*":
        if _eb(sl) * _eb(sr) >= _I64_SAFE:
            return None
        rng = None
        rx, ry = _range_pair(sl), _range_pair(sr)
        if rx is not None and ry is not None:
            ps = [rx[0] * ry[0], rx[0] * ry[1], rx[1] * ry[0], rx[1] * ry[1]]
            rng = bucket_range(min(ps), max(ps))
        return DeviceCol(dt, sl.data * sr.data, null, range=rng,
                         scale=sl.scale + sr.scale)
    if op == "%":
        # exact int64 remainder only when the divisor is provably nonzero: a
        # zero divisor must yield NaN like the host f64 kernel
        rp = _range_pair(sr)
        if rp is None or (rp[0] <= 0 <= rp[1]):
            return None
        al = align_scales(sl, sr)
        if al is None:
            return None
        x, y, s = al
        # floor-mod, matching the host kernel's np.mod
        return DeviceCol(dt, torch.remainder(x.data, y.data), null, scale=s)
    return None  # "/" always descales (inexact by nature)


def _merge_null(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _pick_null(pick: torch.Tensor, v_null: Optional[torch.Tensor], null: torch.Tensor):
    """``where(pick, v_null or False, null)``."""
    if v_null is None:
        return null & ~pick
    return torch.where(pick, v_null, null)


def _eval_case_dev(expr: Case, db: DeviceBatch) -> DeviceCol:
    out_dtype = expr.data_type(db.schema)
    if out_dtype is DataType.STRING:
        return _eval_case_dev_string(expr, db)
    branch_vals = [eval_dev(v, db) for _, v in expr.branches]
    else_val = eval_dev(expr.else_, db) if expr.else_ is not None else None
    parts = branch_vals + ([else_val] if else_val is not None else [])

    # representation: exact scaled int64 when every part is scaled-like and
    # alignment headroom is provable; f32 for float outputs otherwise;
    # natural dtype for int CASEs
    out_scale: Optional[int] = None
    out_rng: Optional[tuple] = None
    if NATIVE_DTYPES and any(p.scale is not None for p in parts):
        scaled = [as_scaled(p) for p in parts]
        if all(p is not None for p in scaled):
            s = max(p.scale for p in scaled)
            if all(_eb(p) * 10 ** (s - p.scale) < _I64_SAFE for p in scaled):
                aligned = [rescale_up(p, s) for p in scaled]
                rps = [_range_pair(p) for p in aligned]
                if all(rp is not None for rp in rps):
                    out_rng = bucket_range(
                        min(rp[0] for rp in rps), max(rp[1] for rp in rps)
                    )
                out_scale = s
                it = iter(aligned)
                branch_vals = [next(it) for _ in branch_vals]
                else_val = next(it) if else_val is not None else None

    if out_scale is not None:
        t_dt = torch.int64
    elif NATIVE_DTYPES and out_dtype.is_floating:
        t_dt = _float_width(parts)
    else:
        t_dt = tdtype(out_dtype.to_numpy())

    def vdata_of(v: DeviceCol) -> torch.Tensor:
        if out_scale is None and v.scale is not None:
            return _as_float(v, t_dt)
        return v.data.to(t_dt)

    if else_val is not None:
        out = vdata_of(else_val)
        null = else_val.null
    else:
        out = _zeros(db.n_pad, t_dt, db.device)
        null = _ones_bool(db.n_pad, db.device)
    # null tracking engages when ANY source is nullable
    if null is None and any(v.null is not None for v in branch_vals):
        null = _zeros(db.n_pad, torch.bool, db.device)
    for (cond, _), v in zip(reversed(expr.branches), reversed(branch_vals)):
        cv, cn = eval_dev_predicate(cond, db)
        pick = cv if cn is None else (cv & ~cn)
        out = torch.where(pick, vdata_of(v), out)
        if null is not None:
            null = _pick_null(pick, v.null, null)
    return DeviceCol(out_dtype, out, null, range=out_rng, scale=out_scale)


def _eval_case_dev_string(expr: Case, db: DeviceBatch) -> DeviceCol:
    """String-producing CASE via a UNION dictionary: every branch value's
    dictionary is host metadata, so the sorted union and each branch's
    code-remap LUT are computed on the host and gathered on the device. A
    NULL-literal branch contributes nulls, no dictionary entries."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from ballista_tpu_torch.plan.expr import unalias

    def as_string_col(e) -> Optional[DeviceCol]:
        if isinstance(unalias(e), Lit) and unalias(e).value is None:
            return None  # NULL literal: pure null contribution
        v = eval_dev(e, db)
        if not v.is_string:
            raise DeviceUnsupported("CASE branches mix string and non-string")
        return v

    branch_vals = [as_string_col(v) for _, v in expr.branches]
    else_val = as_string_col(expr.else_) if expr.else_ is not None else None
    cols = [c for c in branch_vals + [else_val] if c is not None]
    dicts = [np.asarray(c.dictionary, dtype=object) for c in cols if len(c.dictionary)]
    if dicts:
        uniq = pc.unique(pa.array(np.concatenate(dicts), type=pa.string()))
        union = np.asarray(uniq.take(pc.array_sort_indices(uniq))).astype(object)
    else:
        union = np.array([], dtype=object)

    def remap(c: DeviceCol) -> torch.Tensor:
        if len(c.dictionary) == 0:
            return _zeros(db.n_pad, torch.int32, db.device)
        lut = _codes_in_dictionary(
            pa.array(np.asarray(c.dictionary, dtype=object), type=pa.string()), union
        )
        return _lut_gather(lut, c.data)

    if else_val is not None:
        out = remap(else_val)
        null = else_val.null
    else:
        out = _zeros(db.n_pad, torch.int32, db.device)
        null = _ones_bool(db.n_pad, db.device)
    if null is None and any(c is None or c.null is not None for c in branch_vals):
        null = _zeros(db.n_pad, torch.bool, db.device)
    for (cond, _), v in zip(reversed(expr.branches), reversed(branch_vals)):
        cv, cn = eval_dev_predicate(cond, db)
        pick = cv if cn is None else (cv & ~cn)
        if v is None:  # NULL-literal branch: only the null mask changes
            null = null | pick
            continue
        out = torch.where(pick, remap(v), out)
        if null is not None:
            null = _pick_null(pick, v.null, null)
    return DeviceCol(DataType.STRING, out, null, union)


# functions _eval_func_dev evaluates on the device (torch_engine._expr_ok)
DEVICE_FUNCS = frozenset((
    "year", "month", "day", "abs", "round", "substr", "length",
    "sqrt", "floor", "ceil", "power", "exp", "ln", "log10", "sign",
    "mod", "nullif", "greatest", "least", "upper", "lower", "trim",
    "ltrim", "rtrim", "replace", "concat", "concat_op",
    "starts_with", "strpos", "date_trunc",
))


def _eval_func_dev(expr: Func, db: DeviceBatch) -> DeviceCol:
    dev = db.device
    if expr.fn in ("year", "month"):
        c = eval_dev(expr.args[0], db)
        y, m, _d, _doy, _days = _civil_parts(c.data)
        out = y if expr.fn == "year" else m
        return DeviceCol(DataType.INT64, out, c.null)
    if expr.fn == "abs":
        c = eval_dev(expr.args[0], db)
        rng = None
        rp = _range_pair(c)
        if rp is not None:
            rng = bucket_range(0 if rp[0] <= 0 <= rp[1] else min(abs(rp[0]), abs(rp[1])),
                               max(abs(rp[0]), abs(rp[1])))
        return DeviceCol(c.dtype, torch.abs(c.data), c.null, range=rng, scale=c.scale)
    if expr.fn == "round":
        c = eval_dev(expr.args[0], db)
        digits = int(expr.args[1].value) if len(expr.args) > 1 else 0
        if c.scale is not None:
            if digits >= c.scale:
                return c
            if digits < 0:  # round to tens/hundreds: approximate path
                return DeviceCol(c.dtype, torch.round(descale_f32(c), decimals=digits), c.null)
            # round to `digits` decimals exactly, keeping the storage scale
            d = rescale_down(c, digits)
            return rescale_up(d, c.scale) if _eb(d) * 10 ** (c.scale - d.scale) < _I64_SAFE else d
        if not c.data.is_floating_point():
            if digits < 0:
                raise DeviceUnsupported("integer round to negative decimals")
            return c
        return DeviceCol(c.dtype, torch.round(c.data, decimals=digits), c.null)
    if expr.fn == "substr":
        c = eval_dev(expr.args[0], db)
        if not c.is_string:
            raise ExecutionError("substr over non-string")
        start = int(expr.args[1].value)
        length = int(expr.args[2].value) if len(expr.args) > 2 else None
        stop = None if length is None else start - 1 + length
        return _dict_transform(c, lambda s: s[start - 1 : stop])
    if expr.fn in ("upper", "lower", "trim", "ltrim", "rtrim"):
        c = eval_dev(expr.args[0], db)
        if not c.is_string:
            raise DeviceUnsupported(expr.fn)
        f = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
             "ltrim": str.lstrip, "rtrim": str.rstrip}[expr.fn]
        return _dict_transform(c, f)
    if expr.fn == "replace":
        if not all(isinstance(a, Lit) for a in expr.args[1:]):
            raise DeviceUnsupported("replace with non-literal pattern")
        c = eval_dev(expr.args[0], db)
        if not c.is_string:
            raise DeviceUnsupported("replace")
        frm, to = str(expr.args[1].value), str(expr.args[2].value)
        return _dict_transform(c, lambda s: s.replace(frm, to))
    if expr.fn in ("concat", "concat_op"):
        # device form: at most one string COLUMN, remaining args string
        # literals — the result is a transform of that column's dictionary
        if expr.fn == "concat":  # concat() skips NULL arguments entirely
            expr = Func(expr.fn, tuple(
                a for a in expr.args
                if not (isinstance(a, Lit) and a.value is None)
            ))
        elif any(isinstance(a, Lit) and a.value is None for a in expr.args):
            # x || NULL is NULL
            return DeviceCol(DataType.STRING, _zeros(db.n_pad, torch.int32, dev),
                             _ones_bool(db.n_pad, dev), np.array([""], dtype=object))
        col_ix = [i for i, a in enumerate(expr.args) if not isinstance(a, Lit)]
        if len(col_ix) > 1:
            raise DeviceUnsupported("concat of multiple columns")
        if not col_ix:  # all literals: constant string
            val = "".join(str(a.value) for a in expr.args)
            return DeviceCol(DataType.STRING, _zeros(db.n_pad, torch.int32, dev), None,
                             np.array([val], dtype=object))
        c = eval_dev(expr.args[col_ix[0]], db)
        if not c.is_string:
            raise DeviceUnsupported("concat of non-string column")
        if expr.fn == "concat" and c.null is not None:
            # concat() SKIPS null args (result non-null) — the masked
            # representation can't express that; host kernels handle it
            raise DeviceUnsupported("concat over nullable column")
        pre = "".join(str(a.value) for a in expr.args[: col_ix[0]])
        post = "".join(str(a.value) for a in expr.args[col_ix[0] + 1 :])
        return _dict_transform(c, lambda s: f"{pre}{s}{post}")
    if expr.fn == "starts_with":
        if not isinstance(expr.args[1], Lit):
            raise DeviceUnsupported("starts_with with non-literal prefix")
        c = eval_dev(expr.args[0], db)
        if not c.is_string:
            raise DeviceUnsupported("starts_with")
        prefix = str(expr.args[1].value)
        got = _string_lut(c, lambda d: np.array([s.startswith(prefix) for s in d.astype(object)]))
        return DeviceCol(DataType.BOOL, got, c.null)
    if expr.fn in ("strpos", "length"):
        if expr.fn == "strpos" and not isinstance(expr.args[1], Lit):
            raise DeviceUnsupported("strpos with non-literal needle")
        c = eval_dev(expr.args[0], db)
        if not c.is_string:
            raise DeviceUnsupported(f"{expr.fn} of non-string")
        if expr.fn == "strpos":
            sub = str(expr.args[1].value)
            lut = np.array([s.find(sub) + 1 for s in c.dictionary.astype(object)], np.int64)
        else:
            lut = np.array([len(s) for s in c.dictionary.astype(object)], np.int64)
        if len(lut) == 0:
            return DeviceCol(DataType.INT64, _zeros(db.n_pad, torch.int64, dev), c.null)
        return DeviceCol(DataType.INT64,
                         _lut_gather(lut, torch.clamp(c.data, 0, len(lut) - 1)), c.null)
    if expr.fn in ("sqrt", "exp", "ln", "log10"):
        c = eval_dev(expr.args[0], db)
        if NATIVE_DTYPES:
            x = _as_float(c, _float_width((c,)))
        else:
            x = c.data.to(torch.float64)
        out = {"sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
               "log10": torch.log10}[expr.fn](x)
        return DeviceCol(DataType.FLOAT64, out, c.null)
    if expr.fn in ("floor", "ceil", "sign"):
        c = eval_dev(expr.args[0], db)
        if c.dtype.is_integer and expr.fn in ("floor", "ceil"):
            return c
        if c.scale is not None:
            d = 10**c.scale
            if expr.fn == "sign":
                # output is one of {-1, 0, +1} whole units regardless of input
                return DeviceCol(c.dtype, torch.sign(c.data) * d, c.null,
                                 range=bucket_range(-d, d), scale=c.scale)
            if expr.fn == "floor":
                out = _fdiv(c.data, d) * d
            else:
                out = -_fdiv(-c.data, d) * d
            rng = None
            rp = _range_pair(c)
            if rp is not None:  # floor/ceil move at most one whole unit
                rng = bucket_range(rp[0] - d, rp[1] + d)
            return DeviceCol(c.dtype, out, c.null, range=rng, scale=c.scale)
        f = {"floor": torch.floor, "ceil": torch.ceil, "sign": torch.sign}[expr.fn]
        return DeviceCol(c.dtype, f(c.data).to(c.data.dtype), c.null)
    if expr.fn == "power":
        a = eval_dev(expr.args[0], db)
        b = eval_dev(expr.args[1], db)
        if NATIVE_DTYPES:
            ft = _float_width((a, b))
            out = torch.pow(_as_float(a, ft), _as_float(b, ft))
        else:
            out = torch.pow(a.data.to(torch.float64), b.data.to(torch.float64))
        return DeviceCol(DataType.FLOAT64, out, _merge_null(a.null, b.null))
    if expr.fn == "mod":
        # SQL mod() has truncating semantics (sign of the dividend)
        a = eval_dev(expr.args[0], db)
        b = eval_dev(expr.args[1], db)
        if a.scale is not None or b.scale is not None:
            sa, sb = as_scaled(a), as_scaled(b)
            al = align_scales(sa, sb) if (sa is not None and sb is not None) else None
            if al is not None:
                x, y, s = al
                zero = y.data == 0
                safe = torch.where(zero, torch.ones_like(y.data), y.data)
                out = torch.where(zero, torch.zeros_like(x.data),
                                  torch.sign(x.data) * torch.remainder(torch.abs(x.data),
                                                                       torch.abs(safe)))
                null = _merge_null(_merge_null(a.null, b.null), zero)
                return DeviceCol(a.dtype, out, null, scale=s)
            ft = _float_width((a, b))
            a = replace(a, data=_as_float(a, ft), scale=None) if a.scale is not None else a
            b = replace(b, data=_as_float(b, ft), scale=None) if b.scale is not None else b
        zero = b.data == 0
        safe = torch.where(zero, torch.ones_like(b.data), b.data)
        if a.dtype.is_integer:
            rem = torch.sign(a.data) * torch.remainder(torch.abs(a.data), torch.abs(safe))
        else:
            rem = a.data - torch.trunc(a.data / safe).to(a.data.dtype) * safe
        out = torch.where(zero, torch.zeros((), dtype=rem.dtype, device=dev), rem)
        null = _merge_null(_merge_null(a.null, b.null), zero)
        if NATIVE_DTYPES and a.dtype.is_floating:
            return DeviceCol(a.dtype, out, null)  # value-width float already
        return DeviceCol(a.dtype, out.to(tdtype(a.dtype.to_numpy())), null)
    if expr.fn == "nullif":
        a = eval_dev(expr.args[0], db)
        b = eval_dev(expr.args[1], db)
        if a.is_string or b.is_string:
            raise DeviceUnsupported("string nullif")
        bnull = b.null if b.null is not None else _zeros(db.n_pad, torch.bool, dev)
        if a.scale is not None or b.scale is not None:
            sa, sb = as_scaled(a), as_scaled(b)
            al = align_scales(sa, sb) if (sa is not None and sb is not None) else None
            if al is not None:
                eq = al[0].data == al[1].data
            else:
                ad = descale_f32(a) if a.scale is not None else a.data
                bd = descale_f32(b) if b.scale is not None else b.data
                eq = ad == bd
        else:
            eq = a.data == b.data
        return replace(a, null=_merge_null(a.null, eq & ~bnull))
    if expr.fn in ("greatest", "least"):
        cols = [eval_dev(a, db) for a in expr.args]
        if any(c.is_string for c in cols):
            raise DeviceUnsupported("string greatest/least")
        out_dt = expr.data_type(db.schema)  # promoted across ALL args
        pick = torch.maximum if expr.fn == "greatest" else torch.minimum
        out_scale: Optional[int] = None
        if NATIVE_DTYPES and any(c.scale is not None for c in cols):
            scaled = [as_scaled(c) for c in cols]
            if all(c is not None for c in scaled):
                s = max(c.scale for c in scaled)
                if all(_eb(c) * 10 ** (s - c.scale) < _I64_SAFE for c in scaled):
                    cols = [rescale_up(c, s) for c in scaled]
                    out_scale = s
            if out_scale is None:
                ft = _float_width(cols)
                cols = [
                    replace(c, data=_as_float(c, ft), scale=None)
                    if c.scale is not None else c
                    for c in cols
                ]
        if out_scale is not None:
            t_dt = torch.int64
        elif NATIVE_DTYPES and out_dt.is_floating:
            t_dt = _float_width(cols)
        else:
            t_dt = tdtype(out_dt.to_numpy())
        # NULL arguments are IGNORED; the result is NULL only when every
        # argument is NULL (pg/DataFusion semantics)
        out = cols[0].data.to(t_dt)
        null = cols[0].null if cols[0].null is not None else _zeros(db.n_pad, torch.bool, dev)
        for nxt in cols[1:]:
            v = nxt.data.to(t_dt)
            nn = nxt.null if nxt.null is not None else _zeros(db.n_pad, torch.bool, dev)
            both = ~null & ~nn
            out = torch.where(both, pick(out, v), torch.where(null & ~nn, v, out))
            null = null & nn
        return DeviceCol(out_dt, out, null, scale=out_scale)
    if expr.fn in ("day", "date_trunc"):
        arg = expr.args[0] if expr.fn == "day" else expr.args[1]
        c = eval_dev(arg, db)
        _y, _m, d, doy, days = _civil_parts(c.data)
        if expr.fn == "day":
            return DeviceCol(DataType.INT64, d, c.null)
        part = str(expr.args[0].value).lower()
        if part == "day":
            out = days
        elif part == "week":
            out = days - torch.remainder(days + 3, 7)
        elif part == "month":
            out = days - (d - 1)
        elif part == "year":
            out = days - (doy - 1)
        else:
            raise DeviceUnsupported(f"date_trunc part {part!r}")
        return DeviceCol(DataType.DATE32, out.to(torch.int32), c.null)
    raise ExecutionError(f"device func {expr.fn} unsupported")


class DeviceUnsupported(Exception):
    """A runtime shape the device path cannot express (e.g. concat of several
    string columns) — the engine catches this and falls back to the host
    kernels for the stage, unlike ExecutionError which is a real failure."""


def _dict_transform(c: DeviceCol, fn) -> DeviceCol:
    """String function as a dictionary rewrite: the (tiny) dictionary
    transforms on the host, codes re-map on the device (transforms can
    collide, e.g. upper('a')==upper('A'), so the result re-uniques)."""
    newdict_full = np.array([fn(s) for s in c.dictionary.astype(object)], dtype=object)
    if len(newdict_full) == 0:
        return DeviceCol(DataType.STRING, c.data, c.null, newdict_full)
    uniq, inv = np.unique(newdict_full, return_inverse=True)
    codes = _lut_gather(inv.astype(np.int32), torch.clamp(c.data, 0, len(inv) - 1))
    return DeviceCol(DataType.STRING, codes, c.null, uniq.astype(object))


def _civil_parts(days_i: torch.Tensor):
    """(year, month, day-of-month, day-of-year(1-based), days), all int64,
    from date32 — Howard Hinnant's civil-from-days, branch-free."""
    days = days_i.to(torch.int64)
    z = days + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy_mar = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # days since Mar 1
    mp = _fdiv(5 * doy_mar + 2, 153)
    d = doy_mar - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    # day-of-year relative to Jan 1 of the (adjusted) year
    jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
    doy = days - jan1 + 1
    return y, m, d, doy, days


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy_mar = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy_mar
    return era * 146097 + doe - 719468


# ---- grouping ------------------------------------------------------------------------
MAX_DIRECT_GROUPS = 1 << 16


def group_plan(key_cols: list[DeviceCol], n_pad: int):
    """Static grouping strategy from trace-time metadata (dictionary sizes,
    encoded int ranges). Returns ``("direct", per_key)`` — cardinality
    provably small: mixed-radix ids, per_key = [(radix, base, lo)] (radix
    includes a NULL slot) — or ``("sorted", k_bound)``: sort-based
    segmentation (``group_ids_sorted``) with k_bound output slots, fewer
    than n_pad whenever the key ranges bound the cardinality below it."""
    per_key = []
    total = 1
    for c in key_cols:
        if c.is_string:
            base, lo = max(1, len(c.dictionary)), 0
        elif c.range is not None:
            lo, base = c.range
        else:
            return ("sorted", n_pad)
        radix = base + (1 if c.null is not None else 0)
        per_key.append((radix, base, lo))
        total *= radix
    if total <= MAX_DIRECT_GROUPS:
        return ("direct", per_key)
    if total < n_pad:
        return ("sorted", int(total))
    return ("sorted", n_pad)


def group_ids_direct(db: DeviceBatch, key_cols: list[DeviceCol], per_key: list):
    """int64 ids in [0, k) by mixed radix over codes/offset values; k static.
    NULL keys take the extra radix slot; invalid rows get id k."""
    k = 1
    for r, _, _ in per_key:
        k *= r
    ids = _zeros(db.n_pad, torch.int64, db.device)
    for c, (radix, base, lo) in zip(key_cols, per_key):
        code = torch.clamp(c.data.to(torch.int64) - lo, 0, base - 1)
        if c.null is not None:
            code = torch.where(c.null, base, code)
        ids = ids * radix + code
    ids = torch.where(db.row_valid, ids, k)
    return ids, k


def decode_group_keys(key_cols: list[DeviceCol], per_key: list, k: int) -> list[DeviceCol]:
    """Inverse of group_ids_direct: reconstruct key columns for all k slots."""
    codes = torch.arange(k, dtype=torch.int64, device=key_cols[0].data.device)
    comps = []
    for radix, _, _ in reversed(per_key):
        comps.append(torch.remainder(codes, radix))
        codes = _fdiv(codes, radix)
    comps.reverse()
    out = []
    for c, (radix, base, lo), comp in zip(key_cols, per_key, comps):
        null = None
        if c.null is not None:
            null = comp == base
            comp = torch.clamp(comp, 0, base - 1)
        if c.is_string:
            out.append(DeviceCol(c.dtype, comp.to(torch.int32), null,
                                 c.dictionary, dict_id=c.dict_id))
        elif c.scale is not None:
            out.append(DeviceCol(c.dtype, comp + lo, null, range=c.range, scale=c.scale))
        else:
            out.append(DeviceCol(c.dtype, (comp + lo).to(tdtype(c.dtype.to_numpy())), null))
    return out


def canonical_data(c: DeviceCol) -> torch.Tensor:
    """Key data with NULL slots zeroed: device nulls may cover garbage values,
    and comparisons/segmentation must never see it."""
    if c.null is None:
        return c.data
    return torch.where(c.null, torch.zeros((), dtype=c.data.dtype, device=c.data.device),
                       c.data)


def group_ids_sorted(db: DeviceBatch, key_cols: list[DeviceCol], k: Optional[int] = None):
    """Sort-based segmentation: int64 ids in [0, k) plus the first row
    position of each segment (``n_pad`` for an empty one). Invalid rows, and
    segments past ``k``, get id k (the trash segment). ``k`` defaults to
    n_pad (always sound).

    Rows order by the mixed key hash; a segment starts wherever any key
    column changes, so a hash collision between adjacent distinct keys still
    segments correctly. The JAX package sorts the uint64 ``hash >> 1`` with
    invalid rows at 2^63, above every valid key; int64 has no such value,
    so stable argsorts chain on the key and then the invalid flag, which
    gives the same order."""
    n_pad = db.n_pad
    dev = db.device
    if k is None:
        k = n_pad
    mixed = _zeros(n_pad, torch.int64, dev)
    for c in key_cols:
        canon = _canonical_dev(c)
        if c.null is not None:
            # NULL must sort apart from the canonical fill value (0 / "") or
            # interleaved runs split the NULL group at every transition
            canon = canon ^ torch.where(c.null, _NULL_MIX, 0)
        mixed = splitmix64_dev(mixed ^ canon)
    order = torch.argsort(_shr(mixed, 1), stable=True)
    order = order[torch.argsort((~db.row_valid).to(torch.int32)[order], stable=True)]
    first = _ones_bool(1, dev)
    start = torch.cat([first, _zeros(n_pad - 1, torch.bool, dev)])
    for c in key_cols:
        # null slots may cover garbage data (join gathers): compare with
        # nulls zeroed and segment on null-flag changes, so all NULL keys
        # form one group (SQL GROUP BY semantics)
        vs = canonical_data(c)[order]
        start = start | torch.cat([first, vs[1:] != vs[:-1]])
        if c.null is not None:
            ns = c.null[order]
            start = start | torch.cat([first, ns[1:] != ns[:-1]])
    seg_sorted = torch.cumsum(start, 0) - 1
    ids = _zeros(n_pad, torch.int64, dev).scatter_(0, order, seg_sorted)
    ids = torch.where(db.row_valid & (ids < k), ids, k)
    reps = torch.full((k + 1,), n_pad, dtype=torch.int64, device=dev).scatter_reduce(
        0, ids, torch.arange(n_pad, device=dev), "amin", include_self=True)
    return ids, reps[:k]


# distinct odd constant mixed into per-row keys for NULL slots, so NULL never
# collides with the canonical fill value (0 / "") during sort-based
# segmentation; not used for bucketing (host parity there)
_NULL_MIX = _i64(0xA5A5A5A5A5A5A5A5)

# device copies of the pandas-hash LUTs of shared dictionaries, per
# (dict_id, device): a stage gathers through them without copying again
_HASH_LUTS: dict = {}


@functools.cache
def _empty_string_hash() -> int:
    """The pandas hash of "", the host's fill for a NULL string."""
    import pandas as pd

    return int(pd.util.hash_array(np.array([""], object)).astype(np.int64)[0])


def _hash_lut(c: DeviceCol, device) -> torch.Tensor:
    """int64 pandas hash of each dictionary entry, on ``device``."""
    if c.dict_id:
        from ballista_tpu_torch.engine.dictionaries import REGISTRY

        key = (c.dict_id, str(device))
        lut = _HASH_LUTS.get(key)
        if lut is not None and lut.shape[0] == len(c.dictionary):
            return lut
        host = REGISTRY.hash_lut(c.dict_id)
        if host is not None and len(host) == len(c.dictionary):
            if len(_HASH_LUTS) >= 1024:  # stale catalog versions
                _HASH_LUTS.clear()
            lut = _HASH_LUTS[key] = torch.from_numpy(host).to(device)
            return lut
    import pandas as pd

    host = pd.util.hash_array(c.dictionary.astype(object)).astype(np.int64)
    return torch.from_numpy(host).to(device)


def _canonical_dev(c: DeviceCol) -> torch.Tensor:
    """int64 canonical form matching ``kernels_np.canonical_int64``: SQL-equal
    values map to equal ints across engines. NULL slots take the host's fill
    value (0 / ""): device nulls may cover garbage data (join gathers,
    masked arithmetic), and grouping and bucketing must not see it."""
    dev = c.data.device
    if c.is_string:
        n = len(c.dictionary)
        if n == 0:  # empty partition
            return _zeros(c.data.shape[0], torch.int64, dev)
        out = _hash_lut(c, dev)[torch.clamp(c.data, 0, n - 1).to(torch.int64)]
        if c.null is not None:
            out = torch.where(c.null, _empty_string_hash(), out)
        return out
    d = canonical_data(c)
    if c.scale is not None:
        # exact descale (see sniff_decimal): an elementwise division rounds
        # correctly on every device, so these are the f64 bits the host
        # hashed. The divisor is a full tensor: CUDA divides by a Python
        # scalar as a multiply by its reciprocal, which can miss by an ulp
        d = d.to(torch.float64)
        d = d / torch.full_like(d, 10.0**c.scale)
    elif not d.is_floating_point():
        return d.to(torch.int64)
    d64 = d.to(torch.float64)
    return torch.where(d64 == 0.0, 0.0, d64).view(torch.int64)  # -0.0 as 0.0


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 held in ``x``'s bits, mod ``n``: u = 2 * (u >> 1) + (u & 1),
    with every term non-negative (``remainder`` of a negative int64 would
    take the signed value's residue)."""
    return torch.remainder(2 * torch.remainder(_shr(x, 1), n) + (x & 1), n)


def hash_bucket_dev(db: DeviceBatch, key_cols: list[DeviceCol], n: int) -> torch.Tensor:
    """Shuffle bucket per row (int32); bit-identical to
    ``kernels_np.hash_partition_indices``."""
    mixed = _zeros(db.n_pad, torch.int64, db.device)
    for c in key_cols:
        mixed = splitmix64_dev(mixed ^ _canonical_dev(c))
    return _umod(mixed, n).to(torch.int32)


# ---- device sort / top-k -----------------------------------------------------------
def _lex_order(keys: list, n: int, device) -> torch.Tensor:
    """The permutation that sorts rows by ``keys`` (most significant first),
    ties kept in row order: stable argsorts chained from the least
    significant key."""
    order = torch.arange(n, dtype=torch.int64, device=device)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    return order


def sort_device(
    db: DeviceBatch, key_specs: list[tuple[DeviceCol, bool]], fetch: Optional[int] = None
) -> DeviceBatch:
    """Whole-batch lexicographic sort. The JAX package does it as ONE
    multi-operand ``lax.sort``; torch has none, so stable argsorts chain from
    the least significant key to the most, ending with the invalid-row flag
    — the same order.

    Key encoding mirrors ``kernels_np._sort_key_arrays``: NULL sorts as
    largest (NULLS LAST for asc, FIRST for desc); padded-invalid rows sort
    after everything. Strings sort by dictionary code (code order ==
    lexicographic order). Descending keys sort ``-v``, which wraps on int64
    min exactly as the JAX package's does. ``fetch`` is a static top-k: the
    output is sliced to bucket_size(fetch) rows."""
    n_pad = db.n_pad
    keys: list[torch.Tensor] = [(~db.row_valid).to(torch.int32)]  # invalid last
    for c, asc in key_specs:
        if c.null is not None:
            # asc: nulls largest (1 after 0); desc: nulls first (-1 before 0)
            nullind = c.null.to(torch.int32)
            keys.append(nullind if asc else -nullind)
        v = canonical_data(c)  # NULL slots may cover garbage tie-break values
        vkey = v.to(torch.float64) if v.is_floating_point() else v.to(torch.int64)
        keys.append(vkey if asc else -vkey)
    order = _lex_order(keys, n_pad, db.device)

    out_pad = n_pad
    n_rows = db.n_rows
    if fetch is not None and fetch < n_pad:
        out_pad = bucket_size(fetch)
        order = order[:out_pad]
        n_rows = min(n_rows, fetch)
    row_valid = db.row_valid[order]
    if fetch is not None:
        row_valid = row_valid & (torch.arange(out_pad, device=db.device) < fetch)
    cols = [
        replace(c, data=c.data[order],
                null=c.null[order] if c.null is not None else None)
        for c in db.cols
    ]
    return DeviceBatch(db.schema, cols, row_valid, n_rows)


# ---- window functions --------------------------------------------------------------
def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _seg_scan(vals: torch.Tensor, seg_first: torch.Tensor, combine) -> torch.Tensor:
    """Segmented inclusive prefix scan (Hillis-Steele doubling): out_i =
    combine over vals[seg_first_i .. i], in log2(n) shifted-combine steps.
    ``seg_first`` is each row's segment start (a segment's rows are
    contiguous)."""
    n = int(vals.shape[0])
    idx = torch.arange(n, dtype=torch.int64, device=vals.device)
    m = vals
    s = 1
    while s < n:
        shifted = torch.cat([m[:s], m[:-s]])
        m = torch.where((idx - s) >= seg_first, combine(m, shifted), m)
        s <<= 1
    return m


def sparse_level(length: torch.Tensor) -> torch.Tensor:
    """floor(log2(length)) of int64 lengths >= 1, by integer means: the
    exponent ``frexp`` gives (length = m * 2^e, m in [0.5, 1)) less one.
    A float log2 can land an ulp below an integer and pick the level
    under the right one."""
    return torch.frexp(length.to(torch.float64)).exponent.to(torch.int64) - 1


def window_device(db: DeviceBatch, window_exprs, out_schema: Schema) -> DeviceBatch:
    """Device evaluation of ``fn(...) OVER (PARTITION BY ... ORDER BY ...)``:
    the port of ``kernels_jax.window_device``, with the semantics of
    ``kernels_np.window_eval`` (the SQL default frame: running with peers when
    ORDER BY is present, the whole partition otherwise; NULLs sort as
    ``sort_device`` sorts them). One stable lexicographic sort per window
    expression orders rows by (validity, partition keys, order keys); the
    results scatter back to the rows' own positions. Padded-invalid rows sort
    last into a segment of their own."""
    from ballista_tpu_torch.plan.expr import WindowFunc, unalias

    cols = list(db.cols)
    for e in window_exprs:
        w = unalias(e)
        assert isinstance(w, WindowFunc)
        cols.append(_one_window_dev(db, w))
    return DeviceBatch(out_schema, cols, db.row_valid, db.n_rows)


def _group_key_bits(c: DeviceCol) -> torch.Tensor:
    """A partition key as int64 whose equality is the key's: codes and ints
    as they are, floats by their f64 bits with -0.0 made 0.0. Bit equality
    keeps NaN rows in one partition, where a float comparison would split
    them (NaN != NaN)."""
    canon = canonical_data(c)
    if canon.is_floating_point():
        d64 = canon.to(torch.float64)
        return torch.where(d64 == 0.0, 0.0, d64).view(torch.int64)
    return canon.to(torch.int64)


def _one_window_dev(db: DeviceBatch, w) -> DeviceCol:
    n = db.n_pad
    dev = db.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    keys: list = [(~db.row_valid).to(torch.int32)]
    part_specs: list = []
    for p in w.partition_by:
        c = eval_dev(p, db)
        part_specs.append(c)
        if c.null is not None:
            keys.append(c.null.to(torch.int32))
        keys.append(_group_key_bits(c))
    order_specs: list = []
    for expr, asc in w.order_by:
        c = eval_dev(expr, db)
        order_specs.append((c, asc))
        if c.null is not None:
            nullind = c.null.to(torch.int32)
            keys.append(nullind if asc else -nullind)
        v = canonical_data(c)
        v = v.to(torch.float64) if v.is_floating_point() else v.to(torch.int64)
        keys.append(v if asc else -v)
    order = _lex_order(keys, n, dev)

    first = _ones_bool(1, dev)

    def changed(c: DeviceCol, bits: bool) -> torch.Tensor:
        # partition keys compare bits (NaN rows form one partition), order
        # keys compare values (each NaN is a peer group of its own), as the
        # host kernels do
        vs = (_group_key_bits(c) if bits else canonical_data(c))[order]
        ch = torch.cat([first, vs[1:] != vs[:-1]])
        if c.null is not None:
            ns = c.null[order]
            ch = ch | torch.cat([first, ns[1:] != ns[:-1]])
        return ch

    # invalid rows sort last; the first of them starts a segment of its own
    rv_s = db.row_valid[order]
    seg_start = torch.cat([first, rv_s[1:] != rv_s[:-1]])
    for c in part_specs:
        seg_start = seg_start | changed(c, bits=True)
    peer_start = seg_start
    for c, _asc in order_specs:
        peer_start = peer_start | changed(c, bits=False)

    seg_first = _cummax(torch.where(seg_start, idx, 0))

    def last_idx(starts):
        tail = torch.full((1,), n, dtype=torch.int64, device=dev)
        nxt = torch.cat([torch.where(starts, idx, n)[1:], tail])
        return torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,)) - 1

    def scatter(vals, dtype: DataType, null=None, scale=None):
        # ``order`` is a permutation: every slot written once
        out = torch.empty(n, dtype=vals.dtype, device=dev)
        out[order] = vals
        onull = None
        if null is not None:
            onull = torch.empty(n, dtype=torch.bool, device=dev)
            onull[order] = null
        return DeviceCol(dtype, out, onull, scale=scale)

    if w.fn == "row_number":
        return scatter(idx - seg_first + 1, DataType.INT64)
    if w.fn == "rank":
        first_of_peer = _cummax(torch.where(peer_start, idx, 0))
        return scatter(first_of_peer - seg_first + 1, DataType.INT64)
    if w.fn == "dense_rank":
        peers_so_far = torch.cumsum(peer_start.to(torch.int64), 0)
        return scatter(peers_so_far - peers_so_far[seg_first] + 1, DataType.INT64)

    # aggregate window functions
    is_int = False
    out_scale: Optional[int] = None
    c = None
    if w.args:
        c = eval_dev(w.args[0], db)
        if c.is_string:
            raise ExecutionError("string window aggregates unsupported")
        if c.scale is not None and w.fn in ("sum", "min", "max", "avg") \
                and _eb(c) * n < _I64_SAFE:
            # scaled decimal: exact int64 prefix sums (the headroom is proven
            # at trace time); AVG divides exactly on output
            is_int = True
            out_scale = c.scale
            vals = c.data[order]
        elif c.scale is not None:
            vals = _as_float(c, torch.float64)[order]  # count, or no headroom
        else:
            is_int = c.dtype.is_integer and w.fn in ("sum", "min", "max")
            vals = c.data.to(torch.int64 if is_int else torch.float64)[order]
        valid = _mask(db.row_valid, c.null)[order]
    else:  # count(*)
        vals = torch.ones(n, dtype=torch.int64, device=dev)
        valid = db.row_valid[order]

    vz = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=dev))
    csum = torch.cumsum(vz, 0)
    ccnt = torch.cumsum(valid.to(torch.int64), 0)
    before_seg = torch.clamp(seg_first - 1, min=0)
    base_sum = torch.where(seg_first > 0, csum[before_seg], torch.zeros_like(csum[:1]))
    base_cnt = torch.where(seg_first > 0, ccnt[before_seg], 0)
    end_idx = last_idx(peer_start) if w.order_by else last_idx(seg_start)

    avg_out_scale: list = [None]

    def avg_full(s_, cnt):
        if out_scale is not None:
            data, sc2, _ = avg_scaled(s_, cnt, out_scale, _eb(c) * n)
            avg_out_scale[0] = sc2
            return data
        return s_ / torch.clamp(cnt, min=1)

    def agg_out(full, empty):
        if w.fn == "count":
            return scatter(full.to(torch.int64), DataType.INT64)
        if out_scale is not None:
            scale = avg_out_scale[0] if w.fn == "avg" else out_scale
            return scatter(full, DataType.FLOAT64, empty, scale=scale)
        dt = DataType.INT64 if is_int else DataType.FLOAT64
        return scatter(full.to(torch.int64 if is_int else torch.float64), dt, empty)

    if w.frame is not None:
        return _frame_aggregate_dev(
            w, n, vals, valid, seg_start, peer_start, seg_first, last_idx,
            csum, ccnt, is_int, agg_out, order_specs, order, avg_full,
        )

    if w.fn in ("sum", "avg", "count"):
        run_sum = csum[end_idx] - base_sum
        run_cnt = ccnt[end_idx] - base_cnt
        if w.fn == "sum":
            full = run_sum
        elif w.fn == "count":
            full = run_cnt
        else:
            full = avg_full(run_sum, run_cnt)
        return agg_out(full, run_cnt == 0)
    if w.fn in ("min", "max"):
        vv = torch.where(valid, vals, _window_sentinel(vals, w.fn == "min"))
        run = _seg_scan(vv, seg_first, torch.minimum if w.fn == "min" else torch.maximum)
        # empty = no valid value in the frame (a sentinel comparison would
        # null out frames whose real min/max is +-inf or an int64 extreme)
        run_cnt = ccnt[end_idx] - base_cnt
        return agg_out(run[end_idx], run_cnt == 0)
    raise ExecutionError(f"window function {w.fn} unsupported on device")


def _window_sentinel(vals: torch.Tensor, is_min: bool) -> torch.Tensor:
    """The identity of min (or max) in ``vals``' dtype, as a 0-d tensor."""
    if vals.is_floating_point():
        v = float("inf") if is_min else float("-inf")
    else:
        info = torch.iinfo(vals.dtype)
        v = info.max if is_min else info.min
    return torch.full((), v, dtype=vals.dtype, device=vals.device)


def _bounded_searchsorted_dev(values, queries, lo0, hi0, side: str) -> torch.Tensor:
    """Per-row binary search of ``queries[i]`` within ``values[lo0[i]:hi0[i])``
    (ascending within each row's own window), in a fixed log2(n) number of
    steps of gathers and selects. NaN follows ``np.searchsorted``'s total
    order (NaN above every number, NaN == NaN): a NaN query inserts at the
    first NaN for 'left' and after the last for 'right', as the host kernels
    do."""
    n = int(values.shape[0])
    lo = lo0.to(torch.int64)
    hi = hi0.to(torch.int64)
    qnan = torch.isnan(queries)  # all False for integer keys
    steps = max(1, int(np.ceil(np.log2(n + 1))))
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = values[torch.clamp(mid, 0, n - 1)]
        if side == "left":
            go_right = torch.where(qnan, ~torch.isnan(v), v < queries)
        else:
            go_right = qnan | (v <= queries)
        active = mid < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _frame_aggregate_dev(
    w, n, vals, valid, seg_start, peer_start, seg_first, last_idx,
    csum, ccnt, is_int, agg_out, order_specs, order, avg_full,
):
    """Explicit ROWS / RANGE frames: the port of
    ``kernels_jax._frame_aggregate_dev``, with the semantics of
    ``kernels_np._frame_aggregate``. Frame bounds are index arithmetic
    clipped to the segment; sums and counts come from the prefix arrays,
    min and max from a sparse table of log2(n) levels. RANGE frames with
    value offsets bound their rows by a per-row binary search over the sorted
    key, within each segment's non-null key region. Every gather index is
    clamped into the array: an empty frame's bound may lie one past its end
    (its value is masked out afterwards)."""
    from ballista_tpu_torch.plan.expr import (
        CURRENT_ROW, FOLLOWING, PRECEDING, UNBOUNDED_FOLLOWING, UNBOUNDED_PRECEDING,
    )

    f = w.frame
    dev = vals.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    seg_last = last_idx(seg_start)
    peer_first = _cummax(torch.where(peer_start, idx, 0))
    peer_last = last_idx(peer_start)

    if f.units == "rows":
        def bound(kind, off, is_start):
            if kind == UNBOUNDED_PRECEDING:
                return seg_first
            if kind == UNBOUNDED_FOLLOWING:
                return seg_last
            if kind == CURRENT_ROW:
                return idx
            d = int(off)
            return idx - d if kind == PRECEDING else idx + d

        lo = bound(*f.start, True)
        hi = bound(*f.end, False)
    elif {f.start[0], f.end[0]} & {PRECEDING, FOLLOWING}:
        # RANGE with value offsets over the single numeric ORDER BY key
        # (the planner enforces it; checked again here)
        if order_specs is None or len(order_specs) != 1:
            raise DeviceUnsupported("RANGE offset frame without single order key")
        kcol, asc = order_specs[0]
        if kcol.is_string:
            raise DeviceUnsupported("RANGE offset frame over string key")
        if kcol.scale is not None:
            # scaled decimal key: integer bounds, offsets scaled exactly
            key = kcol.data[order]
            key_sent = torch.iinfo(torch.int64).max

            def off_of(off):
                dv = float(off) * 10.0**kcol.scale
                if dv != round(dv):
                    raise DeviceUnsupported("RANGE offset not at key scale")
                return int(round(dv))
        else:
            # float keys add the offset as a Python float: an addition
            # rounds the same on every device
            key = kcol.data.to(torch.float64)[order]
            key_sent = float("inf")

            def off_of(off):
                return float(off)
        if not asc:
            key = -key  # PRECEDING is always the smaller key
        knull = kcol.null[order] if kcol.null is not None else \
            torch.zeros(n, dtype=torch.bool, device=dev)
        # non-null key region per segment: nulls sort last for asc, first
        # for desc (the host's _sort_key_arrays encoding)
        cn = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(knull.to(torch.int64), 0)])
        seg_nulls = cn[seg_last + 1] - cn[seg_first]
        if asc:
            va, vb = seg_first, seg_last + 1 - seg_nulls  # [va, vb)
        else:
            va, vb = seg_first + seg_nulls, seg_last + 1
        # null and padded slots sort past every real key in the searched
        # values (the [va, vb) bounds already exclude them)
        skey = torch.where(knull, torch.full((), key_sent, dtype=key.dtype, device=dev), key)

        def rng_bound(kind, off, is_start):
            if kind == UNBOUNDED_PRECEDING:
                return seg_first
            if kind == UNBOUNDED_FOLLOWING:
                return seg_last
            if kind == CURRENT_ROW:
                return peer_first if is_start else peer_last
            d = off_of(off) if kind == FOLLOWING else -off_of(off)
            q = key + d
            if is_start:
                return _bounded_searchsorted_dev(skey, q, va, vb, "left")
            return _bounded_searchsorted_dev(skey, q, va, vb, "right") - 1

        lo = rng_bound(*f.start, True)
        hi = rng_bound(*f.end, False)
        # a null key's offset bound collapses to the null peer group (nulls
        # are peers); UNBOUNDED and CURRENT ROW bounds keep their meaning
        if f.start[0] in (PRECEDING, FOLLOWING):
            lo = torch.where(knull, peer_first, lo)
        if f.end[0] in (PRECEDING, FOLLOWING):
            hi = torch.where(knull, peer_last, hi)
    else:
        def bound(kind, off, is_start):
            if kind == UNBOUNDED_PRECEDING:
                return seg_first
            if kind == UNBOUNDED_FOLLOWING:
                return seg_last
            return peer_first if is_start else peer_last

        lo = bound(*f.start, True)
        hi = bound(*f.end, False)

    lo = torch.minimum(torch.maximum(lo, seg_first), seg_last + 1)
    hi = torch.minimum(torch.maximum(hi, seg_first - 1), seg_last)
    empty_frame = lo > hi
    hi_c = torch.clamp(torch.where(empty_frame, lo, hi), max=n - 1)
    before = torch.clamp(lo - 1, min=0)
    bcnt = torch.where(lo > 0, ccnt[before], 0)
    fcnt = torch.where(empty_frame, 0, ccnt[hi_c] - bcnt)

    if w.fn in ("sum", "avg", "count"):
        zero = torch.zeros((), dtype=csum.dtype, device=dev)
        base = torch.where(lo > 0, csum[before], zero)
        fsum = torch.where(empty_frame, zero, csum[hi_c] - base)
        if w.fn == "sum":
            full = fsum
        elif w.fn == "count":
            full = fcnt
        else:
            full = avg_full(fsum, fcnt)
        return agg_out(full, fcnt == 0)
    if w.fn in ("min", "max"):
        reduce_ = torch.minimum if w.fn == "min" else torch.maximum
        sent = _window_sentinel(vals, w.fn == "min")
        vv = torch.where(valid, vals, sent)
        # the sparse table, each level padded to the full length with the
        # sentinel: level j holds the reduction of 2^j rows from each row
        tables = [vv]
        j = 1
        while (1 << j) <= n:
            prev = tables[-1]
            half = 1 << (j - 1)
            tables.append(reduce_(prev, torch.cat([prev[half:], sent.expand(half)])))
            j += 1
        stacked = torch.stack(tables)  # [levels, n]
        level = sparse_level(torch.clamp(hi - lo + 1, min=1))
        l_pos = torch.clamp(lo, max=n - 1)
        r_pos = torch.maximum(hi_c - (torch.ones_like(level) << level) + 1, l_pos)
        out = reduce_(stacked[level, l_pos], stacked[level, r_pos])
        return agg_out(out, fcnt == 0)
    raise ExecutionError(f"window function {w.fn} does not accept a frame")


# ---- aggregates ----------------------------------------------------------------------
# AVG(decimal) gains up to 6 digits (DataFusion's Decimal avg adds 4; two
# more keep the quantization under the 1e-6 relative oracle tolerance at
# small magnitudes)
AVG_EXTRA_SCALE = 6


def avg_scaled(sum_data: torch.Tensor, cnt: torch.Tensor, scale: int, bound: int):
    """Exact rounded integer AVG of scaled sums: out = sum / cnt at scale
    ``scale + extra`` with half-to-even rounding — no float ops, and the
    result is again a scaled decimal. ``extra`` shrinks below
    AVG_EXTRA_SCALE only when headroom demands; the output scale caps at
    MAX_DECIMAL_SCALE so the average stays re-sniffable after a host trip."""
    extra = min(AVG_EXTRA_SCALE, max(0, MAX_DECIMAL_SCALE - scale))
    while extra > 0 and bound * 10**extra >= _I64_SAFE:
        extra -= 1
    m = 10**extra
    cnt_safe = torch.clamp(cnt, min=1)
    r = sum_data * m
    q = _fdiv(r, cnt_safe)
    rem = r - q * cnt_safe
    up = (2 * rem > cnt_safe) | ((2 * rem == cnt_safe) & (torch.remainder(q, 2) != 0))
    return q + up.to(torch.int64), scale + extra, m


def _sum_bound(c: DeviceCol, n_pad: int) -> int:
    """Worst-case |segment sum| in scaled units: the subset-sum bound when
    known (tight), else max|row| * n_pad (sound but pessimistic)."""
    wc = _eb(c) * n_pad
    return min(wc, c.ssum) if c.ssum is not None else wc


def presum_safe(c: DeviceCol, n_pad: int) -> DeviceCol:
    """Guarantee an int64 segment-sum over ``n_pad`` rows cannot wrap: drop
    decimal digits until the worst-case bound fits, or raise
    DeviceUnsupported so the stage falls back to host f64 kernels. No-op for
    unscaled columns."""
    if c.scale is None:
        return c
    cc = c
    while _sum_bound(cc, n_pad) >= _I64_SAFE and cc.scale > 0:
        cc = rescale_down(cc, cc.scale - 1)
    if _sum_bound(cc, n_pad) >= _I64_SAFE:
        raise DeviceUnsupported("scaled int64 sum overflow unavoidable")
    return cc


def sum_range(c: DeviceCol, n_pad: int) -> Optional[tuple[int, int]]:
    """Static range of a segment sum (bucketed), for downstream headroom."""
    if c.scale is None or c.range is None:
        return None
    b = _sum_bound(c, n_pad)
    return bucket_range(-b, b)


# segment sums and counts over at most this many groups go through the
# grouped_sums kernel; more groups use index_add_ / scatter_reduce
MASKED_SEG_K = 32

def _mask(row_valid, null):
    return row_valid if null is None else (row_valid & ~null)


class SegSums:
    """The segment sums and counts of one aggregate stage, registered while
    its aggregates are traced and computed together by ``compute``.

    At ``0 < k <= MASKED_SEG_K`` that is one ``grouped_sums_multi`` call per
    accumulator type present (int64 for int sums and counts, float32 for f32
    sums): ids are read once per launch and each distinct mask once — the
    eager counterpart of what one ``jit`` trace gives the JAX engine. A call
    is one launch unless the stage has more columns than one launch takes;
    the wrapper then splits it (``grouped_sums.column_chunks``). Counts over
    the same mask (the same ``null`` tensor, or none) are one column. float64
    sums, and every sum at other k, go through ``index_add_`` one by one.
    Floats accumulate in f32 and ints in int64, the kernel's types; each
    result keeps its input's width, as the JAX package's does."""

    def __init__(self, ids, k, row_valid):
        self.ids, self.k, self.row_valid = ids, k, row_valid
        self._masks: dict = {}   # id(null) -> (null, mask); keeps null alive
        self._cols: list = []    # (vals or None for a count, mask)
        self._counts: dict = {}  # id(null) -> column of its count

    def _mask(self, null):
        key = id(null)
        if key not in self._masks:
            self._masks[key] = (null, _mask(self.row_valid, null).contiguous())
        return self._masks[key][1]

    def sum(self, vals, null) -> int:
        """Registers the sum of ``vals`` over the valid, non-null rows;
        returns its index in ``compute``'s list."""
        self._cols.append((vals, self._mask(null)))
        return len(self._cols) - 1

    def count(self, null) -> int:
        """Registers the count of the valid, non-null rows (shared by every
        count over the same ``null``); returns its index."""
        key = id(null)
        if key not in self._counts:
            self._cols.append((None, self._mask(null)))
            self._counts[key] = len(self._cols) - 1
        return self._counts[key]

    def compute(self) -> list:
        """The registered sums and counts, in registration order."""
        from ballista_tpu_torch.ops import grouped_sums as GS

        ids, k = self.ids, self.k
        out: list = [None] * len(self._cols)
        batches: dict = {}  # accumulator dtype -> [column index]
        for i, (v, mask) in enumerate(self._cols):
            if k == 0:
                dt = torch.int64 if v is None else v.dtype
                out[i] = torch.zeros(0, dtype=dt, device=ids.device)
            elif k <= MASKED_SEG_K and (v is None or v.dtype != torch.float64):
                acc = torch.int64 if v is None or v.dtype != torch.float32 else torch.float32
                batches.setdefault(acc, []).append(i)
            elif v is None:
                m = mask.to(torch.int64)
                out[i] = torch.zeros(k + 1, dtype=torch.int64, device=m.device) \
                    .index_add_(0, ids, m)[:k]
            else:
                vm = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=v.device))
                out[i] = torch.zeros(k + 1, dtype=v.dtype, device=v.device) \
                    .index_add_(0, ids, vm)[:k]
        for acc, idx in batches.items():
            # no-ops for the engine's own (contiguous) columns
            vals = [None if self._cols[i][0] is None
                    else self._cols[i][0].to(acc).contiguous() for i in idx]
            masks = [self._cols[i][1] for i in idx]
            res = GS.grouped_sums_multi(vals, masks, ids.contiguous(), k)
            for row, i in enumerate(idx):
                v = self._cols[i][0]
                out[i] = res[row] if v is None else res[row].to(v.dtype)
        return out


def seg_min(vals, ids, k, row_valid, null, is_min=True):
    mask = _mask(row_valid, null)
    if vals.is_floating_point():
        sent = float("inf") if is_min else float("-inf")
    else:
        info = torch.iinfo(vals.dtype)
        sent = info.max if is_min else info.min
    v = torch.where(mask, vals, torch.full((), sent, dtype=vals.dtype, device=vals.device))
    if k == 0:
        return v.new_zeros((0,))
    out = torch.full((k + 1,), sent, dtype=v.dtype, device=v.device)
    out = out.scatter_reduce(0, ids, v, reduce="amin" if is_min else "amax",
                             include_self=True)
    return out[:k]
