"""Typed columnar wire codec (PWHX6 frames) — counterpart of
``pathway_tpu/parallel/wire.py``, the part the replication delta stream
uses. The bytes are the reference's: a frame either package encodes, the
other decodes. Pickled parts (whole control frames and object columns that
are not uniform arrays) go through ``persistence/_pickle.py``, so a class of
either package loads as the reader's own.

The reference's notes follow.

The PWHX5 mesh shipped every cross-process hop as a raw ``pickle.dumps``
of full-width ``DiffBatch`` columns, so DCN bytes scaled with column
width and the whole frame serialized under the per-peer send lock.
This module replaces that with a typed, self-describing columnar
encoding in the spirit of EQuARX's block-quantized collectives
(PAPERS.md, https://arxiv.org/pdf/2506.17615):

- row keys (sorted-ish uint64) as zigzag-delta + LEB128 varint, with a
  raw fallback when the delta stream would be larger;
- diff weights (overwhelmingly +/-1) as a constant, a sign bitmap, or
  zigzag varints;
- numeric value columns as raw little-endian bytes, with an **opt-in**
  lossy tier (``PATHWAY_DCN_QUANT=bf16|int8``) for float columns —
  keys, diffs and every non-float column stay lossless always;
- object columns whose elements are uniform ndarrays (embedding rows,
  the TPU-KNN gather payload, https://arxiv.org/pdf/2206.14286) as one
  stacked raw block (bf16/int8-quantizable like flat float columns);
- any other object column falls back to a per-column pickle.

Every batch carries a self-describing header (row count, per-column
name + encoding tag + dtype), so decode needs no out-of-band schema.
Frame bodies start with a one-byte tag — ``P`` (whole-frame pickle,
the PWHX5 format and the ``PATHWAY_DCN_WIRE=pickle`` escape hatch) or
``C`` (codec data frame) — so both formats interoperate inside one
PWHX6 connection and barrier/scalar frames simply stay pickled.

All encoders/decoders are numpy-vectorized (no per-row Python on the
hot path); the varint codec uses a matrix-shift encode and a
reduceat-based decode.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Sequence

import numpy as np

from pathway_tpu_torch.engine.batch import DiffBatch, uniform_element_spec
from pathway_tpu_torch.persistence import _pickle

FRAME_PICKLE = b"P"  # body[1:] is pickle.dumps(frame)
FRAME_CODEC = b"C"  # body[1:] is the columnar encoding below
_CODEC_VERSION = 1

# keys section tags
_K_DELTA = 0  # zigzag(delta) varints
_K_RAW = 1  # raw little-endian uint64

# diffs section tags
_D_CONST = 0  # all rows share one value: a single int64
_D_SIGN = 1  # all rows in {+1, -1}: packbits(diff < 0)
_D_VARINT = 2  # zigzag varints

# column section tags
_C_RAW = 0  # dtype str + raw little-endian bytes
_C_PKL = 1  # pickle of the object ndarray
_C_STACK = 2  # uniform ndarray elements stacked into one raw block
_C_QUANT = 3  # quantized flat float column (bf16/int8 sub-tag)
_C_STACK_QUANT = 4  # quantized stacked ndarray elements
_C_INTV = 5  # integer column as (zigzag) varints — lossless, chosen
# only when actually smaller than raw (counts/ids hug zero)

_Q_BF16 = 0
_Q_INT8 = 1

_INT8_BLOCK = 1024  # per-block absmax scale granularity


class WireError(ValueError):
    """Malformed or unsupported wire bytes (authenticated frames only
    reach this decoder, so in practice this means a codec bug or a
    version skew the handshake failed to catch)."""


# --- varint / zigzag primitives (vectorized) -------------------------------

_SHIFTS = (np.arange(10, dtype=np.uint64) * np.uint64(7))[None, :]
_COLS = np.arange(10)[None, :]


def uvarint_encode(
    values: np.ndarray, max_bytes: int | None = None
) -> bytes | None:
    """LEB128-encode a uint64 array without a per-value Python loop:
    build a width-capped (n, wmax) byte matrix with vector shifts, then
    keep each value's leading ``nbytes`` entries via a boolean mask.
    With ``max_bytes`` set, returns None as soon as the encoded size
    would exceed it — callers use that to fall back to a raw encoding
    without paying for a doomed matrix build."""
    v = np.ascontiguousarray(values, dtype=np.uint64)
    n = v.shape[0]
    if n == 0:
        return b""
    vmax = int(v.max())
    if vmax < 128:  # dense fast path: sorted-key deltas, small counts
        if max_bytes is not None and n > max_bytes:
            return None
        return v.astype(np.uint8).tobytes()
    wmax = 1
    while wmax < 10 and vmax >= (1 << (7 * wmax)):
        wmax += 1
    nb = np.ones(n, dtype=np.int64)
    for j in range(1, wmax):
        nb += v >= (np.uint64(1) << np.uint64(7 * j))
    if max_bytes is not None and int(nb.sum()) > max_bytes:
        return None
    mat = ((v[:, None] >> _SHIFTS[:, :wmax]) & np.uint64(0x7F)).astype(
        np.uint8
    )
    mat |= (_COLS[:, :wmax] < (nb - 1)[:, None]).astype(np.uint8) << 7
    return mat[_COLS[:, :wmax] < nb[:, None]].tobytes()


def uvarint_decode(raw: np.ndarray, count: int) -> np.ndarray:
    """Decode ``count`` LEB128 values from a uint8 array holding exactly
    the varint section. Group boundaries come from the continuation
    bits; each group sums its shifted 7-bit payloads via reduceat."""
    if count == 0:
        if raw.size:
            raise WireError("varint section has trailing bytes")
        return np.empty(0, dtype=np.uint64)
    if raw.size == count:  # all single-byte (dense fast path)
        if (raw & 0x80).any():
            raise WireError("varint section does not hold the declared count")
        return raw.astype(np.uint64)
    term = (raw & 0x80) == 0
    ends = np.flatnonzero(term)
    if ends.size != count or ends[-1] != raw.size - 1:
        raise WireError("varint section does not hold the declared count")
    starts = np.empty(count, dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    gid = np.cumsum(term) - term
    offsets = np.arange(raw.size, dtype=np.int64) - starts[gid]
    if offsets.size and int(offsets.max()) > 9:
        raise WireError("varint value longer than 10 bytes")
    payload = (raw & 0x7F).astype(np.uint64) << (
        offsets.astype(np.uint64) * np.uint64(7)
    )
    return np.add.reduceat(payload, starts)


# width-packing modes (1-byte prefix on every packed-uint section)
_PK_VARINT = 0
_PK_U8 = 1
_PK_U16 = 2
_PK_U32 = 3
_PK_U64 = 4
_PK_WIDTH = {_PK_U8: "<u1", _PK_U16: "<u2", _PK_U32: "<u4", _PK_U64: "<u8"}


def pack_uints(
    values: np.ndarray, max_bytes: int | None = None
) -> bytes | None:
    """Lossless uint64 sequence packing: one ``.max()`` picks the
    narrowest fixed byte width (a single astype — far cheaper than the
    varint matrix), falling back to LEB128 varints only for the skewed
    big-value case where per-value widths actually pay. A 1-byte mode
    prefix keeps the section self-describing. With ``max_bytes`` set,
    returns None instead of exceeding it (raw-fallback probe)."""
    v = np.ascontiguousarray(values, dtype=np.uint64)
    n = v.shape[0]
    if n == 0:
        return b"\x00"
    vmax = int(v.max())
    if vmax < 1 << 8:
        mode, width = _PK_U8, 1
    elif vmax < 1 << 16:
        mode, width = _PK_U16, 2
    elif vmax < 1 << 32:
        mode, width = _PK_U32, 4
    else:
        # mostly-small values with a huge outlier: varints; otherwise u64
        enc = uvarint_encode(
            v, max_bytes=None if max_bytes is None else max_bytes - 1
        )
        if enc is not None and len(enc) < 8 * n:
            return struct.pack("<B", _PK_VARINT) + enc
        mode, width = _PK_U64, 8
    if max_bytes is not None and 1 + width * n > max_bytes:
        return None
    return struct.pack("<B", mode) + v.astype(_PK_WIDTH[mode]).tobytes()


def unpack_uints(raw: np.ndarray, count: int) -> np.ndarray:
    """Inverse of :func:`pack_uints`; ``raw`` is the uint8 view of the
    whole section (mode prefix included)."""
    if raw.size < 1:
        raise WireError("empty packed-uint section")
    mode = int(raw[0])
    body = raw[1:]
    if count == 0:
        if body.size:
            raise WireError("packed-uint section has trailing bytes")
        return np.empty(0, dtype=np.uint64)
    if mode == _PK_VARINT:
        return uvarint_decode(body, count)
    dtype = _PK_WIDTH.get(mode)
    if dtype is None:
        raise WireError(f"unknown packed-uint mode {mode}")
    vals = np.frombuffer(body.tobytes(), dtype=dtype)
    if vals.shape[0] != count:
        raise WireError("packed-uint section length mismatch")
    return vals.astype(np.uint64)


def zigzag(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.int64)
    return (x.view(np.uint64) << np.uint64(1)) ^ (
        x >> np.int64(63)
    ).view(np.uint64)


def unzigzag(z: np.ndarray) -> np.ndarray:
    z = np.ascontiguousarray(z, dtype=np.uint64)
    return ((z >> np.uint64(1)) ^ (np.uint64(0) - (z & np.uint64(1)))).view(
        np.int64
    )


# --- section encoders ------------------------------------------------------


def _encode_keys(keys: np.ndarray) -> tuple[int, bytes]:
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    n = k.shape[0]
    if n == 0:
        return _K_DELTA, b""
    deltas = np.empty(n, dtype=np.uint64)
    deltas[0] = k[0]
    deltas[1:] = k[1:] - k[:-1]  # mod-2^64 wrap keeps decode exact
    enc = pack_uints(zigzag(deltas.view(np.int64)), max_bytes=8 * n - 1)
    if enc is None:  # adversarially unsorted keys: raw is smaller
        return _K_RAW, k.tobytes()
    return _K_DELTA, enc


def _decode_keys(tag: int, raw: bytes, n: int) -> np.ndarray:
    if n == 0:
        if raw:
            raise WireError("key section has trailing bytes")
        return np.empty(0, dtype=np.uint64)
    if tag == _K_RAW:
        if len(raw) != 8 * n:
            raise WireError("raw key section length mismatch")
        return np.frombuffer(raw, dtype="<u8").astype(np.uint64)
    if tag != _K_DELTA:
        raise WireError(f"unknown key encoding {tag}")
    deltas = unzigzag(
        unpack_uints(np.frombuffer(raw, dtype=np.uint8), n)
    ).view(np.uint64)
    return np.cumsum(deltas, dtype=np.uint64)


def _encode_diffs(diffs: np.ndarray) -> tuple[int, bytes]:
    d = np.ascontiguousarray(diffs, dtype=np.int64)
    n = d.shape[0]
    if n == 0:
        return _D_VARINT, b""
    if bool((d == d[0]).all()):
        return _D_CONST, struct.pack("<q", int(d[0]))
    if bool((np.abs(d) == 1).all()):
        return _D_SIGN, np.packbits(d < 0).tobytes()
    return _D_VARINT, pack_uints(zigzag(d))


def _decode_diffs(tag: int, raw: bytes, n: int) -> np.ndarray:
    if n == 0:
        if raw:
            raise WireError("diff section has trailing bytes")
        return np.empty(0, dtype=np.int64)
    if tag == _D_CONST:
        (value,) = struct.unpack("<q", raw)
        return np.full(n, value, dtype=np.int64)
    if tag == _D_SIGN:
        bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8), count=n)
        return (1 - 2 * bits.astype(np.int64)).astype(np.int64)
    if tag == _D_VARINT:
        return unzigzag(
            unpack_uints(np.frombuffer(raw, dtype=np.uint8), n)
        ).copy()
    raise WireError(f"unknown diff encoding {tag}")


# --- float quantization (opt-in lossy tier) --------------------------------


def _bf16_pack(f32: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation float32 -> bf16 (uint16). NaNs
    keep their exponent and a set mantissa bit so the carry-add cannot
    walk a NaN payload into an infinity or flip its sign."""
    u = np.ascontiguousarray(f32, dtype=np.float32).view(np.uint32)
    rnd = (u >> np.uint32(16)) & np.uint32(1)
    packed = ((u + np.uint32(0x7FFF) + rnd) >> np.uint32(16)).astype(
        np.uint16
    )
    nan = np.isnan(f32)
    if nan.any():
        packed = np.where(
            nan, ((u >> np.uint32(16)) | np.uint32(0x40)).astype(np.uint16),
            packed,
        )
    return packed


def _quantize(arr: np.ndarray, quant: str) -> bytes | None:
    """Quantize a float array (any shape); None means "stay lossless"
    (unknown mode, or int8 asked for non-finite data)."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    if quant == "bf16":
        packed = _bf16_pack(flat.astype(np.float32, copy=False))
        return struct.pack("<B", _Q_BF16) + _dtype_header(arr.dtype) + (
            packed.tobytes()
        )
    if quant == "int8":
        if not bool(np.isfinite(flat).all()):
            return None  # inf/nan cannot ride an absmax scale
        f32 = flat.astype(np.float32, copy=False)
        n = f32.shape[0]
        nblocks = max(1, -(-n // _INT8_BLOCK))
        padded = np.zeros(nblocks * _INT8_BLOCK, dtype=np.float32)
        padded[:n] = f32
        blocks = padded.reshape(nblocks, _INT8_BLOCK)
        scales = np.abs(blocks).max(axis=1) / np.float32(127.0)
        scales[scales == 0] = 1.0
        q = np.clip(
            np.rint(blocks / scales[:, None]), -127, 127
        ).astype(np.int8)
        return (
            struct.pack("<B", _Q_INT8)
            + _dtype_header(arr.dtype)
            + struct.pack("<QI", n, nblocks)
            + scales.astype("<f4").tobytes()
            + q.reshape(-1)[:n].tobytes()
        )
    return None


def _dequantize(raw: memoryview) -> np.ndarray:
    """Inverse of :func:`_quantize`; returns a flat array in the
    original dtype."""
    (qkind,) = struct.unpack_from("<B", raw, 0)
    dtype, off = _read_dtype(raw, 1)
    if qkind == _Q_BF16:
        u16 = np.frombuffer(raw[off:], dtype="<u2").astype(np.uint32)
        return (u16 << np.uint32(16)).view(np.float32).astype(dtype)
    if qkind == _Q_INT8:
        n, nblocks = struct.unpack_from("<QI", raw, off)
        off += 12
        scales = np.frombuffer(
            raw[off : off + 4 * nblocks], dtype="<f4"
        ).astype(np.float32)
        off += 4 * nblocks
        q = np.frombuffer(raw[off:], dtype=np.int8)
        if q.shape[0] != n:
            raise WireError("int8 section length mismatch")
        padded = np.zeros(nblocks * _INT8_BLOCK, dtype=np.float32)
        padded[:n] = q.astype(np.float32)
        out = (padded.reshape(nblocks, _INT8_BLOCK) * scales[:, None]).reshape(
            -1
        )[:n]
        return out.astype(dtype)
    raise WireError(f"unknown quantization kind {qkind}")


def _quantizable(dtype: np.dtype) -> bool:
    return dtype.kind == "f" and dtype.itemsize >= 4


# --- column encoders -------------------------------------------------------


def _dtype_header(dtype: np.dtype) -> bytes:
    ds = np.dtype(dtype).str.encode("ascii")
    return struct.pack("<H", len(ds)) + ds


def _read_dtype(raw: memoryview, off: int) -> tuple[np.dtype, int]:
    (dlen,) = struct.unpack_from("<H", raw, off)
    off += 2
    dtype = np.dtype(bytes(raw[off : off + dlen]).decode("ascii"))
    return dtype, off + dlen


def _shape_header(shape: tuple[int, ...]) -> bytes:
    return struct.pack("<B", len(shape)) + b"".join(
        struct.pack("<I", dim) for dim in shape
    )


def _read_shape(raw: memoryview, off: int) -> tuple[tuple[int, ...], int]:
    (ndim,) = struct.unpack_from("<B", raw, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}I", raw, off) if ndim else ()
    return tuple(shape), off + 4 * ndim


def _encode_column(col: np.ndarray, quant: str | None) -> tuple[int, bytes]:
    if col.dtype != object:
        arr = np.ascontiguousarray(col)
        if quant and _quantizable(arr.dtype):
            qp = _quantize(arr, quant)
            if qp is not None:
                return _C_QUANT, qp
        if arr.dtype.kind in "iu" and arr.dtype.itemsize >= 2:
            z = (
                zigzag(arr.astype(np.int64, copy=False))
                if arr.dtype.kind == "i"
                else arr.astype(np.uint64, copy=False)
            )
            enc = pack_uints(z, max_bytes=arr.nbytes - 1)
            if enc is not None:
                return _C_INTV, _dtype_header(arr.dtype) + enc
        return _C_RAW, _dtype_header(arr.dtype) + arr.tobytes()
    spec = uniform_element_spec(col)
    if spec is not None:
        edtype, shape = spec
        stacked = np.ascontiguousarray(
            np.stack(col.tolist()), dtype=edtype
        )
        header = _shape_header(shape)
        if quant and _quantizable(stacked.dtype):
            qp = _quantize(stacked, quant)
            if qp is not None:
                return _C_STACK_QUANT, header + qp
        return _C_STACK, header + _dtype_header(edtype) + stacked.tobytes()
    return _C_PKL, _pickle.dumps(col, protocol=pickle.HIGHEST_PROTOCOL)


def _rows_to_object(stacked: np.ndarray) -> np.ndarray:
    out = np.empty(stacked.shape[0], dtype=object)
    for i in range(stacked.shape[0]):
        out[i] = stacked[i]
    return out


def _decode_column(tag: int, raw: memoryview, n: int) -> np.ndarray:
    if tag == _C_RAW:
        dtype, off = _read_dtype(raw, 0)
        arr = np.frombuffer(raw[off:], dtype=dtype)
        if arr.shape[0] != n:
            raise WireError("raw column length mismatch")
        return arr.copy()  # decoded batches must be writable
    if tag == _C_PKL:
        col = _pickle.loads(raw)
        if len(col) != n:
            raise WireError("pickled column length mismatch")
        return col
    if tag == _C_STACK:
        shape, off = _read_shape(raw, 0)
        dtype, off = _read_dtype(raw, off)
        flat = np.frombuffer(raw[off:], dtype=dtype)
        return _rows_to_object(flat.reshape((n,) + shape).copy())
    if tag == _C_INTV:
        dtype, off = _read_dtype(raw, 0)
        z = unpack_uints(np.frombuffer(raw[off:], dtype=np.uint8), n)
        vals = unzigzag(z) if dtype.kind == "i" else z
        return vals.astype(dtype)
    if tag == _C_QUANT:
        out = _dequantize(raw)
        if out.shape[0] != n:
            raise WireError("quantized column length mismatch")
        return out
    if tag == _C_STACK_QUANT:
        shape, off = _read_shape(raw, 0)
        flat = _dequantize(raw[off:])
        return _rows_to_object(flat.reshape((n,) + shape))
    raise WireError(f"unknown column encoding {tag}")


# --- batch / frame encoding ------------------------------------------------


def _encode_batch(b: DiffBatch, quant: str | None, out: list[bytes]) -> int:
    """Append one batch's sections to ``out``; returns the batch's
    dense in-memory byte size (typed columns at full width, object
    columns at their wire size) for the compression-ratio gauge."""
    n = len(b)
    cols = b.columns
    out.append(struct.pack("<IH", n, len(cols)))
    ktag, kraw = _encode_keys(b.keys)
    out.append(struct.pack("<BI", ktag, len(kraw)))
    out.append(kraw)
    dtag, draw = _encode_diffs(b.diffs)
    out.append(struct.pack("<BI", dtag, len(draw)))
    out.append(draw)
    raw_bytes = 16 * n  # uint64 keys + int64 diffs at full width
    for name, col in cols.items():
        nb = name.encode("utf-8")
        ctag, craw = _encode_column(col, quant)
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        out.append(struct.pack("<BI", ctag, len(craw)))
        out.append(craw)
        raw_bytes += _column_raw_nbytes(col, ctag, len(craw))
    return raw_bytes


def _column_raw_nbytes(col: np.ndarray, ctag: int, wire_len: int) -> int:
    if col.dtype != object:
        return col.nbytes
    if ctag in (_C_STACK, _C_STACK_QUANT) and len(col):
        return int(col[0].nbytes) * len(col)
    # mixed/ragged object columns ship as pickle either way: count their
    # wire size so the ratio reflects savings on the typed parts only
    return wire_len


def _decode_batch(raw: memoryview, off: int) -> tuple[DiffBatch, int]:
    n, ncols = struct.unpack_from("<IH", raw, off)
    off += 6
    ktag, klen = struct.unpack_from("<BI", raw, off)
    off += 5
    keys = _decode_keys(ktag, bytes(raw[off : off + klen]), n)
    off += klen
    dtag, dlen = struct.unpack_from("<BI", raw, off)
    off += 5
    diffs = _decode_diffs(dtag, bytes(raw[off : off + dlen]), n)
    off += dlen
    columns: dict[str, np.ndarray] = {}
    for _ in range(ncols):
        (nlen,) = struct.unpack_from("<H", raw, off)
        off += 2
        name = bytes(raw[off : off + nlen]).decode("utf-8")
        off += nlen
        ctag, clen = struct.unpack_from("<BI", raw, off)
        off += 5
        columns[name] = _decode_column(ctag, raw[off : off + clen], n)
        off += clen
    return DiffBatch(keys, diffs, columns), off


def is_batch_list(payload: Any) -> bool:
    return isinstance(payload, list) and all(
        isinstance(b, DiffBatch) for b in payload
    )


def encode_frame(
    frame: tuple, wire: str = "codec", quant: str | None = None
) -> tuple[bytes, dict | None]:
    """Encode one mesh frame into a tagged body. Data frames whose
    payload is a list of DiffBatches take the columnar path when
    ``wire == "codec"``; everything else (barriers, scalar exchanges,
    ``wire == "pickle"``) stays a whole-frame pickle. Returns
    ``(body, stats)`` where stats (codec frames only) carries
    ``raw_bytes``/``rows`` for the compression-ratio gauge."""
    if wire == "codec" and frame[0] == "data" and is_batch_list(frame[4]):
        _kind, src, channel, tick, batches, tp = frame
        chan = channel.encode("utf-8")
        tpb = tp.encode("utf-8") if tp is not None else None
        parts: list[bytes] = [
            FRAME_CODEC,
            struct.pack("<Biq", _CODEC_VERSION, src, tick),
            struct.pack("<H", len(chan)),
            chan,
            struct.pack("<B", 1 if tpb is not None else 0),
        ]
        if tpb is not None:
            parts.append(struct.pack("<H", len(tpb)))
            parts.append(tpb)
        parts.append(struct.pack("<H", len(batches)))
        raw_bytes = 0
        rows = 0
        for b in batches:
            raw_bytes += _encode_batch(b, quant, parts)
            rows += len(b)
        return b"".join(parts), {"raw_bytes": raw_bytes, "rows": rows}
    return (
        FRAME_PICKLE
        + _pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL),
        None,
    )


def tap_frame(channel: str, wire_bytes: int, stats: dict | None) -> None:
    """Report one encoded data frame to Tick Scope's per-channel byte
    ledger (observability/tickscope.py). Callers (the mesh sender loop,
    replication shippers) pass the encoded body length plus the codec
    stats from :func:`encode_frame`; pickle frames carry no row count.
    Best-effort — accounting must never fail a send."""
    try:
        from pathway_tpu_torch.observability import tickscope

        tickscope.wire_tap(
            channel,
            wire_bytes,
            raw_bytes=(stats or {}).get("raw_bytes", 0),
            rows=(stats or {}).get("rows", 0),
        )
    except Exception:  # pragma: no cover - defensive
        pass


def decode_frame(body: bytes) -> tuple:
    """Inverse of :func:`encode_frame`; returns the mesh frame tuple."""
    tag = body[:1]
    if tag == FRAME_PICKLE:
        return _pickle.loads(memoryview(body)[1:])
    if tag != FRAME_CODEC:
        raise WireError(f"unknown frame tag {tag!r}")
    raw = memoryview(body)
    version, src, tick = struct.unpack_from("<Biq", raw, 1)
    if version != _CODEC_VERSION:
        raise WireError(f"unsupported codec version {version}")
    off = 1 + struct.calcsize("<Biq")
    (clen,) = struct.unpack_from("<H", raw, off)
    off += 2
    channel = bytes(raw[off : off + clen]).decode("utf-8")
    off += clen
    (tp_flag,) = struct.unpack_from("<B", raw, off)
    off += 1
    tp = None
    if tp_flag:
        (tlen,) = struct.unpack_from("<H", raw, off)
        off += 2
        tp = bytes(raw[off : off + tlen]).decode("utf-8")
        off += tlen
    (nbatches,) = struct.unpack_from("<H", raw, off)
    off += 2
    batches: list[DiffBatch] = []
    for _ in range(nbatches):
        b, off = _decode_batch(raw, off)
        batches.append(b)
    if off != len(body):
        raise WireError("trailing bytes after last batch")
    return ("data", src, channel, tick, batches, tp)


def batches_equal(a: Sequence[DiffBatch], b: Sequence[DiffBatch]) -> bool:
    """Bit-exact comparison helper for differential tests: same batch
    count, keys, diffs, column names, dtypes and values."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (
            not np.array_equal(x.keys, y.keys)
            or not np.array_equal(x.diffs, y.diffs)
            or x.column_names != y.column_names
        ):
            return False
        for name in x.column_names:
            cx, cy = x.columns[name], y.columns[name]
            if cx.dtype != cy.dtype:
                return False
            if cx.dtype == object:
                from pathway_tpu_torch.engine.batch import _values_eq

                if not _values_eq(tuple(cx), tuple(cy)):
                    return False
            elif not np.array_equal(
                cx, cy, equal_nan=cx.dtype.kind in "fc"
            ):
                return False
    return True
