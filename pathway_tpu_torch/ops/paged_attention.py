"""Ragged paged-attention decode step: the hand-written CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterpart of ``pathway_tpu/ops/paged_attention.py``: ``paged_attention``
replaces the Pallas TPU kernel ``_decode_kernel`` (launched by JAX's
``paged_attention``), ``paged_attention_ref`` is the torch port of JAX's
``paged_attention_ref``. For each sequence b one query token ``q[b]``
(``[H, Dp]``) attends over the sequence's first ``seq_lens[b]`` cached
tokens; token t lives at physical page ``page_tables[b, t // P]``, slot
``t % P`` of the pools ``[n_pages, H, P, Dp]``. Masked scores take the finite
value ``_NEG`` (never -inf), masked weights are hard-zeroed, and a row with no
live token (``seq_lens[b] <= 0``, a padded batch slot) comes back exactly 0.
Scores run over all ``Dp`` lanes, pad lanes included, as the reference does.

The pool layout stays ``[n_pages, H, P, Dp]`` with ``Dp = lane_pad(head_dim)``
so pools carry across the two packages byte for byte. The Mosaic layout gates
(``validate_lowering``) are TPU rules and are not carried over.

Bound on the card: memory. One step reads each live token's K and V row once,
``sum_b seq_lens[b] * H * Dp * 8`` bytes; at the generation phase's recorded
step (B = 8 bucket, six 150-token sequences, H = 4, Dp = 128) about 3.7 MB,
~1.1 us at the H100 SXM data-sheet 3.35 TB/s. The kernel splits each
sequence's pages across ``S`` blocks (split-K over the token axis) and the
last split of a (b, h) merges the partials in the same launch; ``S`` comes
from :func:`split_count`, from static facts only, so choosing it never
reads ``seq_lens`` back to the host. See the source note in
``csrc/paged_attention.cu`` for the design.

On a CUDA tensor ``paged_attention`` launches the kernel or raises; it uses
the plain version only when it is handed CPU tensors (the CPU tests).
``paged_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LANE = 128
# mask value for invalid key positions: large-negative finite (an -inf mask
# makes the online-softmax rescale NaN on fully-masked pages)
_NEG = -0.7 * float(torch.finfo(torch.float32).max)
# pool lane widths the kernel is built for (Dp = 128 * NC, NC = 1..4)
KERNEL_DP = (128, 256, 384, 512)

# warps per block of the kernel (csrc/paged_attention.cu)
_WARPS = 8

_lib: ctypes.CDLL | None = None
# zeroed per-(b, h) arrival counters, one buffer per (device, stream); the
# kernel's last split resets every count it used back to 0
_counters: dict[tuple[int, int], torch.Tensor] = {}
_sms: dict[int, int] = {}


def _chunk_tokens(dp: int) -> int:
    """Tokens per warp chunk in the kernel: 8 rows of 128 lanes per warp."""
    return max(1, 8 // (dp // LANE))


def split_count(bh: int, max_pages: int, page_size: int, dp: int, sms: int) -> int:
    """Blocks per (b, h) sequence-head: enough for ``bh * S`` to reach the
    card's ``sms`` streaming multiprocessors, while every block keeps at
    least one chunk round (a chunk per warp) and every split owns at least
    one page. 1 when ``bh`` alone fills the card. Static facts only:
    ``seq_lens`` is never read."""
    if bh >= sms:
        return 1
    min_tokens = _WARPS * _chunk_tokens(dp)
    s = min(-(-sms // bh), max(1, max_pages * page_size // min_tokens), max_pages)
    pps = -(-max_pages // s)  # pages per split
    return -(-max_pages // pps)


def lane_pad(d: int) -> int:
    """``d`` padded up to a multiple of 128 lanes (the head_dim pool width)."""
    return -(-int(d) // LANE) * LANE


def paged_attention_ref(
    q: torch.Tensor,  # [B, H, Dp]
    k_pool: torch.Tensor,  # [n_pages, H, P, Dp]
    v_pool: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B]
    *,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Plain version: gather each sequence's pages dense and run a masked
    softmax. Page ids are clamped into the pool, as the kernel clamps them
    (and as JAX's gather clamps out-of-range indices)."""
    b, h, dp = q.shape
    n_pages, _h, p, _dp = k_pool.shape
    max_pages = page_tables.shape[1]
    pt = page_tables.long().clamp(0, n_pages - 1)
    k = k_pool[pt].permute(0, 2, 1, 3, 4).reshape(b, h, max_pages * p, dp)
    v = v_pool[pt].permute(0, 2, 1, 3, 4).reshape(b, h, max_pages * p, dp)
    s = torch.einsum("bhd,bhld->bhl", q.float(), k.float()) * sm_scale
    pos = torch.arange(max_pages * p, dtype=torch.int32, device=q.device)
    mask = pos[None, None, :] < seq_lens.to(torch.int32)[:, None, None]
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - m) * mask  # hard-zero the masked tail
    l = w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhl,bhld->bhd", w, v.float()) / torch.clamp(l, min=1e-30)
    return torch.where(l > 0.0, out, 0.0)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pathway_tpu_torch._build import library

        lib = library("paged_attention")
        lib.pathway_paged_attention.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.pathway_paged_attention.restype = ctypes.c_int
        lib.pathway_paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.pathway_paged_attention_error_string.restype = ctypes.c_char_p
        lib.pathway_paged_attention_last_launch.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.pathway_paged_attention_last_launch.restype = None
        _lib = lib
    return _lib


def _check(q, k_pool, v_pool, page_tables, seq_lens) -> None:
    tensors = (q, k_pool, v_pool, page_tables, seq_lens)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, pools, page_tables and seq_lens must be on one device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.float32):
        raise TypeError(
            f"q and the pools must be float32, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}"
        )
    if page_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(
            f"page_tables and seq_lens must be int32, got {page_tables.dtype}, {seq_lens.dtype}"
        )
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
            f"v_pool {tuple(v_pool.shape)}"
        )
    b, h, dp = q.shape
    n_pages, hp, p, dpp = k_pool.shape
    if (hp, dpp) != (h, dp) or n_pages < 1 or p < 1:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not fit q {tuple(q.shape)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != b or page_tables.shape[1] < 1:
        raise ValueError(f"page_tables must be [{b}, max_pages], got {tuple(page_tables.shape)}")
    if seq_lens.shape != (b,):
        raise ValueError(f"seq_lens must be [{b}], got {tuple(seq_lens.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, pools, page_tables and seq_lens must be contiguous")


def paged_attention(
    q: torch.Tensor,  # [B, H, Dp] f32 query tokens
    k_pool: torch.Tensor,  # [n_pages, H, P, Dp] f32
    v_pool: torch.Tensor,  # [n_pages, H, P, Dp] f32
    page_tables: torch.Tensor,  # [B, max_pages] int32 physical page ids
    seq_lens: torch.Tensor,  # [B] int32 valid tokens per sequence
    *,
    sm_scale: float,
) -> torch.Tensor:
    """One ragged paged-attention decode step: ``[B, H, Dp]`` f32 outputs."""
    _check(q, k_pool, v_pool, page_tables, seq_lens)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_tables, seq_lens, sm_scale=sm_scale)
    b, h, dp = q.shape
    n_pages, _h, p, _dp = k_pool.shape
    if dp not in KERNEL_DP:
        raise ValueError(f"the kernel takes Dp in {KERNEL_DP} (lane_pad(head_dim)), got {dp}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    max_pages = page_tables.shape[1]
    sms = _sm_count(q.device)
    splits = split_count(b * h, max_pages, p, dp, sms)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = counters = None
        if splits > 1:
            part = torch.empty((b, h, splits, dp + 2), dtype=torch.float32, device=q.device)
            counters = _counter_buffer(q.device, stream, b * h)
        err = lib.pathway_paged_attention(
            q.data_ptr(),
            k_pool.data_ptr(),
            v_pool.data_ptr(),
            page_tables.data_ptr(),
            seq_lens.data_ptr(),
            out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b,
            h,
            p,
            dp,
            n_pages,
            max_pages,
            splits,
            float(sm_scale),
            stream,
        )
    if err != 0:
        msg = lib.pathway_paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention launch failed: cudaError {err} ({msg})")
    paged_attention.launches += 1
    return out


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _counter_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on ``stream``."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


paged_attention.launches = 0


def last_launch() -> dict:
    """The configuration of the built kernel's last launch in this process,
    as its launch code set it: ``smem_bytes`` (dynamic shared memory per
    block), ``threads`` per block and ``grid`` [x, y, z] — what the launch
    ledger (``analysis/lowering.py``) must predict. Loads (and if need be
    builds) the kernel; zeros before any launch."""
    out = (ctypes.c_longlong * 5)()
    _library().pathway_paged_attention_last_launch(out)
    return {"smem_bytes": out[0], "threads": out[1], "grid": list(out[2:])}
