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
``sum_b seq_lens[b] * H * Dp * 8`` bytes; at the decoder's serving default
(B = 8, H = 4, Dp = 128, ~200-token contexts) about 6.5 MB, ~2 us at the
H100 SXM data-sheet 3.35 TB/s, so a decode step is bound by launches and host
work rather than by this kernel. See the source note in
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

_lib: ctypes.CDLL | None = None


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
        lib.pathway_paged_attention.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.pathway_paged_attention.restype = ctypes.c_int
        lib.pathway_paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.pathway_paged_attention_error_string.restype = ctypes.c_char_p
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
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pathway_paged_attention(
            q.data_ptr(),
            k_pool.data_ptr(),
            v_pool.data_ptr(),
            page_tables.data_ptr(),
            seq_lens.data_ptr(),
            out.data_ptr(),
            b,
            h,
            p,
            dp,
            n_pages,
            page_tables.shape[1],
            float(sm_scale),
            stream,
        )
    if err != 0:
        msg = lib.pathway_paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention launch failed: cudaError {err} ({msg})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
