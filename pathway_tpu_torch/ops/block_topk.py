"""Fused KNN scoring + block-local top-k: the hand-written CUDA kernel
``csrc/block_topk.cu`` and its plain PyTorch version.

Counterpart of ``pathway_tpu/ops/pallas_topk.py``: ``block_topk`` replaces
``pallas_block_topk`` (the Pallas kernel ``_topk_block_kernel``),
``dense_topk_kernel`` replaces ``pallas_dense_topk``. For each 1024-row
corpus block the kernel scores the [B, D] queries against the block's rows
(f32 accumulation), masks invalid rows to -inf and keeps the block's top-k,
highest score first and lowest column first on ties, so only [B, N/1024, k]
candidates reach device memory instead of the [B, N] score matrix. The TPU
layout (128-lane ``KP`` padding, the Mosaic lowering gates) is not carried
over.

Bound on the card: memory — one search reads the whole [N, D] corpus once
(1.61 GB at N = 1,048,576, D = 384, f32; about 0.48 ms at the H100 SXM
data-sheet 3.35 TB/s, for B = 1, 16 and 32 alike). Persistent thread
blocks score up to 32 queries against the corpus from register
micro-tiles while a producer warp streams it through a TMA ring, and
select incrementally, so B <= 32 reads the corpus once; see the source note
in ``csrc/block_topk.cu``.

On a CUDA tensor ``block_topk`` launches the kernel or raises; it uses the
plain version ``block_topk_ref`` only when it is handed CPU tensors (the CPU
tests). ``block_topk.launches`` counts kernel launches, and
``block_topk.shapes`` counts them per ``(B, k)``.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from pathway_tpu_torch.ops.knn import BLK, _normalize, stable_topk

# dynamic shared memory a block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448
# the kernel's tile constants (csrc/block_topk.cu): a ring of 4 stages of
# [256 rows x 128 bytes] (aligned to 1 KB for the TMA swizzle), a 16 KB
# buffer for merging the per-warp lists and 8 mbarriers
_STAGES, _ROWS, _CHUNK_BYTES = 4, 256, 128
_RING_ALIGN, _MERGE_BYTES, _BAR_BYTES = 1024, 16384, 64
# k up to SMALL_K selects from per-warp running lists in registers; a larger
# k keeps all [QT, 1024] keys in shared memory
_SMALL_K = 32
_QT_MAX = 32
# threads per block: 8 consumer warps and one producer warp
_BLOCK_THREADS = 256 + 32

_lib: ctypes.CDLL | None = None


def supported(n: int, k: int) -> bool:
    return n % BLK == 0 and k <= BLK


def block_topk_ref(
    queries: torch.Tensor, prep: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ([B, nblk, k] f32 scores, [B, nblk, k]
    i32 global indices), a stable descending sort per block."""
    b, n = queries.shape[0], prep.shape[0]
    nblk = n // BLK
    s = queries.float() @ prep.float().T
    s = torch.where(valid[None, :], s, -float("inf"))
    sc, ix = stable_topk(s.reshape(b, nblk, BLK), k)
    base = torch.arange(nblk, device=s.device, dtype=torch.int32) * BLK
    return sc, ix.to(torch.int32) + base[None, :, None]


def _smem_bytes(qt: int, d: int, k: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one thread block: the corpus ring, the merge
    buffer, the [QT, D] f32 query tile (D padded to a whole row chunk) and,
    for k > 32, [QT, 1024] keys."""
    ring = _STAGES * _ROWS * _CHUNK_BYTES
    dk = _CHUNK_BYTES // (2 if bf16 else 4)
    dpad = -(-d // dk) * dk
    keys = qt * BLK * 4 if k > _SMALL_K else 0
    return _RING_ALIGN + ring + _MERGE_BYTES + qt * dpad * 4 + keys + _BAR_BYTES


def _query_tile(b: int, d: int, k: int = 10, bf16: bool = False) -> int:
    """Queries per thread block: the smallest power of two >= B, at most 32,
    halved until the block fits in shared memory."""
    qt = 1
    while qt < min(b, _QT_MAX):
        qt *= 2
    while qt > 1 and _smem_bytes(qt, d, k, bf16) > _SMEM_LIMIT:
        qt //= 2
    if _smem_bytes(qt, d, k, bf16) > _SMEM_LIMIT:
        raise ValueError(f"D={d} is too wide for the block top-k kernel")
    return qt


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pathway_tpu_torch._build import library

        lib = library("block_topk")
        lib.pathway_block_topk.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.pathway_block_topk.restype = ctypes.c_int
        lib.pathway_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pathway_cuda_error_string.restype = ctypes.c_char_p
        lib.pathway_block_topk_last_launch.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.pathway_block_topk_last_launch.restype = None
        _lib = lib
    return _lib


def _check(queries, prep, valid, k) -> None:
    if not (queries.device == prep.device == valid.device):
        raise ValueError("queries, prep and valid must be on one device")
    if queries.dtype not in (torch.float32, torch.bfloat16) or prep.dtype != queries.dtype:
        raise TypeError(
            f"queries and prep must both be float32 or both bfloat16, "
            f"got {queries.dtype} and {prep.dtype}"
        )
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if queries.dim() != 2 or prep.dim() != 2 or queries.shape[1] != prep.shape[1]:
        raise ValueError(f"bad shapes {tuple(queries.shape)} x {tuple(prep.shape)}")
    if valid.shape != (prep.shape[0],):
        raise ValueError(f"valid must be [{prep.shape[0]}], got {tuple(valid.shape)}")
    if not (queries.is_contiguous() and prep.is_contiguous() and valid.is_contiguous()):
        raise ValueError("queries, prep and valid must be contiguous")
    n = prep.shape[0]
    if n == 0 or not supported(n, k) or k < 0:
        raise ValueError(f"need N % {BLK} == 0, N > 0 and 0 <= k <= {BLK}; got N={n}, k={k}")


def block_topk(
    queries: torch.Tensor,  # [B, D] f32 or bf16
    prep: torch.Tensor,  # [N, D] prepared corpus, same dtype, N % 1024 == 0
    valid: torch.Tensor,  # [N] bool
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidates: ([B, nblk, k] f32 scores, [B, nblk, k] i32
    global indices), highest score first, lowest index first on ties."""
    _check(queries, prep, valid, k)
    if queries.device.type == "cpu":
        return block_topk_ref(queries, prep, valid, k)
    b, d = queries.shape
    n = prep.shape[0]
    out_sc = torch.empty((b, n // BLK, k), dtype=torch.float32, device=queries.device)
    out_ix = torch.empty((b, n // BLK, k), dtype=torch.int32, device=queries.device)
    if b == 0 or k == 0:
        return out_sc, out_ix
    lib = _library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pathway_block_topk(
            queries.data_ptr(),
            prep.data_ptr(),
            valid.data_ptr(),
            out_sc.data_ptr(),
            out_ix.data_ptr(),
            b,
            n,
            d,
            k,
            int(prep.dtype == torch.bfloat16),
            _query_tile(b, d, k, prep.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        msg = lib.pathway_cuda_error_string(err).decode()
        raise RuntimeError(f"block_topk launch failed: cudaError {err} ({msg})")
    block_topk.launches += 1
    block_topk.shapes[(b, k)] += 1
    return out_sc, out_ix


block_topk.launches = 0
block_topk.shapes = Counter()


def last_launch() -> dict:
    """The configuration of the built kernel's last launch in this process,
    as its launch code set it: ``smem_bytes`` (dynamic shared memory per
    block, the value passed to ``cudaFuncSetAttribute``), ``threads``
    per block and ``grid`` [x, y, z] — what the launch ledger
    (``analysis/lowering.py``) must predict or bound. Loads (and if need be
    builds) the kernel; zeros before any launch."""
    out = (ctypes.c_longlong * 5)()
    _library().pathway_block_topk_last_launch(out)
    return {"smem_bytes": out[0], "threads": out[1], "grid": list(out[2:])}


def dense_topk_kernel(
    queries: torch.Tensor,  # [B, D] raw f32 queries
    prep: torch.Tensor,  # [N, D] prepared corpus (normalized/cast)
    valid: torch.Tensor,  # [N] bool
    k: int,
    metric: str = "dot",  # dot | cosine
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense top-k: the block kernel, then a stable sort over the
    block-major candidates (lowest global index first on ties); non-finite
    scores map to index -1. Owns the query-side metric handling (normalize,
    then cast to the corpus dtype) so it scores like
    ``dense_topk_prepared``."""
    if metric == "cosine":
        queries = _normalize(queries)
    elif metric != "dot":
        raise ValueError(f"block kernel serves cosine/dot, not {metric!r}")
    sc, ix = block_topk(queries.to(prep.dtype).contiguous(), prep, valid, k)
    b = sc.shape[0]
    scores, pos = stable_topk(sc.reshape(b, -1), k)
    idx = torch.gather(ix.reshape(b, -1), 1, pos)
    idx = torch.where(torch.isfinite(scores), idx, -1)
    return scores, idx
