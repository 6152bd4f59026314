"""LSH random-projection hashing on the device — counterpart of
``pathway_tpu/ops/lsh.py`` (E2LSH: one projection matmul, then the
AND-combine of the cells into one bucket id per OR-table).

The planes and offsets are the reference's numpy draw, so both packages
hash alike. The AND-combine ``h = h * 1000003 + cell`` wraps in uint32 in
the reference; torch has no uint32 arithmetic, so it runs in int64 masked
to 32 bits (a negative cell enters as its two's-complement uint32, as
``astype(uint32)`` makes it), and the result maps to int32 by subtracting
2³² at ≥ 2³¹. The projection is f32 (TF32 is never switched on here); a
value within rounding of a cell edge may land in the neighbouring cell on
another backend, as between XLA-CPU and cuBLAS.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device

_MIX = 1000003
_MASK = (1 << 32) - 1


def make_projections(
    dim: int,
    n_or: int,
    n_and: int,
    bucket_length: float,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(n_or, n_and, dim)).astype(np.float32)
    offsets = rng.uniform(0, bucket_length, size=(n_or, n_and)).astype(np.float32)
    return torch.from_numpy(planes).to(dev), torch.from_numpy(offsets).to(dev)


def lsh_buckets(vectors: torch.Tensor, planes: torch.Tensor, offsets: torch.Tensor, bucket_length: float):
    """vectors [N, D] -> bucket ids [N, n_or] (int32): the E2LSH cells
    floor((v·a + b) / w), combined over the AND dimension."""
    proj = torch.einsum("nd,oad->noa", vectors.to(torch.float32), planes)
    cells = torch.floor((proj + offsets[None]) / bucket_length).to(torch.int32)
    mix = cells.to(torch.int64) & _MASK
    h = torch.zeros(mix.shape[:2], dtype=torch.int64, device=mix.device)
    for i in range(mix.shape[2]):
        h = (h * _MIX + mix[:, :, i]) & _MASK
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)
