"""Exact cosine scoring and top-k in plain PyTorch.

``precision="float32"`` scores in float32 with TF32 off (the reference);
``"tf32"`` rounds both operands to TF32's 10-bit mantissa first (the
control's step below float32); ``"float64"`` scores exactly, to judge an
index on the embeddings it was handed."""

from __future__ import annotations

import torch

from benchmarks.reference.encoder import no_tf32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest value with a 10-bit mantissa (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def scores(q: torch.Tensor, corpus: torch.Tensor, precision: str = "float32",
           corpus_is_unit: bool = False) -> torch.Tensor:
    """[M, D] x [N, D] -> [M, N] cosine similarities."""
    dt = torch.float64 if precision == "float64" else torch.float32
    q, c = unit(q.to(dt)), corpus.to(dt) if corpus_is_unit else unit(corpus.to(dt))
    if precision == "tf32":
        q, c = tf32_round(q), tf32_round(c)
    with no_tf32():
        return q @ c.T
