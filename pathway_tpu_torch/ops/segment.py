"""Segment reductions on the device — counterpart of
``pathway_tpu/ops/segment.py`` (vectorized groupby reductions for the
dense-numeric case), as ``scatter_add_`` / ``scatter_reduce_``.

``jax.ops.segment_*`` semantics, kept here:

* ids outside ``[0, num_segments)`` (negative ones too) are dropped: they
  land in one spare segment past the end, which the result leaves out, so
  no call syncs with the host;
* an empty segment holds the reduction's identity: 0 for the sum and the
  count, −inf / +inf for a float max / min, the dtype's min / max for an
  int max / min;
* ``segment_mean`` is ``sum / max(count, 1)`` (an int mean is f32, as JAX's
  true division of int32 gives without x64).

``values`` may carry trailing dimensions; segments run along dim 0. The
output lives on ``values``'s device.
"""

from __future__ import annotations

import torch


def _index(segment_ids: torch.Tensor, num_segments: int, like: torch.Tensor) -> torch.Tensor:
    """int64 ids with every out-of-range id sent to the spare segment
    ``num_segments``, broadcast to ``like``'s shape for the scatter."""
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    return ids.reshape(-1, *([1] * (like.dim() - 1))).expand_as(like)


def _scatter(values, segment_ids, num_segments: int, fill, reduce: str) -> torch.Tensor:
    out = torch.full(
        (num_segments + 1, *values.shape[1:]), fill, dtype=values.dtype, device=values.device
    )
    idx = _index(segment_ids, num_segments, values)
    if reduce == "sum":
        out.scatter_add_(0, idx, values)
    else:
        out.scatter_reduce_(0, idx, values, reduce, include_self=True)
    return out[:num_segments]


def _identity(dtype: torch.dtype, reduce: str):
    largest = reduce == "amin"
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _scatter(values, segment_ids, num_segments, 0, "sum")


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.int32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    s = segment_sum(values, segment_ids, num_segments)
    c = segment_sum(torch.ones_like(values), segment_ids, num_segments)
    if not s.is_floating_point():
        s, c = s.to(torch.float32), c.to(torch.float32)
    return s / torch.clamp(c, min=1)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _scatter(values, segment_ids, num_segments, _identity(values.dtype, "amax"), "amax")


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _scatter(values, segment_ids, num_segments, _identity(values.dtype, "amin"), "amin")
