"""The yardsticks: work the algorithms need, counted from shapes, and the
published peaks of the card. They read the same work whatever implements
it, so a later change to the program cannot move them.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates without sparsity; a card set to a lower ``power.limit`` runs below
them, and every share is printed beside the card's name and limit.
"""

from __future__ import annotations

# device name fragment -> peaks
PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
             "float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of the card whose name contains a known fragment, or None."""
    for frag, peaks in PEAKS.items():
        if frag in device_name:
            return peaks
    return None


def encoder_flops(tokens: int, hidden: int, layers: int, ffn: int) -> float:
    """Forward FLOPs of one sequence of ``tokens`` real (unpadded) tokens
    through the encoder's blocks: per layer the four d x d projections
    (8 n d^2), the feed-forward (4 n d f) and the two attention products
    (4 n^2 d). With f = 4 d this is layers x (24 n d^2 + 4 n^2 d)."""
    n, d = tokens, hidden
    return layers * (8 * n * d * d + 4 * n * d * ffn + 4 * n * n * d)


def scoring_flops(queries: int, rows: int, dim: int) -> float:
    """Exact scoring: one multiply and one add per query, row and dimension."""
    return 2.0 * queries * rows * dim


def block_topk_bytes(b: int, n: int, d: int, k: int, elem_bytes: int) -> int:
    """Bytes one block top-k launch must move: the [B, D] queries, the
    [N, D] corpus and the [N] validity mask read once, the [B, N/1024, k]
    scores (f32) and indices (i32) written once."""
    return b * d * elem_bytes + n * d * elem_bytes + n + b * (n // 1024) * k * 8


def block_topk_bound_s(b: int, n: int, d: int, k: int, dtype: str, peaks: dict) -> float:
    """The least time the card could take for one launch: the larger of
    its FLOPs over the precision's peak and its bytes over HBM bandwidth."""
    elem = 2 if dtype == "bfloat16" else 4
    return max(scoring_flops(b, n, d) / peaks[dtype],
               block_topk_bytes(b, n, d, k, elem) / peaks["hbm_bytes_per_s"])
