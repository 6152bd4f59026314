"""IVF (inverted-file) KNN — counterpart of ``pathway_tpu/ops/ivf.py``: the
tier past brute force over a device-resident corpus.

Both stages are matmuls on the device:

  1. coarse quantization: rows x centroids^T -> nearest centroid(s)
  2. fine scoring: the probed lists' rows x query -> exact top-k

so a query costs O(C·D + (N/C)·nprobe·D) instead of O(N·D). Training is
Lloyd's k-means over a sample: the same numpy loop as the reference, with
the assignment on the device. Random draws are numpy ``default_rng(seed)``,
as in the reference, so both packages draw the same samples and initial
centroids.

This is plain torch: the JAX package runs it outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.ops.knn import stable_topk

# rows per assignment matmul: bounds the [rows, C] distance block
_ASSIGN_ROWS = 262_144


def _assign_impl(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row by L2: argmin ||c||^2 - 2 x·c (the ||x||^2
    term is the same for every centroid). ``argmin`` takes the first index
    on a tie, as ``jnp.argmin`` does."""
    c32 = centroids.to(torch.float32)
    dots = x.to(torch.float32) @ c32.T
    c2 = torch.sum(c32 * c32, dim=1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=1)


def _assign_rows(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.cat(
        [_assign_impl(x[lo : lo + _ASSIGN_ROWS], c) for lo in range(0, x.shape[0], _ASSIGN_ROWS)]
    )


def assign_clusters(
    x: np.ndarray, centroids: np.ndarray, device: str | torch.device = "cuda"
) -> np.ndarray:
    """Cluster id per row (int64). The reference pads the row count to a
    power of two to bound its jit cache; the ids do not depend on it, and
    here there is no cache to bound."""
    if x.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    ct = torch.from_numpy(np.ascontiguousarray(centroids, dtype=np.float32)).to(dev)
    return _assign_rows(xt, ct).cpu().numpy().astype(np.int64)


def train_centroids(
    sample: np.ndarray,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Lloyd's k-means on a sample: random-subset init, device assignment,
    host segment-sum update (``np.add.at``, the reference's order). Empty
    clusters re-seed from random points."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = sample.shape[0]
    n_clusters = min(n_clusters, n)
    centroids = sample[rng.choice(n, size=n_clusters, replace=False)].astype(np.float32)
    x32 = sample.astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x32)).to(dev)  # uploaded once
    for _ in range(n_iters):
        ct = torch.from_numpy(np.ascontiguousarray(centroids)).to(dev)
        assign = _assign_rows(xt, ct).cpu().numpy().astype(np.int64)
        sums = np.zeros_like(centroids)
        np.add.at(sums, assign, x32)
        counts = np.bincount(assign, minlength=n_clusters).astype(np.float32)
        empty = counts == 0
        counts[empty] = 1.0
        centroids = sums / counts[:, None]
        if empty.any():
            centroids[empty] = sample[rng.choice(n, size=int(empty.sum()), replace=False)]
    return centroids


class IvfDeviceIndex:
    """IVF over a cluster-sorted corpus on ``device``: a probed cluster is one
    contiguous range of rows, so a query gathers its ``n_probe`` ranges,
    pads them to a power-of-two bucket and runs one gather, one
    matrix-vector product and one top-k.

    ``spill`` stores each point in its ``spill`` nearest lists (ScaNN-style
    multi-assignment): boundary points then appear in every nearby probe,
    for ``spill``x the corpus memory. The spill assignment runs on the
    device (the reference's runs in numpy); a point's lists are the same
    set either way, and the cluster-sorted order depends only on that set.
    """

    def __init__(
        self,
        corpus: np.ndarray,
        metric: str = "cosine",
        n_clusters: int | None = None,
        n_probe: int | None = None,
        spill: int = 2,
        train_sample: int = 40000,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cosine", "dot"):
            raise ValueError(f"IvfDeviceIndex: unsupported metric {metric!r}")
        self.device = resolve_device(device)
        n, _dim = corpus.shape
        self.metric = metric
        self.n = n
        self.n_clusters = n_clusters or max(8, int(round((n**0.5) / 8)) * 8)
        self.n_probe = n_probe or max(1, int(round(self.n_clusters**0.5)))
        rng = np.random.default_rng(seed)
        x = corpus.astype(np.float32)
        if metric == "cosine":
            x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-30)
        sample = x[rng.choice(n, size=min(train_sample, n), replace=False)]
        self.centroids = train_centroids(sample, self.n_clusters, seed=seed, device=self.device)
        spill = max(1, min(spill, self.n_clusters))
        self.spill = spill
        # each point -> its `spill` nearest centroids, then the replicated
        # corpus in cluster order (stable: by point within a cluster)
        xt = torch.from_numpy(x).to(self.device)
        ct = torch.from_numpy(self.centroids).to(self.device)
        c2 = torch.sum(ct * ct, dim=1)
        parts = []
        for lo in range(0, n, _ASSIGN_ROWS):
            d = c2[None, :] - 2.0 * (xt[lo : lo + _ASSIGN_ROWS] @ ct.T)
            parts.append(torch.topk(d, spill, dim=1, largest=False).indices)
        flat_assign = torch.cat(parts).reshape(-1)
        point_of = torch.arange(n, device=self.device).repeat_interleave(spill)
        sorted_assign, perm = torch.sort(flat_assign, stable=True)
        order = point_of[perm]
        clusters = torch.arange(self.n_clusters, device=self.device)
        self.starts = torch.searchsorted(sorted_assign, clusters).cpu().numpy().astype(np.int64)
        self.ends = (
            torch.searchsorted(sorted_assign, clusters, right=True).cpu().numpy().astype(np.int64)
        )
        self.order = order.cpu().numpy()
        self.corpus_dev = xt[order].contiguous()
        del xt
        self.cent_dev = ct

    def _fine(self, q: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, k: int):
        """Gather the candidates' rows, score them against ``q``, -inf on
        padding, stable top-k (the lowest candidate position first on a tie,
        as ``lax.top_k``)."""
        rows = torch.index_select(self.corpus_dev, 0, idx)
        scores = torch.where(valid, rows @ q, float("-inf"))
        top_s, top_i = stable_topk(scores, k)
        return top_s, idx[top_i]

    def query(self, q: np.ndarray, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Top-k (scores, original corpus ids) for one query vector."""
        qv = q.astype(np.float32)
        if self.metric == "cosine":
            qv = qv / (np.linalg.norm(qv) + 1e-30)
        d = self.centroids @ qv
        probes = np.argpartition(-d, self.n_probe - 1)[: self.n_probe]
        spans = [(self.starts[c], self.ends[c]) for c in probes.tolist()]
        # dedupe spilled replicas by point id, or duplicates crowd out top-k
        # slots; keep the first sorted position per point
        pos_all = (
            np.concatenate([np.arange(s, e) for s, e in spans]) if spans else np.zeros(0, np.int64)
        )
        pts = self.order[pos_all]
        _uniq, first = np.unique(pts, return_index=True)
        pos_u = pos_all[first]
        total = len(pos_u)
        bucket = 1 << max(1, (total - 1)).bit_length()  # next power of 2
        idx = np.zeros(bucket, np.int64)
        valid = np.zeros(bucket, bool)
        idx[:total] = pos_u
        valid[:total] = True
        kk = min(k, bucket)
        top_s, top_pos = self._fine(
            torch.from_numpy(qv).to(self.device),
            torch.from_numpy(idx).to(self.device),
            torch.from_numpy(valid).to(self.device),
            kk,
        )
        top_s = top_s.cpu().numpy()
        ids = self.order[top_pos.cpu().numpy()]
        live = top_s > -np.inf  # drop padding slots when total < k
        return top_s[live], ids[live]
