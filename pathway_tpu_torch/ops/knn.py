"""Dense top-k KNN on PyTorch — counterpart of ``pathway_tpu/ops/knn.py``.

Same functions and the same arithmetic as the JAX module (``_scores``,
``_masked_topk``, ``dense_topk``, ``prepare_corpus``,
``dense_topk_prepared``, ``cosine_topk``, ``DeviceCorpus``); the
multi-device ``sharded_topk`` is not ported yet.

Tie order: ``lax.top_k`` puts the lower index first on equal scores and
``torch.topk`` leaves tie order unspecified, so every top-k here is a
``torch.sort(..., descending=True, stable=True)``, which keeps the lower
index first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.observability.tracing import get_tracer

BLK = 1024


@dataclass(frozen=True)
class KnnParams:
    metric: str = "cosine"  # cosine | dot | l2sq
    bf16: bool = True


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-30)


def _dots(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q @ c.T with f32 accumulation (bf16 products are exact in f32)."""
    return q.float() @ c.float().T


def _scores(
    queries: torch.Tensor, corpus: torch.Tensor, metric: str, bf16: bool
) -> torch.Tensor:
    if metric == "cosine":
        qn, cn = _normalize(queries), _normalize(corpus)
    else:
        qn, cn = queries, corpus
    if bf16:
        qn, cn = qn.bfloat16(), cn.bfloat16()
    dots = _dots(qn, cn)
    if metric == "l2sq":
        q2 = (queries.float() ** 2).sum(-1, keepdim=True)
        c2 = (corpus.float() ** 2).sum(-1)
        # negative squared distance so that bigger == closer
        return -(q2 - 2.0 * dots + c2[None, :])
    return dots


def stable_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, highest first, lowest index first on ties
    (the ``lax.top_k`` order)."""
    sc, ix = torch.sort(s, dim=-1, descending=True, stable=True)
    return sc[..., :k], ix[..., :k]


def _masked_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over [B, N] scores; two-stage block decomposition for
    large N (top-k per 1024-column block, then over the block winners),
    exact because every global top-k element is in its block's top-k."""
    n = s.shape[-1]
    if n >= 64 * BLK and k <= BLK:
        nblk = -(-n // BLK)
        pad = nblk * BLK - n
        if pad:
            s = torch.nn.functional.pad(s, (0, pad), value=-float("inf"))
        b = s.shape[0]
        sc1, ix1 = stable_topk(s.reshape(b, nblk, BLK), k)  # [B, nblk, k]
        gidx = ix1 + (torch.arange(nblk, device=s.device) * BLK)[None, :, None]
        sc2, pos = stable_topk(sc1.reshape(b, -1), k)
        idx = torch.gather(gidx.reshape(b, -1), 1, pos)
        return sc2, idx
    return stable_topk(s, k)


def _finish(s: torch.Tensor, valid: torch.Tensor, k: int):
    s = torch.where(valid[None, :], s, -float("inf"))
    scores, idx = _masked_topk(s, k)
    idx = torch.where(torch.isfinite(scores), idx, -1).to(torch.int32)
    return scores, idx


def dense_topk(
    queries: torch.Tensor,  # [B, D] f32
    corpus: torch.Tensor,  # [N, D] f32 (padded)
    valid: torch.Tensor,  # [N] bool
    k: int,
    metric: str = "cosine",
    bf16: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [B, k] f32, indices [B, k] i32); invalid rows get
    -inf scores and index -1."""
    return _finish(_scores(queries, corpus, metric, bf16), valid, k)


# --- prepared-corpus fast path ---------------------------------------------
# Normalization + cast of the corpus is O(N*D): done once per corpus change,
# not per query.


def prepare_corpus(corpus: torch.Tensor, metric: str, bf16: bool = True):
    """Returns (prep [N,D], c2 [N]): prep is normalized (cosine) and cast;
    c2 is the squared-norm column needed by l2sq."""
    c2 = (corpus.float() ** 2).sum(-1)
    prep = _normalize(corpus) if metric == "cosine" else corpus
    if bf16:
        prep = prep.bfloat16()
    return prep, c2


def dense_topk_prepared(
    queries: torch.Tensor,  # [B, D] f32
    prep: torch.Tensor,  # [N, D] prepared (normalized/cast)
    c2: torch.Tensor,  # [N] squared norms (l2sq only)
    valid: torch.Tensor,  # [N] bool
    k: int,
    metric: str = "cosine",
    bf16: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    q = _normalize(queries) if metric == "cosine" else queries
    if bf16:
        q = q.bfloat16()
    dots = _dots(q, prep)
    if metric == "l2sq":
        q2 = (queries.float() ** 2).sum(-1, keepdim=True)
        s = -(q2 - 2.0 * dots + c2[None, :])
    else:
        s = dots
    return _finish(s, valid, k)


def cosine_topk(queries, corpus, valid, k):
    return dense_topk(queries, corpus, valid, k, metric="cosine")


def shard_base_indices(n: int, n_shards: int) -> np.ndarray:
    """Per-row base offset of its shard (local->global index mapping in a
    sharded merge)."""
    per = n // n_shards
    return (np.arange(n) // per * per).astype(np.int32)


class DeviceCorpus:
    """Growable padded corpus living on the device.

    The host keeps a float32 mirror; the device tensor is refreshed lazily
    (one host→device copy per change, amortized over all queries until the
    next change). Capacity is a multiple of 1024, so the block kernel
    (ops/block_topk.py) always applies, and doubles when full."""

    def __init__(
        self,
        dim: int,
        capacity: int = 1024,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.capacity = -(-max(BLK, capacity) // BLK) * BLK
        self.host = np.zeros((self.capacity, dim), dtype=np.float32)
        self.valid_host = np.zeros(self.capacity, dtype=bool)
        self.free: list[int] = list(range(self.capacity - 1, -1, -1))
        self.slot_of: dict[int, int] = {}  # row key -> slot
        self.key_of: dict[int, int] = {}  # slot -> row key
        self._dirty = True
        self._device: torch.Tensor | None = None
        self._device_valid: torch.Tensor | None = None
        self._prepared: dict[tuple[str, bool], tuple[torch.Tensor, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self.slot_of)

    def upsert(self, key: int, vector: np.ndarray) -> None:
        slot = self.slot_of.get(key)
        if slot is None:
            if not self.free:
                self._grow()
            slot = self.free.pop()
            self.slot_of[key] = slot
            self.key_of[slot] = key
        self.host[slot] = vector
        self.valid_host[slot] = True
        self._dirty = True

    def remove(self, key: int) -> None:
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        self.key_of.pop(slot, None)
        self.valid_host[slot] = False
        self.free.append(slot)
        self._dirty = True

    def _grow(self) -> None:
        old_cap = self.capacity
        self.capacity *= 2
        host = np.zeros((self.capacity, self.dim), dtype=np.float32)
        host[:old_cap] = self.host
        self.host = host
        valid = np.zeros(self.capacity, dtype=bool)
        valid[:old_cap] = self.valid_host
        self.valid_host = valid
        self.free.extend(range(self.capacity - 1, old_cap - 1, -1))
        self._dirty = True

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._dirty or self._device is None:
            # the whole corpus goes up again after any change: the span
            # times that re-upload as the caller's thread waits for it
            with get_tracer().span(
                "knn.corpus_upload", bytes=self.host.nbytes + self.valid_host.nbytes
            ):
                # drop the old copies first so a re-upload never holds two
                self._device = self._device_valid = None
                self._prepared.clear()
                self._device = torch.from_numpy(self.host).to(self.device)
                self._device_valid = torch.from_numpy(self.valid_host).to(self.device)
            self._dirty = False
        return self._device, self._device_valid

    def prepared_arrays(
        self, metric: str, bf16: bool = True
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(prep, c2, valid) with normalization/cast amortized across
        queries — refreshed only when the corpus changed."""
        device, valid = self.device_arrays()
        key = (metric, bf16)
        if key not in self._prepared:
            self._prepared[key] = prepare_corpus(device, metric, bf16)
        prep, c2 = self._prepared[key]
        return prep, c2, valid

    def keys_for_slots(self, slots: np.ndarray) -> list[int | None]:
        return [self.key_of.get(int(s)) if s >= 0 else None for s in slots]
