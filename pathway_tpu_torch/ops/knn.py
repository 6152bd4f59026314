"""Dense top-k KNN on PyTorch — counterpart of ``pathway_tpu/ops/knn.py``.

Same functions and the same arithmetic as the JAX module (``_scores``,
``_masked_topk``, ``dense_topk``, ``prepare_corpus``,
``dense_topk_prepared``, ``cosine_topk``, ``sharded_topk``,
``DeviceCorpus``).

``sharded_topk`` searches a corpus whose rows are split over a mesh axis
(``parallel/mesh.py``), each shard's slice on its shard's device: a local
top-k per shard, then a merge of the shards' candidates. On the card the
local step of a cosine or dot search is the block top-k kernel
(``ops/block_topk.py`` ``dense_topk_kernel``); ``sharded_topk_ref`` is its
plain version.

Tie order: ``lax.top_k`` puts the lower index first on equal scores and
``torch.topk`` leaves tie order unspecified, so every top-k here is a
``torch.sort(..., descending=True, stable=True)``, which keeps the lower
index first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence

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


def shard_rows(x: Any, mesh: Any, axis: str = "data") -> list[torch.Tensor]:
    """``x`` as one row slice per shard along ``axis``, each on its shard's
    device: a sequence of per-shard tensors is taken as it is; a whole
    [N, ...] array or tensor is cut into ``n_shards`` equal slices."""
    if isinstance(x, (list, tuple)):
        return list(x)
    devices = mesh.shard_devices(axis)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    n = t.shape[0]
    if n % len(devices):
        raise ValueError(f"pad the corpus to a multiple of the shard count ({n} rows, {len(devices)} shards)")
    per = n // len(devices)
    return [t[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(devices)]


def _merge_shards(candidates, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The shards' (scores, global indices) concatenated in shard order on
    ``device``, a stable descending top-k (lower position first on ties,
    as ``lax.top_k`` over the tiled all-gather), non-finite -> -1."""
    sc_all = torch.cat([sc.to(device) for sc, _ix in candidates], dim=1)
    ix_all = torch.cat([ix.to(device) for _sc, ix in candidates], dim=1)
    sc_f, pos = stable_topk(sc_all, k)
    ix_f = torch.gather(ix_all, 1, pos)
    return sc_f, torch.where(torch.isfinite(sc_f), ix_f, -1).to(torch.int32)


def _kernel_local_topk(q, prep, valid, kk: int, metric: str):
    """One shard's top-kk through the block kernel; a slice whose row count
    is not a multiple of 1024 is padded on its device with invalid rows."""
    from pathway_tpu_torch.ops import block_topk as bt

    pad = -prep.shape[0] % BLK
    if pad:
        prep = torch.nn.functional.pad(prep, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    return bt.dense_topk_kernel(q, prep, valid, kk, metric=metric)


def sharded_topk(
    queries: Any,  # [B, D] f32, replicated
    corpus: Any,  # [N, D] f32, or one [N/S, D] slice per shard
    valid: Any,  # [N] bool, or one slice per shard
    k: int,
    *,
    mesh: Any,
    axis: str = "data",
    metric: str = "cosine",
    bf16: bool = True,
    prepared: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-device KNN: the corpus's rows split over ``axis``, each shard's
    slice on its shard's device, the queries replicated. Each shard scores
    its slice (invalid rows at -inf) and keeps its top ``min(k, rows per
    shard)`` with global indices; the candidates merge in shard order.
    Returns (scores [B, k] f32, indices [B, k] i32) on shard 0's device.

    For cosine or dot with ``k <= 1024`` each shard's local step is the
    block top-k kernel over that shard's prepared slice (bf16 when
    ``bf16``); for l2sq, or a larger k, it is the plain
    ``dense_topk_prepared``, as the unsharded index does. ``prepared``
    passes each shard's ``prepare_corpus(slice, metric, bf16)`` when the
    caller keeps them (``DeviceCorpus.prepared_arrays``)."""
    from pathway_tpu_torch.ops import block_topk as bt

    slices = shard_rows(corpus, mesh, axis)
    valids = shard_rows(valid, mesh, axis)
    per = slices[0].shape[0]
    if prepared is None:
        prepared = [prepare_corpus(c, metric, bf16) for c in slices]
    q_host = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(np.asarray(queries))
    kk = min(k, per)
    candidates = []
    for s, ((prep, c2), v) in enumerate(zip(prepared, valids)):
        q = q_host.to(prep.device, torch.float32)
        if metric in ("cosine", "dot") and bt.supported(per + (-per % BLK), kk):
            sc, ix = _kernel_local_topk(q, prep, v, kk, metric)
        else:
            sc, ix = dense_topk_prepared(q, prep, c2, v, kk, metric=metric, bf16=bf16)
        candidates.append((sc, ix.to(torch.int32) + s * per))
    return _merge_shards(candidates, k, mesh.device_of(0, axis))


def sharded_topk_ref(
    queries: Any,
    corpus: Any,
    valid: Any,
    k: int,
    *,
    mesh: Any,
    axis: str = "data",
    metric: str = "cosine",
    bf16: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``sharded_topk``: ``dense_topk`` on each shard's
    slice, then the same merge."""
    slices = shard_rows(corpus, mesh, axis)
    valids = shard_rows(valid, mesh, axis)
    per = slices[0].shape[0]
    q_host = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(np.asarray(queries))
    kk = min(k, per)
    candidates = []
    for s, (c, v) in enumerate(zip(slices, valids)):
        sc, ix = dense_topk(q_host.to(c.device, torch.float32), c, v, kk, metric=metric, bf16=bf16)
        candidates.append((sc, ix.to(torch.int32) + s * per))
    return _merge_shards(candidates, k, mesh.device_of(0, axis))


class DeviceCorpus:
    """Growable padded corpus living on the device.

    The host keeps a float32 mirror; the device tensor is refreshed lazily
    (one host→device copy per change, amortized over all queries until the
    next change). Capacity is a multiple of 1024, so the block kernel
    (ops/block_topk.py) always applies, and doubles when full.

    With ``sharding`` (``parallel.collectives.sharded_rows(mesh, axis)``)
    the rows split over the mesh axis: capacity aligns to
    ``lcm(1024, n_devices)``, as the reference's does, and
    ``device_arrays``/``prepared_arrays`` give one slice per shard, each on
    its shard's device; ``device`` is then the mesh's first shard's."""

    def __init__(
        self,
        dim: int,
        capacity: int = 1024,
        device: str | torch.device = "cuda",
        sharding: Any = None,
        valid_sharding: Any = None,
    ):
        self.sharding = sharding
        self.valid_sharding = valid_sharding
        align = BLK
        if sharding is not None:
            self.device = sharding.mesh.device_of(0, sharding.axis)
            align = math.lcm(BLK, max(1, sharding.mesh.size))
        else:
            self.device = resolve_device(device)
        self._align = align
        self.dim = dim
        self.capacity = -(-max(BLK, capacity) // align) * align
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

    def device_arrays(self) -> tuple[Any, Any]:
        if self._dirty or self._device is None:
            # the whole corpus goes up again after any change: the span
            # times that re-upload as the caller's thread waits for it
            with get_tracer().span(
                "knn.corpus_upload", bytes=self.host.nbytes + self.valid_host.nbytes
            ):
                # drop the old copies first so a re-upload never holds two
                self._device = self._device_valid = None
                self._prepared.clear()
                if self.sharding is not None:
                    mesh, axis = self.sharding.mesh, self.sharding.axis
                    self._device = shard_rows(self.host, mesh, axis)
                    self._device_valid = shard_rows(self.valid_host, mesh, axis)
                else:
                    self._device = torch.from_numpy(self.host).to(self.device)
                    self._device_valid = torch.from_numpy(self.valid_host).to(self.device)
            self._dirty = False
        return self._device, self._device_valid

    def prepared_arrays(self, metric: str, bf16: bool = True) -> tuple[Any, Any, Any]:
        """(prep, c2, valid) with normalization/cast amortized across
        queries — refreshed only when the corpus changed. Sharded: one
        list entry per shard for each."""
        device, valid = self.device_arrays()
        key = (metric, bf16)
        if key not in self._prepared:
            if self.sharding is not None:
                self._prepared[key] = [prepare_corpus(c, metric, bf16) for c in device]
            else:
                self._prepared[key] = prepare_corpus(device, metric, bf16)
        if self.sharding is not None:
            pairs = self._prepared[key]
            return [p for p, _c in pairs], [c for _p, c in pairs], valid
        prep, c2 = self._prepared[key]
        return prep, c2, valid

    def keys_for_slots(self, slots: np.ndarray) -> list[int | None]:
        return [self.key_of.get(int(s)) if s >= 0 else None for s in slots]
