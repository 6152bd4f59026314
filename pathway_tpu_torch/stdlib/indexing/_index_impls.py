"""Host-side index objects behind the engine's ``ExternalIndexNode`` —
counterpart of ``pathway_tpu/stdlib/indexing/_index_impls.py``:

* ``TpuDenseKnnIndex`` — exact dense KNN over a device-resident corpus;
* ``Bm25Index`` — a host-side BM25 inverted index (no device part, as in
  the reference);
* ``LshKnnIndex`` — LSH candidate buckets from device projections, exact
  rerank of the candidates on the host;
* ``IvfKnnIndex`` — two-level IVF: training and assignment on the device,
  the candidates scored on the host, as the reference splits it.

``TpuDenseKnnIndex``: same surface and results as the JAX class: ``upsert``/``remove``/``keys``/
``filter_keys`` (with compaction)/``resident_bytes``, the same
``state_dict``/``load_state`` format (host-side numpy content, loadable by
either package), the power-of-two query-batch ladder, the x4 oversample when
a filter is set, f32 scoring, the cosine ``scores - 1.0`` shift and the same
filter loop, and the Tick Scope roofline (family ``topk``: analytic FLOPs
2·B·N·D over the measured wall, host sync included). The batch-occupancy
metric is not ported yet.

``mesh=`` shards the corpus's rows over the mesh ``axis``
(``parallel/mesh.py``): each shard's slice sits on its shard's device and
``search`` calls ``ops.knn.sharded_topk`` with the reference's arguments
(bf16 scoring, its default), whose local step per shard is the block
top-k kernel on the card for cosine/dot; ``device=`` is then the mesh's.

Kernel selector — unlike the JAX index, whose default is ``"xla"``, the
default here goes through the hand-written kernel on the card:

* ``"auto"`` (default; or ``PATHWAY_KNN_KERNEL``): the CUDA block top-k
  kernel (``ops/block_topk.py``) for ``cosine``/``dot`` whenever the corpus
  is on CUDA and ``supported(n, k)``; otherwise the torch matmul path.
* ``"torch"``: ``dense_topk_prepared`` (the counterpart of ``"xla"``).
* ``"cuda"``: always the block kernel for ``cosine``/``dot`` (on a CPU
  corpus its wrapper runs the plain version).

``l2sq`` always takes the torch matmul path, as it takes the XLA path in JAX.

The other three keep the reference's attribute names and ``state_dict``
keys, so their snapshots cross the packages both ways; ``Bm25Index`` has no
``state_dict`` and is pickled whole, so its attributes and their types are
the reference's (``postings`` a ``defaultdict(dict)``).
"""

from __future__ import annotations

import math
import os
import re
import time
from collections import defaultdict
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.ops import block_topk as bt
from pathway_tpu_torch.ops.ivf import assign_clusters, train_centroids
from pathway_tpu_torch.ops.lsh import lsh_buckets, make_projections
from pathway_tpu_torch.observability import tickscope
from pathway_tpu_torch.ops.knn import DeviceCorpus, dense_topk_prepared, sharded_topk
from pathway_tpu_torch.stdlib.indexing._filters import compile_filter

KERNELS = ("auto", "torch", "cuda")


def _as_vector(data: Any) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.float32, copy=False)
    return np.asarray(list(data), dtype=np.float32)


class TpuDenseKnnIndex:
    """Exact dense KNN over a device-resident corpus."""

    def __init__(
        self,
        dimensions: int | None = None,
        metric: str = "cosine",
        reserved_space: int = 1024,
        mesh: Any = None,
        axis: str = "data",
        kernel: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.dim = dimensions
        self.metric = metric
        self.reserved = reserved_space
        self.mesh = mesh
        self.axis = axis
        # a sharded corpus lives on the mesh's devices
        self.device = mesh.device_of(0, axis) if mesh is not None else resolve_device(device)
        self.corpus: DeviceCorpus | None = None
        self.metadata: dict[int, Any] = {}
        if kernel == "auto":
            kernel = os.environ.get("PATHWAY_KNN_KERNEL", "auto")
        if kernel not in KERNELS:
            raise ValueError(f"unknown KNN kernel {kernel!r}; expected one of {KERNELS}")
        self.kernel = kernel
        # pad the query batch to the next power of two, as the JAX index
        # does for its jit cache; PATHWAY_SERVING_SHAPE_LADDER=0 turns it off
        self.shape_ladder = os.environ.get("PATHWAY_SERVING_SHAPE_LADDER", "1") != "0"

    def _ensure(self, dim: int) -> DeviceCorpus:
        if self.corpus is None:
            cap, sharding = self.reserved, None
            if self.mesh is not None:
                from pathway_tpu_torch.parallel.collectives import sharded_rows

                n_dev = self.mesh.shape[self.axis]
                cap = max(cap, n_dev)
                cap = ((cap + n_dev - 1) // n_dev) * n_dev
                sharding = sharded_rows(self.mesh, self.axis)
            self.corpus = DeviceCorpus(
                dim, cap, device=self.device, sharding=sharding, valid_sharding=sharding
            )
        return self.corpus

    def upsert(self, key: int, data: Any, metadata: Any) -> None:
        vec = _as_vector(data)
        corpus = self._ensure(len(vec))
        corpus.upsert(key, vec)
        if metadata is not None:
            self.metadata[key] = metadata

    def remove(self, key: int) -> None:
        if self.corpus is not None:
            self.corpus.remove(key)
        self.metadata.pop(key, None)

    def __len__(self) -> int:
        return 0 if self.corpus is None else len(self.corpus)

    def keys(self) -> list[int]:
        """Resident corpus row keys."""
        c = self.corpus
        return [] if c is None else list(c.slot_of.keys())

    def filter_keys(self, pred) -> None:
        """Keep only keys matching ``pred`` and compact the backing buffers
        to the kept count (``remove()`` keeps the old capacity)."""
        c = self.corpus
        if c is None:
            self.metadata = {k: v for k, v in self.metadata.items() if pred(k)}
            return
        kept = [(k, s) for k, s in c.slot_of.items() if pred(k)]
        fresh = DeviceCorpus(
            c.dim, max(len(kept), 1), device=self.device, sharding=c.sharding,
            valid_sharding=c.valid_sharding,
        )
        for key, slot in kept:
            fresh.upsert(key, c.host[slot])
        self.corpus = fresh
        self.metadata = {k: v for k, v in self.metadata.items() if pred(k)}

    def resident_bytes(self) -> int:
        """Host-side resident corpus bytes (the device copy has the same
        shape)."""
        c = self.corpus
        if c is None:
            return 0
        return int(c.host.nbytes + c.valid_host.nbytes)

    # --- snapshot support: host-side content only; the device copy is
    # re-uploaded lazily. Same format as the JAX index.

    def state_dict(self) -> dict:
        c = self.corpus
        return {
            "metadata": self.metadata,
            "corpus": None
            if c is None
            else {
                "dim": c.dim,
                "capacity": c.capacity,
                "host": c.host,
                "valid_host": c.valid_host,
                "free": list(c.free),
                "slot_of": dict(c.slot_of),
                "key_of": dict(c.key_of),
            },
        }

    def load_state(self, state: dict) -> None:
        self.metadata = dict(state["metadata"])
        cs = state["corpus"]
        self.corpus = None
        if cs is None:
            return
        c = self._ensure(cs["dim"])
        if c.capacity == cs["capacity"]:
            c.host = cs["host"]
            c.valid_host = cs["valid_host"]
            c.free = list(cs["free"])
            c.slot_of = dict(cs["slot_of"])
            c.key_of = dict(cs["key_of"])
            c._dirty = True
        else:  # capacity differs from this index's reservation: re-upsert
            for key, slot in cs["slot_of"].items():
                c.upsert(key, cs["host"][slot])

    def _uses_kernel(self, n: int, k: int) -> bool:
        if self.metric not in ("cosine", "dot") or not bt.supported(n, k):
            return False
        if self.kernel == "cuda":
            return True
        return self.kernel == "auto" and self.device.type == "cuda"

    def search(self, queries: Sequence[tuple[Any, int, Any]]):
        if self.corpus is None or len(self.corpus) == 0 or not queries:
            return [() for _ in queries]
        qmat = np.stack([_as_vector(q) for q, _k, _f in queries])
        n_q = qmat.shape[0]
        if self.shape_ladder:
            bucket = 1 << max(0, n_q - 1).bit_length()
            if bucket != n_q:
                qmat = np.pad(qmat, ((0, bucket - n_q), (0, 0)))
        max_k = max(int(k) for _q, k, _f in queries)
        has_filter = any(f is not None for _q, _k, f in queries)
        # oversample when filtering so post-filter still fills k
        eff_k = max(0, min(len(self.corpus), max_k * 4 if has_filter else max_k))
        t0 = time.perf_counter()
        if self.mesh is not None:
            # the reference's sharded call: bf16 scoring, its default
            corpus_arr, valid = self.corpus.device_arrays()
            preps, c2s, _v = self.corpus.prepared_arrays(self.metric, bf16=True)
            scores, idx = sharded_topk(
                qmat, corpus_arr, valid, eff_k, mesh=self.mesh, axis=self.axis,
                metric=self.metric, prepared=list(zip(preps, c2s)),
            )
            return self._replies(queries, qmat, n_q, eff_k, scores, idx, t0)
        # f32 end to end, as the JAX index path scores
        prep, c2, valid = self.corpus.prepared_arrays(self.metric, bf16=False)
        q = torch.from_numpy(qmat).to(self.device)
        if self._uses_kernel(prep.shape[0], eff_k):
            scores, idx = bt.dense_topk_kernel(q, prep, valid, eff_k, metric=self.metric)
        else:
            scores, idx = dense_topk_prepared(
                q, prep, c2, valid, eff_k, metric=self.metric, bf16=False
            )
        return self._replies(queries, qmat, n_q, eff_k, scores, idx, t0)

    def _replies(self, queries, qmat, n_q: int, eff_k: int, scores, idx, t0: float):
        scores = scores[:n_q].double().cpu().numpy()
        idx = idx[:n_q].cpu().numpy()
        n, d = len(self.corpus), qmat.shape[1]
        key = f"topk_b{qmat.shape[0]}_n{n}_d{d}_k{eff_k}"
        rl = tickscope.roofline()
        if not rl.known("topk", key):
            rl.register("topk", key, 2.0 * qmat.shape[0] * n * d, source="analytic")
        rl.observe("topk", key, time.perf_counter() - t0)
        if self.metric == "cosine":
            # reference USearch COS scores are -(1 - cos): negative
            # distances, not raw similarities
            scores = scores - 1.0
        out = []
        for qi, (_q, k, flt) in enumerate(queries):
            if int(k) <= 0:
                out.append(())  # k=0 means no matches, not one
                continue
            pred = compile_filter(flt) if flt else None
            matches = []
            for j in range(idx.shape[1]):
                slot = idx[qi, j]
                if slot < 0:
                    break
                key = self.corpus.key_of.get(int(slot))
                if key is None:
                    continue
                if pred is not None and not pred(self.metadata.get(key)):
                    continue
                matches.append((key, float(scores[qi, j])))
                if len(matches) >= int(k):
                    break
            out.append(tuple(matches))
        return out


_WORD = re.compile(r"\w+", re.UNICODE)


class Bm25Index:
    """BM25 full-text index (reference: tantivy_integration.rs:16); host only.
    Replies rank by score, ties in the order ``postings`` met the documents
    (Python's stable ``sorted``), as in the reference."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.docs: dict[int, dict[str, int]] = {}
        self.doc_len: dict[int, int] = {}
        self.postings: dict[str, dict[int, int]] = defaultdict(dict)
        self.metadata: dict[int, Any] = {}

    @staticmethod
    def _tokens(text: str) -> list[str]:
        return [w.lower() for w in _WORD.findall(str(text))]

    def upsert(self, key: int, data: Any, metadata: Any) -> None:
        self.remove(key)
        tf: dict[str, int] = defaultdict(int)
        toks = self._tokens(data)
        for tok in toks:
            tf[tok] += 1
        self.docs[key] = dict(tf)
        self.doc_len[key] = len(toks)
        for tok, c in tf.items():
            self.postings[tok][key] = c
        if metadata is not None:
            self.metadata[key] = metadata

    def remove(self, key: int) -> None:
        tf = self.docs.pop(key, None)
        if tf:
            for tok in tf:
                self.postings[tok].pop(key, None)
        self.doc_len.pop(key, None)
        self.metadata.pop(key, None)

    def search(self, queries: Sequence[tuple[Any, int, Any]]):
        n = len(self.docs)
        if n == 0:
            return [() for _ in queries]
        avg_len = sum(self.doc_len.values()) / n
        out = []
        for qtext, k, flt in queries:
            pred = compile_filter(flt) if flt else None
            scores: dict[int, float] = defaultdict(float)
            for tok in self._tokens(qtext):
                plist = self.postings.get(tok)
                if not plist:
                    continue
                idf = math.log(1 + (n - len(plist) + 0.5) / (len(plist) + 0.5))
                for doc, tf in plist.items():
                    dl = self.doc_len[doc] or 1
                    scores[doc] += (
                        idf
                        * tf
                        * (self.k1 + 1)
                        / (tf + self.k1 * (1 - self.b + self.b * dl / avg_len))
                    )
            ranked = sorted(scores.items(), key=lambda kv: -kv[1])
            matches = []
            for doc, s in ranked:
                if pred is not None and not pred(self.metadata.get(doc)):
                    continue
                matches.append((doc, float(s)))
                if len(matches) >= int(k):
                    break
            out.append(tuple(matches))
        return out


class LshKnnIndex:
    """LSH-bucketed ANN: device projections pick candidate buckets, exact
    rerank of the candidates on the host (reference:
    stdlib/ml/classifiers/_lsh.py). ``upsert`` and ``remove`` hash one row
    each: one device call and one host sync per row, as in the reference."""

    def __init__(
        self,
        dimensions: int,
        n_or: int = 8,
        n_and: int = 4,
        bucket_length: float = 4.0,
        metric: str = "l2sq",
        seed: int = 42,
        device: str | torch.device = "cuda",
    ):
        self.dim = dimensions
        self.n_or = n_or
        self.bucket_length = bucket_length
        self.metric = metric
        self.device = resolve_device(device)
        self.planes, self.offsets = make_projections(
            dimensions, n_or, n_and, bucket_length, seed, device=self.device
        )
        self.buckets: list[dict[int, set[int]]] = [defaultdict(set) for _ in range(n_or)]
        self.vectors: dict[int, np.ndarray] = {}
        self.metadata: dict[int, Any] = {}

    def _bucket_ids(self, vecs: np.ndarray) -> np.ndarray:
        v = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(self.device)
        return lsh_buckets(v, self.planes, self.offsets, self.bucket_length).cpu().numpy()

    def upsert(self, key: int, data: Any, metadata: Any) -> None:
        vec = _as_vector(data)
        self.remove(key)
        self.vectors[key] = vec
        ids = self._bucket_ids(vec[None])[0]
        for t, b in enumerate(ids):
            self.buckets[t][int(b)].add(key)
        if metadata is not None:
            self.metadata[key] = metadata

    def remove(self, key: int) -> None:
        vec = self.vectors.pop(key, None)
        if vec is not None:
            ids = self._bucket_ids(vec[None])[0]
            for t, b in enumerate(ids):
                self.buckets[t][int(b)].discard(key)
        self.metadata.pop(key, None)

    def state_dict(self) -> dict:
        # the planes and offsets follow from the constructor's arguments, so
        # only the mutable content snapshots (no device tensors)
        return {
            "buckets": [dict(b) for b in self.buckets],
            "vectors": self.vectors,
            "metadata": self.metadata,
        }

    def load_state(self, state: dict) -> None:
        self.buckets = [defaultdict(set, b) for b in state["buckets"]]
        self.vectors = dict(state["vectors"])
        self.metadata = dict(state["metadata"])

    def search(self, queries: Sequence[tuple[Any, int, Any]]):
        if not self.vectors:
            return [() for _ in queries]
        qmat = np.stack([_as_vector(q) for q, _k, _f in queries])
        all_ids = self._bucket_ids(qmat)
        out = []
        for qi, (q, k, flt) in enumerate(queries):
            pred = compile_filter(flt) if flt else None
            candidates: set[int] = set()
            for t, b in enumerate(all_ids[qi]):
                candidates |= self.buckets[t].get(int(b), set())
            if not candidates:
                out.append(())
                continue
            qv = _as_vector(q)
            scored = []
            for key in candidates:
                if pred is not None and not pred(self.metadata.get(key)):
                    continue
                v = self.vectors[key]
                if self.metric == "cosine":
                    # the dense indexes' convention: cos - 1, an exact match 0
                    s = float(np.dot(qv, v) / ((np.linalg.norm(qv) * np.linalg.norm(v)) + 1e-30)) - 1.0
                else:
                    s = -float(np.sum((qv - v) ** 2))
                scored.append((key, s))
            scored.sort(key=lambda kv: -kv[1])
            out.append(tuple(scored[: int(k)]))
        return out


class IvfKnnIndex:
    """Two-level IVF KNN (design note in ``ops/ivf.py``): the coarse
    quantization picks ``n_probe`` inverted lists, exact scoring ranks their
    members. Below ``min_train`` points (and until training) the index scores
    exactly over everything, so small corpora behave as the brute-force
    index. Training and assignment run on ``device``; the coarse probe of a
    query and the scoring of its candidates run on the host (``_score``), as
    the reference splits it. The index trains at its first search past
    ``min_train`` and again at 4x growth, each time reassigning every key."""

    def __init__(
        self,
        dimensions: int | None = None,
        metric: str = "cosine",
        n_clusters: int | None = None,
        n_probe: int | None = None,
        min_train: int = 4096,
        train_sample: int = 20000,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cosine", "dot", "l2sq"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dimensions
        self.metric = metric
        self.n_clusters = n_clusters
        self.n_probe = n_probe
        self.min_train = min_train
        self.train_sample = train_sample
        self.seed = seed
        self.device = resolve_device(device)
        self.vecs: dict[int, np.ndarray] = {}
        self.metadata: dict[int, Any] = {}
        self.centroids: np.ndarray | None = None
        self.lists: dict[int, set[int]] = {}
        self.key_cluster: dict[int, int] = {}
        self._pending: list[int] = []  # keys awaiting cluster assignment
        self._trained_size = 0

    # --- maintenance ------------------------------------------------------

    def _space(self, v: np.ndarray) -> np.ndarray:
        """Clustering space: normalized for cosine (so L2 ~ angle), raw
        otherwise."""
        if self.metric == "cosine":
            return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)
        return v

    def upsert(self, key: int, data: Any, metadata: Any) -> None:
        vec = _as_vector(data)
        if self.dim is not None and len(vec) != self.dim:
            raise ValueError(f"IvfKnnIndex: expected {self.dim}-dim vectors, got {len(vec)}")
        self.remove(key)
        self.vecs[key] = vec
        if metadata is not None:
            self.metadata[key] = metadata
        self._pending.append(key)

    def remove(self, key: int) -> None:
        self.vecs.pop(key, None)
        self.metadata.pop(key, None)
        c = self.key_cluster.pop(key, None)
        if c is not None:
            self.lists.get(c, set()).discard(key)

    def _maybe_train(self) -> None:
        n = len(self.vecs)
        if n < self.min_train:
            return
        if self.centroids is not None and n < 4 * self._trained_size:
            return
        rng = np.random.default_rng(self.seed)
        keys = list(self.vecs.keys())
        if len(keys) > self.train_sample:
            keys = [keys[i] for i in rng.choice(len(keys), size=self.train_sample, replace=False)]
        sample = self._space(np.stack([self.vecs[k] for k in keys]))
        n_clusters = self.n_clusters or max(8, int(round(math.sqrt(n) / 8)) * 8)
        self.centroids = train_centroids(sample, n_clusters, seed=self.seed, device=self.device)
        # reassign every key under the new centroids
        self.lists = {}
        self.key_cluster = {}
        self._pending = list(self.vecs.keys())
        self._trained_size = n

    def _flush_assign(self) -> None:
        if self.centroids is None or not self._pending:
            return  # keep pending until training happens
        keys = [k for k in self._pending if k in self.vecs]
        self._pending = []
        if not keys:
            return
        x = self._space(np.stack([self.vecs[k] for k in keys]))
        assign = assign_clusters(x, self.centroids, device=self.device)
        for k, c in zip(keys, assign.tolist()):
            self.key_cluster[k] = c
            self.lists.setdefault(c, set()).add(k)

    # --- snapshots --------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "vecs": self.vecs,
            "metadata": self.metadata,
            "centroids": self.centroids,
            "key_cluster": self.key_cluster,
            "trained_size": self._trained_size,
        }

    def load_state(self, state: dict) -> None:
        self.vecs = dict(state["vecs"])
        self.metadata = dict(state["metadata"])
        self.centroids = state["centroids"]
        self._trained_size = int(state.get("trained_size", 0))
        self.key_cluster = dict(state["key_cluster"])
        self.lists = {}
        for k, c in self.key_cluster.items():
            self.lists.setdefault(c, set()).add(k)
        self._pending = [k for k in self.vecs if k not in self.key_cluster]

    # --- query ------------------------------------------------------------

    def _score(self, q: np.ndarray, keys: list[int]) -> np.ndarray:
        mat = np.stack([self.vecs[k] for k in keys]).astype(np.float32)
        qv = q.astype(np.float32)
        if self.metric == "cosine":
            qv = qv / (np.linalg.norm(qv) + 1e-30)
            mat = mat / (np.linalg.norm(mat, axis=1, keepdims=True) + 1e-30)
            return mat @ qv - 1.0  # the reference's COS convention: -(1 - cos)
        if self.metric == "l2sq":
            d = mat - qv[None, :]
            return -np.sum(d * d, axis=1)
        return mat @ qv

    def search(self, queries: Sequence[tuple[Any, int, Any]]):
        if not queries:
            return []
        if not self.vecs:
            return [() for _ in queries]
        self._maybe_train()
        self._flush_assign()
        out = []
        for q, k, flt in queries:
            if int(k) <= 0:
                out.append(())
                continue
            qv = _as_vector(q)
            if self.centroids is None:
                cand = list(self.vecs.keys())  # exact below min_train
            else:
                qs = self._space(qv[None, :]).astype(np.float32)
                c32 = self.centroids.astype(np.float32)
                d = np.sum(c32 * c32, axis=1) - 2.0 * (qs @ c32.T)[0]
                n_probe = self.n_probe or max(1, int(round(math.sqrt(len(c32)))))
                n_probe = min(n_probe, len(c32))
                probes = np.argpartition(d, n_probe - 1)[:n_probe]
                cand = [key for c in probes.tolist() for key in self.lists.get(c, ())]
                if not cand:
                    cand = list(self.vecs.keys())
            scores = self._score(qv, cand)
            order = np.argsort(-scores, kind="stable")
            pred = compile_filter(flt) if flt else None
            matches = []
            for j in order.tolist():
                key = cand[j]
                if pred is not None and not pred(self.metadata.get(key)):
                    continue
                matches.append((key, float(scores[j])))
                if len(matches) >= int(k):
                    break
            out.append(tuple(matches))
        return out
