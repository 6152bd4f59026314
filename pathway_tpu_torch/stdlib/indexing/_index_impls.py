"""Dense KNN index with a device-resident corpus — counterpart of
``TpuDenseKnnIndex`` in ``pathway_tpu/stdlib/indexing/_index_impls.py``.

Same surface and results as the JAX class: ``upsert``/``remove``/``keys``/
``filter_keys`` (with compaction)/``resident_bytes``, the same
``state_dict``/``load_state`` format (host-side numpy content, loadable by
either package), the power-of-two query-batch ladder, the x4 oversample when
a filter is set, f32 scoring, the cosine ``scores - 1.0`` shift and the same
filter loop, and the Tick Scope roofline (family ``topk``: analytic FLOPs
2·B·N·D over the measured wall, host sync included). The mesh path and the
batch-occupancy metric are not ported yet.

Kernel selector — unlike the JAX index, whose default is ``"xla"``, the
default here goes through the hand-written kernel on the card:

* ``"auto"`` (default; or ``PATHWAY_KNN_KERNEL``): the CUDA block top-k
  kernel (``ops/block_topk.py``) for ``cosine``/``dot`` whenever the corpus
  is on CUDA and ``supported(n, k)``; otherwise the torch matmul path.
* ``"torch"``: ``dense_topk_prepared`` (the counterpart of ``"xla"``).
* ``"cuda"``: always the block kernel for ``cosine``/``dot`` (on a CPU
  corpus its wrapper runs the plain version).

``l2sq`` always takes the torch matmul path, as it takes the XLA path in JAX.
"""

from __future__ import annotations

import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.ops import block_topk as bt
from pathway_tpu_torch.observability import tickscope
from pathway_tpu_torch.ops.knn import DeviceCorpus, dense_topk_prepared
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
        kernel: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.dim = dimensions
        self.metric = metric
        self.reserved = reserved_space
        self.device = resolve_device(device)
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
            self.corpus = DeviceCorpus(dim, self.reserved, device=self.device)
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
        fresh = DeviceCorpus(c.dim, max(len(kept), 1), device=self.device)
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
        # f32 end to end, as the JAX index path scores
        prep, c2, valid = self.corpus.prepared_arrays(self.metric, bf16=False)
        q = torch.from_numpy(qmat).to(self.device)
        if self._uses_kernel(prep.shape[0], eff_k):
            scores, idx = bt.dense_topk_kernel(q, prep, valid, eff_k, metric=self.metric)
        else:
            scores, idx = dense_topk_prepared(
                q, prep, c2, valid, eff_k, metric=self.metric, bf16=False
            )
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
