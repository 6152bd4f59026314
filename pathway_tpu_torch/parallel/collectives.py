"""Collective patterns over the mesh — own copy of
``pathway_tpu/parallel/collectives.py`` on torch devices: the Exchange pact
(``exchange_by_shard``, through ``parallel/exchange.py``), the progress
frontier's min-all-reduce (``frontier_allreduce``) and the placement
descriptors (``sharded_rows``, ``replicated``) that ``DeviceCorpus``
reads, in place of ``jax.sharding.NamedSharding``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Placement:
    """Where an array lives on a mesh: ``spec`` names the mesh axis its
    leading dimension is split over (``("data",)``), or is empty for an
    array replicated on every shard."""

    mesh: Any
    spec: tuple[str, ...]

    @property
    def axis(self) -> str | None:
        return self.spec[0] if self.spec else None


def sharded_rows(mesh: Any, axis: str = "data") -> Placement:
    """Placement for [N, ...] row-major tables: rows split over ``axis``."""
    return Placement(mesh, (axis,))


def replicated(mesh: Any) -> Placement:
    return Placement(mesh, ())


def exchange_by_shard(values, dest_shard, mesh, axis: str = "data"):
    """Route rows to the mesh shard given per row in ``dest_shard`` (the
    Exchange pact: key.shard() % n_workers) through the ragged all-to-all
    of ``parallel/exchange.py``.

    Returns (per_shard_values, per_shard_counts): a [n_shards, cap, d]
    array whose block s holds the rows shard s received, and the valid row
    count per block."""
    from pathway_tpu_torch.parallel.exchange import ragged_all_to_all

    n_shards = mesh.shape[axis]
    vals = np.ascontiguousarray(values)
    if vals.dtype.itemsize % 4:
        raise TypeError(f"exchange_by_shard needs a 4/8-byte element dtype, got {vals.dtype}")
    d = vals.shape[1]
    # rows travel as exact int32 bit patterns — no value cast for any dtype
    words = vals.view(np.int32).reshape(vals.shape[0], -1)
    blocks = ragged_all_to_all(words, np.asarray(dest_shard, dtype=np.int32), mesh, axis)
    cap = max((len(b) for b in blocks), default=0)
    out = np.zeros((n_shards, cap, d), dtype=vals.dtype)
    counts = np.zeros(n_shards, dtype=np.int64)
    for s, b in enumerate(blocks):
        counts[s] = len(b)
        if len(b):
            out[s, : len(b)] = b.view(vals.dtype).reshape(len(b), d)
    return out, counts


def frontier_allreduce(local_time, mesh, axis: str = "data") -> list[torch.Tensor]:
    """Global frontier = min over the shards' local clocks, returned on every
    shard: one 0-d tensor per shard on that shard's device (the
    reference's ``pmin`` over the axis). ``local_time`` is one value per
    shard: a sequence of tensors on the shards' devices, or an array."""
    devices = mesh.shard_devices(axis)
    n = len(devices)
    if isinstance(local_time, (list, tuple)) and all(isinstance(t, torch.Tensor) for t in local_time):
        vals = [t.reshape(()) for t in local_time]
    else:
        arr = local_time if isinstance(local_time, torch.Tensor) else torch.as_tensor(np.asarray(local_time))
        vals = [arr[s].to(devices[s]) for s in range(n)]
    if len(vals) != n:
        raise ValueError(f"frontier_allreduce needs {n} values, got {len(vals)}")
    low = torch.stack([v.to(devices[0]) for v in vals]).min()
    return [low.to(devices[s]) for s in range(n)]
