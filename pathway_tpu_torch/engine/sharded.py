"""The system-wide ownership function — own copy of ``shard_of`` and
``SHARD_MASK`` from ``pathway_tpu/engine/sharded.py``.

Not ported: the key-sharded execs and the exchange facts (the engine is not
part of the port yet).
"""

from __future__ import annotations

import numpy as np

SHARD_MASK = 0xFFFF  # low 16 bits route the row


def shard_of(gks: np.ndarray, n_shards: int) -> np.ndarray:
    """THE ownership function: every plane routes a key by this same
    jk-hash partition, so a key's owner is one agreed fact across layers
    and across the two packages."""
    return ((gks.astype(np.uint64) & np.uint64(SHARD_MASK)) % np.uint64(
        n_shards
    )).astype(np.int32)
