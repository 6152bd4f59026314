"""The system-wide ownership function — own copy of ``shard_of`` and
``SHARD_MASK`` from ``pathway_tpu/engine/sharded.py``, and of
``exchange_facts`` (the static routing contract of each operator,
read by the Graph Doctor's shard rules).

Not ported: the key-sharded execs ([mesh]).
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


def exchange_facts(node) -> list[tuple[str, tuple[str, ...]]]:
    """Static description of the exchange edges the sharded engine inserts
    in front of `node`: [(input label, routing key columns)]. Empty for
    operators that never re-route rows. Consumed by the Graph Doctor's
    shard-safety and graph-stats rules."""
    from pathway_tpu_torch.engine import nodes as _n

    if isinstance(node, _n.GroupByNode):
        return [("input", node.key_columns())]
    if isinstance(node, _n.JoinNode):
        return [
            ("left", tuple(node.left_on)),
            ("right", tuple(node.right_on)),
        ]
    if isinstance(node, _n.SortNode):
        # instance-less sorts are one global order and never shard
        if node.instance_col is not None:
            return [("input", (node.instance_col,))]
        return []
    if isinstance(node, _n.BufferNode):
        # the sharded buffer routes by row key; the watermark is global
        return [("input", ("id",))]
    return []
