"""pathway_tpu_torch.elastic — own copy of ``pathway_tpu/elastic/``.

Shard Flux — live elastic resharding: move state, not logs.

Every stateful tier of this system partitions keyed state by ONE
ownership function (engine/sharded.py ``shard_of``: the low 16 bits of
the jk hash mod the shard count), and every tier's durable form is the
content-addressed arrangement segment (persistence/segments.py).  This
package exploits both facts to change a topology's shard/rank count
WITHOUT replaying the input log:

* :mod:`planner` — ``ReshardPlanner``: the hash-ring delta of an N→M
  change (which key slots move, between whom) and the arrangement-level
  row re-partition that realizes it.
* :mod:`ferry` — ``SegmentFerry``: streams whole arrangement segments
  to their new owners over the PWHX-family authenticated wire, with
  per-segment integrity MACs and content-addressed resumable transfer.
* :mod:`handover` — the two-phase handover barrier: freeze a migrating
  topology at a tick boundary, commit the new ownership map under a
  bumped incarnation (zombies fenced by the existing incarnation
  checks), unfreeze — bounded pause, zero replay, rollback on any
  failure before the commit point.
* :mod:`mesh` — ``reshard_stores``: the DCN compute-mesh plane — an
  N-rank group's per-rank persistence stores re-partitioned into M
  per-rank stores (only moved key ranges cross rank boundaries), driven
  by ``GroupSupervisor.resize``.
* :mod:`kv` — the generation plane: the KV ledger's page arrangements
  ride the same split, so in-flight decodes resume on their new owner.

Fault Forge's ``kill=ferry:N`` directive (testing/faults.py) kills a
process deterministically on the ferry's segment-transfer counter, so
chaos tests can assert the barrier rolls back cleanly mid-handoff.
"""

from pathway_tpu_torch.elastic.ferry import FerryReceiver, ferry_files
from pathway_tpu_torch.elastic.handover import (
    OwnershipMap,
    TwoPhaseHandover,
    load_ownership,
)
from pathway_tpu_torch.elastic.planner import (
    KeyRangeMove,
    ReshardPlan,
    exec_class_for,
    moved_fraction,
    plan_reshard,
    repartition_arrangements,
    repartition_shard_states,
    reshard_capable,
    split_arrangement,
)

__all__ = [
    "FerryReceiver",
    "KeyRangeMove",
    "OwnershipMap",
    "ReshardPlan",
    "TwoPhaseHandover",
    "exec_class_for",
    "ferry_files",
    "load_ownership",
    "moved_fraction",
    "plan_reshard",
    "repartition_arrangements",
    "repartition_shard_states",
    "reshard_capable",
    "split_arrangement",
]
