"""pathway_tpu_torch.elastic — generation-plane resharding (``kv.py``):
splitting a KV snapshot across new owners by the jk-hash ownership; and the
reshard planner (``planner.py``): the hash-ring delta of an N→M change, the
arrangement re-partition that realizes it, and the static reshard-capability
predicates the Graph Doctor reads. The segment ferry, the mesh and serving
planes' resharding and the two-phase ownership map are not ported yet: each
of their names raises naming [mesh]."""

from pathway_tpu_torch._unported import MESH, package_getattr
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

__getattr__ = package_getattr(
    "pathway_tpu_torch.elastic",
    dict.fromkeys(
        (
            "FerryReceiver", "ferry_files",  # ferry.py
            "OwnershipMap", "TwoPhaseHandover", "load_ownership",  # handover.py
        ),
        MESH,
    ),
)

__all__ = [
    "KeyRangeMove",
    "ReshardPlan",
    "exec_class_for",
    "moved_fraction",
    "plan_reshard",
    "repartition_arrangements",
    "repartition_shard_states",
    "reshard_capable",
    "split_arrangement",
]
