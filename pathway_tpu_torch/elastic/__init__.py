"""pathway_tpu_torch.elastic — generation-plane resharding (``kv.py``):
splitting a KV snapshot across new owners by the jk-hash ownership. The
segment ferry, the mesh and serving planes' resharding and the two-phase
ownership map are not ported yet: each of their names raises naming
[mesh]."""

from pathway_tpu_torch._unported import MESH, package_getattr

__getattr__ = package_getattr(
    "pathway_tpu_torch.elastic",
    dict.fromkeys(
        (
            "FerryReceiver", "ferry_files",  # ferry.py
            "KeyRangeMove", "OwnershipMap", "TwoPhaseHandover",
            "load_ownership",  # handover.py
            "ReshardPlan", "moved_fraction", "plan_reshard",  # planner.py
            "exec_class_for", "repartition_arrangements",
            "repartition_shard_states", "reshard_capable",
            "split_arrangement",  # mesh.py
        ),
        MESH,
    ),
)
