"""pathway_tpu_torch.parallel — the in-process device mesh and the
replication wire of the read plane (counterpart of ``pathway_tpu/parallel``).

* :mod:`~pathway_tpu_torch.parallel.mesh` — ``Mesh``, ``make_mesh``, the
  default and the engine mesh;
* :mod:`~pathway_tpu_torch.parallel.exchange` — the ragged all-to-all row
  exchange;
* :mod:`~pathway_tpu_torch.parallel.collectives` — ``exchange_by_shard``,
  ``frontier_allreduce`` and the placements ``sharded_rows``/``replicated``;
* :mod:`~pathway_tpu_torch.parallel.wire` — the typed columnar frame codec;
* :mod:`~pathway_tpu_torch.parallel.replicate` — the writer's
  ``DeltaStreamServer`` and the replicas' ``DeltaStreamClient``;
* :mod:`~pathway_tpu_torch.parallel.host_exchange` — the host mesh
  between engine processes (``HostMesh``, ``get_host_mesh``);
* :mod:`~pathway_tpu_torch.parallel.distributed` — the device group on
  ``torch.distributed`` and ``sharded_topk_global``;
* :mod:`~pathway_tpu_torch.parallel.supervisor` — ``GroupSupervisor``,
  the whole-group restart of a process group (``cli spawn --supervise``);
* :mod:`~pathway_tpu_torch.parallel.standby` — ``StandbyWriter``, the hot
  takeover of the writer role;
* :func:`exchange_topology` — the static exchange facts the Graph Doctor
  reads.
"""

from pathway_tpu_torch.parallel.collectives import (
    exchange_by_shard,
    replicated,
    sharded_rows,
)
from pathway_tpu_torch.parallel.mesh import (
    get_mesh,
    make_mesh,
    set_default_mesh,
)


def exchange_topology() -> dict:
    """Static facts about the exchange fabric this process would execute
    with (the reference's ``parallel.exchange_topology``): engine key-shards
    over the device mesh and peer processes on the host mesh. Consumed by
    the Graph Doctor's graph-stats rule; cheap enough to call at graph-build
    time."""
    from pathway_tpu_torch.parallel.host_exchange import dcn_active, process_env
    from pathway_tpu_torch.parallel.mesh import get_engine_mesh

    n_procs, _pid, _port, _host = process_env()
    em = get_engine_mesh()
    shards = em[0].shape[em[1]] if em is not None else 1
    dcn = n_procs if dcn_active() else 1
    return {
        "engine_shards": shards,
        "dcn_processes": dcn,
        "sharding_active": shards > 1 or dcn > 1,
    }


__all__ = [
    "make_mesh",
    "get_mesh",
    "set_default_mesh",
    "exchange_by_shard",
    "sharded_rows",
    "replicated",
    "exchange_topology",
]
