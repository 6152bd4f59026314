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
* :mod:`~pathway_tpu_torch.parallel.host_exchange` — the handshake's HMAC
  helpers only;
* :func:`exchange_topology` — the static exchange facts the Graph Doctor
  reads.

The host mesh across processes (``parallel/distributed.py``, the rest of
``host_exchange.py``) raises naming [mesh]. The standby writer and the
process-group supervisor (``parallel/standby.py``,
``parallel/supervisor.py``) raise naming [replication].
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
    over the device mesh and one process. A process group raises naming
    [mesh], through the ``Runtime``'s own refusal, rather than describe a
    fabric it would not run."""
    from pathway_tpu_torch.engine.runtime import refuse_unported_fabric
    from pathway_tpu_torch.parallel.mesh import get_engine_mesh

    refuse_unported_fabric()
    em = get_engine_mesh()
    shards = em[0].shape[em[1]] if em is not None else 1
    return {"engine_shards": shards, "dcn_processes": 1, "sharding_active": shards > 1}


__all__ = [
    "make_mesh",
    "get_mesh",
    "set_default_mesh",
    "exchange_by_shard",
    "sharded_rows",
    "replicated",
    "exchange_topology",
]
