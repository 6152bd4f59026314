"""pathway_tpu_torch.parallel — the replication wire of the read plane
(counterpart of ``pathway_tpu/parallel``).

* :mod:`~pathway_tpu_torch.parallel.wire` — the typed columnar frame codec;
* :mod:`~pathway_tpu_torch.parallel.replicate` — the writer's
  ``DeltaStreamServer`` and the replicas' ``DeltaStreamClient``;
* :mod:`~pathway_tpu_torch.parallel.host_exchange` — the handshake's HMAC
  helpers only;
* :func:`exchange_topology` — the static exchange facts the Graph Doctor
  reads: one process with no mesh.

The device mesh and the collectives (the reference's exported names) are
not ported: each raises ``NotImplementedError`` naming [mesh]. The standby
writer and the process-group supervisor (``parallel/standby.py``,
``parallel/supervisor.py``) raise naming [replication].
"""

from pathway_tpu_torch._unported import MESH, package_getattr

__getattr__ = package_getattr(
    "parallel",
    dict.fromkeys(
        (
            "make_mesh",
            "get_mesh",
            "set_default_mesh",
            "exchange_by_shard",
            "sharded_rows",
            "replicated",
        ),
        MESH,
    ),
)


def exchange_topology() -> dict:
    """Static facts about the exchange fabric this process would execute
    with (the reference's ``parallel.exchange_topology``): the port runs one
    process with no device mesh, so one engine shard and one process. A
    process group or an engine mesh raises naming [mesh], through the
    ``Runtime``'s own refusal, rather than describe a fabric it would not
    run."""
    from pathway_tpu_torch.engine.runtime import refuse_unported_fabric

    refuse_unported_fabric()
    return {"engine_shards": 1, "dcn_processes": 1, "sharding_active": False}


__all__ = ["exchange_topology"]
