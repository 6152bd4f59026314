"""pathway_tpu_torch.parallel — the replication wire of the read plane
(counterpart of ``pathway_tpu/parallel``).

* :mod:`~pathway_tpu_torch.parallel.wire` — the typed columnar frame codec;
* :mod:`~pathway_tpu_torch.parallel.replicate` — the writer's
  ``DeltaStreamServer`` and the replicas' ``DeltaStreamClient``;
* :mod:`~pathway_tpu_torch.parallel.host_exchange` — the handshake's HMAC
  helpers only.

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
            "exchange_topology",
        ),
        MESH,
    ),
)

__all__: list[str] = []
