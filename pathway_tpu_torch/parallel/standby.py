"""``pathway_tpu/parallel/standby.py`` (the standby writer's hot takeover)
is not ported: each of its names raises ``NotImplementedError`` naming
[replication]."""

from pathway_tpu_torch._unported import REPLICATION, package_getattr

__getattr__ = package_getattr(
    "parallel.standby",
    dict.fromkeys(("StandbyWriter", "grace_env", "main"), REPLICATION),
)
