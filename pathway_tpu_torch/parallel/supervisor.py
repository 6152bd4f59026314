"""``pathway_tpu/parallel/supervisor.py`` (the process-group supervisor)
is not ported: each of its names raises ``NotImplementedError`` naming
[replication]."""

from pathway_tpu_torch._unported import REPLICATION, package_getattr

__getattr__ = package_getattr(
    "parallel.supervisor",
    dict.fromkeys(("GroupSupervisor", "max_restarts_env", "main"), REPLICATION),
)
