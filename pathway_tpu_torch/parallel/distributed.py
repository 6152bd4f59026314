"""``pathway_tpu/parallel/distributed.py`` (meshes across processes) is not
ported: each of its names raises ``NotImplementedError`` naming [mesh].
The in-process mesh is ``parallel/mesh.py``."""

from pathway_tpu_torch._unported import MESH, package_getattr

__getattr__ = package_getattr(
    "parallel.distributed",
    dict.fromkeys(
        (
            "process_env", "maybe_initialize", "is_multiprocess", "global_mesh",
            "from_process_local", "replicated", "to_host", "sharded_topk_global",
        ),
        MESH,
    ),
)
