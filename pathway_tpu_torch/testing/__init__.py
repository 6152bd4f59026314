"""pathway_tpu_torch.testing — the fault plan (``faults.py``). The chaos
drivers of process groups (``testing/chaos.py``) raise naming [mesh]."""

from pathway_tpu_torch._unported import MESH, package_getattr
from pathway_tpu_torch.testing import faults

__getattr__ = package_getattr("pathway_tpu_torch.testing", {"chaos": MESH})

__all__ = ["faults"]
