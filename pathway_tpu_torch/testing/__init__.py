"""pathway_tpu_torch.testing — the fault plan (``faults.py``)."""

from pathway_tpu_torch.testing import faults

__all__ = ["faults"]
