"""pathway_tpu_torch.testing — the fault plan (``faults.py``) and the chaos
drivers' shared helpers (``chaos.py``)."""

from pathway_tpu_torch.testing import chaos, faults

__all__ = ["chaos", "faults"]
