"""pathway_tpu_torch.testing — the fault plan (``faults.py``)."""
