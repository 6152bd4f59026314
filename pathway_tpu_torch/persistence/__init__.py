"""pathway_tpu_torch.persistence — the segment codec (``segments.py``), the
on-disk form of an arrangement shared with ``pathway_tpu/persistence``. The
persistence glue and its backends are not ported yet."""
