"""pathway_tpu_torch.generate — the generation stage (counterpart of
``pathway_tpu/generate``): ask -> retrieve -> generate over a paged KV cache.

* :mod:`~pathway_tpu_torch.generate.kv_cache` — ``PagePool``, the free-list
  over the physical pages of the device K/V pools (page 0 is the null page);
* :mod:`~pathway_tpu_torch.generate.scheduler` — ``DecodeScheduler``:
  continuous batching through the EDF micro-batcher on the power-of-two pad
  ladder, sequences joining between steps, deadline drops mid-decode with
  page reclaim, every step through the hand-written paged-attention kernel
  on the card;
* :mod:`~pathway_tpu_torch.generate.serving` — ``assemble_prompt`` and the
  ``/generate`` route name.

Not ported yet: ``KvLedger`` (snapshot/restore) and ``attach_generate`` (the
route on a ``ReplicaServer``).
"""

from pathway_tpu_torch.generate.kv_cache import NULL_PAGE, PagePool
from pathway_tpu_torch.generate.scheduler import (
    DecodeScheduler,
    GenerateConfig,
    GenerationRequest,
)
from pathway_tpu_torch.generate.serving import assemble_prompt

__all__ = [
    "NULL_PAGE",
    "PagePool",
    "DecodeScheduler",
    "GenerateConfig",
    "GenerationRequest",
    "assemble_prompt",
]
