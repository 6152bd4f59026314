"""pathway_tpu_torch.generate — the generation stage (counterpart of
``pathway_tpu/generate``): ask -> retrieve -> generate over a paged KV cache.

* :mod:`~pathway_tpu_torch.generate.kv_cache` — ``PagePool``, the free-list
  over the physical pages of the device K/V pools (page 0 is the null page),
  and ``KvLedger``, the in-flight state mirrored into arrangement ledgers
  and snapshotted incrementally in the reference's format;
* :mod:`~pathway_tpu_torch.generate.scheduler` — ``DecodeScheduler``:
  continuous batching through the EDF micro-batcher on the power-of-two pad
  ladder, sequences joining between steps, deadline drops mid-decode with
  page reclaim, every step through the hand-written paged-attention kernel
  on the card, periodic and on-demand snapshots, restore after a kill, and
  the reference's metrics, spans, memory ledger, roofline and fault hook;
* :mod:`~pathway_tpu_torch.generate.serving` — ``attach_generate``, which
  mounts the ``/generate`` route (ask -> retrieve -> generate, JSON or
  streamed NDJSON) on a ``ReplicaServer``, and ``assemble_prompt``.
"""

from pathway_tpu_torch.generate.kv_cache import NULL_PAGE, KvLedger, PagePool
from pathway_tpu_torch.generate.scheduler import (
    DecodeScheduler,
    GenerateConfig,
    GenerationRequest,
    generate_enabled_via_env,
)
from pathway_tpu_torch.generate.serving import assemble_prompt, attach_generate

__all__ = [
    "NULL_PAGE",
    "KvLedger",
    "PagePool",
    "DecodeScheduler",
    "GenerateConfig",
    "GenerationRequest",
    "assemble_prompt",
    "attach_generate",
    "generate_enabled_via_env",
]
