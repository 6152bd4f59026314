"""Own copy of ``HandoverError`` from ``pathway_tpu/elastic/handover.py``.

Not ported: ``OwnershipMap`` and ``TwoPhaseHandover`` (the committed
ownership map and its freeze/commit/rollback protocol), which only the mesh
and serving planes' resharding use.
"""

from __future__ import annotations


class HandoverError(RuntimeError):
    pass
