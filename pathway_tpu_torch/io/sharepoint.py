"""Own copy of ``pathway_tpu/io/sharepoint.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.sharepoint — SharePoint source stub.

The reference gates the real implementation behind its enterprise
offering (upstream Pathway: python/pathway/xpacks/connectors/sharepoint — OSS
tree ships a stub raising at call time); this mirrors that surface."""

from __future__ import annotations

from typing import Any


def read(*args: Any, **kwargs: Any):
    raise NotImplementedError(
        "pw.io.sharepoint is not available in this build (the reference "
        "gates it behind an enterprise license; use pw.io.fs / pw.io.s3 "
        "with a synced drive instead)"
    )
