"""One place for the ``NotImplementedError`` of every reference hook the
port does not carry yet. Each message names the tag of the ``ROADMAP.md``
item that will port it, so nothing falls back silently to a different
behaviour."""

from __future__ import annotations

COMPILED_TICKS = "[compiled-ticks] (compiled ticks)"
INDEX_KINDS = "[index-kinds] (IVF/LSH/segment ops)"
MESH = "[mesh] (multi-device: engine mesh, DCN, sharded top-k)"
REPLICATION = "[replication] (parallel/replicate.py and the replica)"
BM25_HYBRID = "[index-kinds] (BM25, hybrid and document-index helpers)"
TEMPORAL = "[temporal] (temporal nodes and windows)"
CONNECTORS = "[connectors] (service connectors)"
OBSERVABILITY = "[observability] (the rest of observability)"


def unported(what: str, item: str) -> NotImplementedError:
    """The error to raise for ``what``, naming the ROADMAP ``item``."""
    return NotImplementedError(
        f"{what} is not ported to pathway_tpu_torch yet (ROADMAP {item})"
    )
