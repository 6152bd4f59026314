"""One place for the ``NotImplementedError`` of every reference hook the
port does not carry yet. Each message names the ``ROADMAP.md`` item that
will port it, so nothing falls back silently to a different behaviour."""

from __future__ import annotations

COMPILED_TICKS = "queue 1 item 7 (compiled ticks)"
INDEX_KINDS = "queue 1 item 8 (IVF/LSH/segment ops)"
MESH = "queue 1 item 9 (multi-device: engine mesh, DCN, sharded top-k)"
PERSISTENCE = "section 0 item 1 (persistence glue and parallel/replicate.py)"
BM25_HYBRID = "queue 1 item 13 (BM25, hybrid and document-index helpers)"
TEMPORAL = "queue 1 item 14 (temporal nodes and windows)"
CONNECTORS = "queue 1 item 15 (file and service connectors)"
OBSERVABILITY = "queue 1 item 10 (the rest of observability)"


def unported(what: str, item: str) -> NotImplementedError:
    """The error to raise for ``what``, naming the ROADMAP ``item``."""
    return NotImplementedError(
        f"{what} is not ported to pathway_tpu_torch yet (ROADMAP {item})"
    )
