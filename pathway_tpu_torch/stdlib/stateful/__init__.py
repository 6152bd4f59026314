"""The port's own copy of ``pathway_tpu/stdlib/stateful/__init__.py``. pw.stateful (reference: stdlib/stateful/deduplicate.py)."""

from __future__ import annotations

from typing import Any, Callable


def deduplicate(
    table,
    *,
    value: Any = None,
    instance: Any = None,
    acceptor: Callable | None = None,
    name: str | None = None,
    persistent_id: str | None = None,
):
    """Keep only the last accepted value per instance."""
    return table.deduplicate(
        value=value,
        instance=instance,
        acceptor=acceptor,
        name=name,
        persistent_id=persistent_id,
    )


__all__ = ["deduplicate"]
