"""pw.io.plaintext — own copy of ``pathway_tpu/io/plaintext.py`` (upstream
Pathway: python/pathway/io/plaintext)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs as _fs


def read(
    path: str,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
):
    return _fs.read(
        path,
        format="plaintext",
        mode=mode,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )
