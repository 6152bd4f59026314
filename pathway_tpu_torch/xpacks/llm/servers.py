"""Counterpart of ``pathway_tpu/xpacks/llm/servers.py``: ``BaseRestServer``,
``DocumentStoreServer``, ``QARestServer`` and ``QASummaryRestServer``.

Each serves a store or a question answerer over the REST connector
(``io/http``), which is not ported: constructing any of them raises
``NotImplementedError`` naming ROADMAP [rest]. The module imports no HTTP
library, so ``import pathway_tpu_torch.xpacks.llm`` needs none."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch._unported import REST, unported


class BaseRestServer:
    def __init__(self, *args: Any, **kwargs: Any):
        raise unported(type(self).__name__, REST)


class DocumentStoreServer(BaseRestServer):
    pass


class QARestServer(BaseRestServer):
    pass


class QASummaryRestServer(QARestServer):
    pass
