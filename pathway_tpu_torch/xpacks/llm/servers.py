"""REST servers for document stores and QA apps — the port's copy of
``pathway_tpu/xpacks/llm/servers.py`` (``BaseRestServer``,
``DocumentStoreServer``, ``QARestServer``, ``QASummaryRestServer``), served
by the port's stdlib REST connector."""

from __future__ import annotations

import threading
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector


class BaseRestServer:
    def __init__(self, host: str, port: int, qos: Any = None, **rest_kwargs):
        self.host = host
        self.port = port
        self.qos = qos  # serving.QoSConfig applied to every route
        self.webserver = PathwayWebserver(host=host, port=port)

    def serve(
        self,
        route: str,
        schema: Any,
        handler,
        documentation: Any = None,
        **kwargs,
    ) -> None:
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=("POST",),
            delete_completed_queries=True,
            documentation=documentation,
            qos=kwargs.pop("qos", self.qos),
        )
        result = handler(queries)
        writer(result.select(query_id=result.id, result=result.result))

    def drain(self, grace_s: float | None = None) -> bool:
        """Graceful overload exit: stop admitting (503 + Retry-After),
        flush in-flight micro-batches, wait for every admitted request's
        response, then shut the webserver down."""
        return self.webserver.drain(grace_s)

    def run(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = True,
        **kwargs,
    ):
        def run_inner():
            pw.run(terminate_on_error=terminate_on_error)

        if threaded:
            t = threading.Thread(target=run_inner, daemon=True)
            t.start()
            return t
        run_inner()


class DocumentStoreServer(BaseRestServer):
    """(reference: servers.py:92)"""

    def __init__(self, host: str, port: int, document_store, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.document_store = document_store
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
        )


class QARestServer(BaseRestServer):
    """(reference: servers.py:140)"""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.rag = rag_question_answerer
        self.serve(
            "/v1/retrieve",
            self.rag.RetrieveQuerySchema,
            self.rag.retrieve,
        )
        self.serve(
            "/v1/statistics",
            self.rag.StatisticsQuerySchema,
            self.rag.statistics,
        )
        self.serve(
            "/v1/pw_list_documents",
            self.rag.InputsQuerySchema,
            self.rag.list_documents,
        )
        self.serve(
            "/v1/pw_ai_answer",
            self.rag.AnswerQuerySchema,
            self.rag.answer_query,
        )
        self.serve(
            "/v2/answer",
            self.rag.AnswerQuerySchema,
            self.rag.answer_query,
        )


class QASummaryRestServer(QARestServer):
    """(reference: servers.py:193)"""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            self.rag.SummarizeQuerySchema,
            self.rag.summarize_query,
        )
        self.serve(
            "/v2/summarize",
            self.rag.SummarizeQuerySchema,
            self.rag.summarize_query,
        )
