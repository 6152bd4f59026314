"""The port's own copy of ``pathway_tpu/xpacks/llm/question_answering.py``:
the geometric RAG strategy, ``BaseRAGQuestionAnswerer``,
``AdaptiveRAGQuestionAnswerer``, ``DeckRetriever`` and ``RAGClient``.

The table flows (``answer_query``, ``summarize_query``, ``retrieve``,
``statistics``, ``list_documents``) are the reference's, over the port's
``VectorStoreServer``/``DocumentStore``. ``build_server`` and
``run_server`` serve them over REST on the port's stdlib server.
``RAGClient`` imports ``requests`` only when it posts."""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.schema import column_definition
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.xpacks.llm import prompts as prompt_lib


def answer_with_geometric_rag_strategy(
    questions: Sequence[str] | Any,
    documents: Sequence[Any],
    llm_chat_model: Any,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
) -> str | None:
    """Adaptive document-count loop: ask with n docs; if the model answers
    'no information', retry with n*factor docs
   ."""
    question = questions if isinstance(questions, str) else questions[0]
    n = n_starting_documents
    # strict mode instructs small open-source models to answer tersely
    # with the exact not-found marker (reference: strict_prompt on
    # answer_with_geometric_rag_strategy, question_answering.py:120)
    rules = (
        "Answer with ONLY the shortest possible phrase, or exactly "
        '"No information found." if the documents do not contain the '
        "answer."
        if strict_prompt
        else ""
    )
    for _ in range(max_iterations):
        docs = list(documents)[:n]
        prompt = prompt_lib.prompt_qa_geometric_rag(
            question, docs, additional_rules=rules
        )
        answer = llm_chat_model.func(prompt)
        if answer and "no information" not in str(answer).lower():
            return str(answer)
        if n >= len(documents):
            break
        n *= factor
    return None


def answer_with_geometric_rag_strategy_from_index(
    questions: Any,  # ColumnReference[str]
    index: Any,  # DataIndex
    documents_column: str | Any,
    llm_chat_model: Any,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    metadata_filter: Any = None,
    strict_prompt: bool = False,
):
    """Table-level adaptive RAG straight from a DataIndex: retrieve the
    maximum document count once (n_starting * factor^(max_iterations-1)),
    then per row grow the prompt's document slice geometrically until the
    LLM finds an answer.
    Returns a column of answers (None where no answer was found)."""
    from pathway_tpu_torch.internals import expression as expr_mod

    max_documents = n_starting_documents * (factor ** (max_iterations - 1))
    if isinstance(documents_column, expr_mod.ColumnReference):
        documents_column_name = documents_column.name
    else:
        documents_column_name = documents_column

    query_context = questions.table + index.query_as_of_now(
        questions,
        number_of_matches=max_documents,
        collapse_rows=True,
        metadata_filter=metadata_filter,
    ).select(
        documents_list=pw.coalesce(pw.this[documents_column_name], ()),
    )

    question_col = query_context[questions.name]
    llm = llm_chat_model

    def adaptive(question: str, docs: Any) -> str | None:
        doc_list = docs.value if isinstance(docs, Json) else list(docs or ())
        return answer_with_geometric_rag_strategy(
            question,
            list(doc_list or ()),
            llm,
            n_starting_documents,
            factor,
            max_iterations,
            strict_prompt=strict_prompt,
        )

    answered = query_context.select(
        answer=apply_with_type(
            adaptive, str | None, question_col, this.documents_list
        )
    )
    return answered.answer


def _validate_prompt_template(template: str) -> None:
    """A string prompt template must use exactly the {context} and {query}
    placeholders (reference: BaseRAGQuestionAnswerer template check)."""
    import string as _string

    fields = {
        f
        for _, f, _, _ in _string.Formatter().parse(template)
        if f is not None
    }
    if fields != {"context", "query"}:
        raise ValueError(
            "prompt_template must contain exactly the {context} and "
            f"{{query}} placeholders, got {sorted(fields)!r}"
        )


def _get_prompt_udf(prompt_template):
    """Normalize a str/callable/UDF prompt template into a
    (query, context) -> prompt UDF."""
    from pathway_tpu_torch.internals.udfs import UDF as _UDF, udf as _udf

    if prompt_template is None:
        def default_prompt(query: str, context: str) -> str:
            # the packaged QA prompt over the joined context (keeps
            # self.prompt_template and the applied prompt in agreement)
            return prompt_lib.prompt_qa(query, [context])

        return _udf(default_prompt)
    if isinstance(prompt_template, str):
        _validate_prompt_template(prompt_template)
        template = prompt_template

        def fmt(query: str, context: str) -> str:
            return template.format(context=context, query=query)

        return _udf(fmt)
    if isinstance(prompt_template, _UDF):
        return prompt_template
    if callable(prompt_template):
        return _udf(prompt_template)
    raise ValueError(
        f"prompt_template must be a string, callable or UDF, got "
        f"{type(prompt_template)!r}"
    )


class BaseQuestionAnswerer:
    AnswerQuerySchema: Any
    RetrieveQuerySchema: Any
    StatisticsQuerySchema: Any
    InputsQuerySchema: Any


class BaseRAGQuestionAnswerer(BaseQuestionAnswerer):
    """retrieve → build prompt → LLM → answer
   ."""

    def __init__(
        self,
        llm: Any,
        indexer: Any,  # VectorStoreServer | DocumentStore
        *,
        default_llm_name: str | None = None,
        prompt_template: str | Callable[[str, str], str] | Any | None = None,
        summarize_template: Callable | None = None,
        search_topk: int = 6,
    ):
        self.llm = llm
        self.indexer = indexer
        self.default_llm_name = default_llm_name
        self.search_topk = search_topk
        self.prompt_template = prompt_template or prompt_lib.prompt_qa
        # normalized (query, context)->prompt UDF (reference: prompt_udf;
        # string templates validate their placeholders at construction)
        self.prompt_udf = _get_prompt_udf(prompt_template)
        self.summarize_template = summarize_template or prompt_lib.prompt_summarize
        self.server: Any = None
        self._pending_endpoints: list = []

        class AnswerQuerySchema(pw.Schema):
            prompt: str
            filters: str | None = column_definition(default_value=None, dtype=str)
            model: str | None = column_definition(default_value=None, dtype=str)
            return_context_docs: bool = column_definition(
                default_value=False, dtype=bool
            )

        class SummarizeQuerySchema(pw.Schema):
            text_list: Json
            model: str | None = column_definition(default_value=None, dtype=str)

        self.AnswerQuerySchema = AnswerQuerySchema
        self.SummarizeQuerySchema = SummarizeQuerySchema
        self.RetrieveQuerySchema = indexer.RetrieveQuerySchema
        self.StatisticsQuerySchema = indexer.StatisticsQuerySchema
        self.InputsQuerySchema = indexer.InputsQuerySchema

    # --- table-level flows ----------------------------------------------------

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """reference: BaseRAGQuestionAnswerer.answer_query"""
        retrieve_queries = pw_ai_queries.select(
            query=this.prompt,
            k=self.search_topk,
            metadata_filter=this.filters,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(retrieve_queries)
        combined = pw_ai_queries.with_columns(
            docs=retrieved.with_universe_of(pw_ai_queries).result
        )
        prompt_udf = self.prompt_udf
        llm = self.llm

        def build_prompt(prompt: str, docs: Json) -> str:
            from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync, _unwrap_udf
            from pathway_tpu_torch.xpacks.llm.prompts import _doc_text

            doc_list = docs.value if isinstance(docs, Json) else list(docs or [])
            context = "\n\n".join(_doc_text(d) for d in (doc_list or []))
            fn = _coerce_sync(_unwrap_udf(prompt_udf))
            # dispatch on the template's own signature, so an internal
            # TypeError is never masked by a retry
            import inspect as _inspect

            try:
                sig_params = _inspect.signature(fn).parameters
                params = list(sig_params)
                has_var_kw = any(
                    p.kind is _inspect.Parameter.VAR_KEYWORD
                    for p in sig_params.values()
                )
            except (TypeError, ValueError):
                params, has_var_kw = [], False
            if "context" in params or has_var_kw:
                return str(fn(query=prompt, context=context))
            if len(params) >= 2 and params[1] in ("docs", "documents"):
                # legacy (query, docs) templates receive the list
                return str(fn(prompt, doc_list or []))
            return str(fn(prompt, context))

        with_prompt = combined.with_columns(
            _full_prompt=apply_with_type(
                build_prompt, str, this.prompt, this.docs
            )
        )
        # the chat receives role/content messages plus the query's model
        # (falling back to default_llm_name) — reference:
        # llm(prompt_chat_single_qa(...), model=coalesce(model, default))
        def to_messages(p: str):
            return ({"role": "system", "content": p},)

        msgs = apply_with_type(to_messages, Json, this._full_prompt)
        default_name = self.default_llm_name
        if default_name is not None:
            from pathway_tpu_torch.internals.common import coalesce as _coalesce

            model_expr = _coalesce(this.model, default_name)
        else:
            model_expr = this.model
        answered = with_prompt.with_columns(
            response=llm(msgs, model=model_expr)
        )

        def fmt(response, docs, return_context_docs) -> Json:
            out: dict[str, Any] = {"response": response}
            if return_context_docs:
                out["context_docs"] = (
                    docs.value if isinstance(docs, Json) else docs
                )
            return Json(out)

        return answered.select(
            result=apply_with_type(
                fmt, Json, this.response, this.docs, this.return_context_docs
            )
        )

    # alias used by reference servers
    pw_ai_query = answer_query

    def summarize_query(self, summarize_queries: Table) -> Table:
        template = self.summarize_template
        llm = self.llm

        def build(text_list: Json) -> str:
            from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync, _unwrap_udf

            tl = text_list.value if isinstance(text_list, Json) else text_list
            return str(_coerce_sync(_unwrap_udf(template))(tl or []))

        with_prompt = summarize_queries.with_columns(
            _prompt=apply_with_type(build, str, this.text_list)
        )

        def to_messages(p: str):
            return ({"role": "system", "content": p},)

        msgs = apply_with_type(to_messages, Json, this._prompt)
        default_name = self.default_llm_name
        if default_name is not None:
            from pathway_tpu_torch.internals.common import coalesce as _coalesce

            model_expr = _coalesce(this.model, default_name)
        else:
            model_expr = this.model
        answered = with_prompt.with_columns(
            response=llm(msgs, model=model_expr)
        )
        # the summarize result is the response STRING (reference:
        # summarize_query result column)
        return answered.select(result=this.response)

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: Table) -> Table:
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries: Table) -> Table:
        return self.indexer.inputs_query(queries)

    # --- serving -------------------------------------------------------------

    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        """Register the RAG REST endpoints on one webserver at
        ``host:port``; ``run_server`` then runs the graph."""
        from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

        webserver = PathwayWebserver(host=host, port=port)
        self.server = webserver

        def serve(route, schema, handler):
            queries, writer = rest_connector(
                webserver=webserver,
                route=route,
                schema=schema,
                methods=("POST",),
                delete_completed_queries=True,
            )
            result = handler(queries)
            writer(result.select(query_id=result.id, result=result.result))

        serve("/v1/pw_ai_answer", self.AnswerQuerySchema, self.answer_query)
        serve(
            "/v1/pw_ai_summary", self.SummarizeQuerySchema, self.summarize_query
        )
        serve("/v2/answer", self.AnswerQuerySchema, self.answer_query)
        serve("/v2/summarize", self.SummarizeQuerySchema, self.summarize_query)

        serve("/v1/retrieve", self.RetrieveQuerySchema, self.retrieve)
        serve("/v2/list_documents", self.InputsQuerySchema, self.list_documents)
        serve("/v1/statistics", self.StatisticsQuerySchema, self.statistics)
        serve("/v1/pw_list_documents", self.InputsQuerySchema, self.list_documents)

    def run_server(
        self,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = True,
        threaded: bool = False,
        **kwargs,
    ):
        def run():
            pw.run(terminate_on_error=terminate_on_error)

        if threaded:
            t = threading.Thread(target=run, daemon=True, name="RAGServer")
            t.start()
            return t
        run()


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Geometrically grow the retrieved-docs count until the LLM finds an
    answer."""

    def __init__(
        self,
        llm: Any,
        indexer: Any,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, pw_ai_queries: Table) -> Table:
        max_docs = self.n_starting_documents * (
            self.factor ** (self.max_iterations - 1)
        )
        retrieve_queries = pw_ai_queries.select(
            query=this.prompt,
            k=max_docs,
            metadata_filter=this.filters,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(retrieve_queries)
        combined = pw_ai_queries.with_columns(
            docs=retrieved.with_universe_of(pw_ai_queries).result
        )
        llm = self.llm
        n0, factor, iters = (
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
        )

        def adaptive(prompt: str, docs: Json) -> Json:
            doc_list = docs.value if isinstance(docs, Json) else list(docs or [])
            answer = answer_with_geometric_rag_strategy(
                prompt, doc_list or [], llm, n0, factor, iters
            )
            return Json({"response": answer})

        return combined.select(
            result=apply_with_type(adaptive, Json, this.prompt, this.docs)
        )


class DeckRetriever(BaseRAGQuestionAnswerer):
    """Slide-deck search app."""


class RAGClient:
    """HTTP client for the RAG REST API."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int = 90,
        additional_headers: dict | None = None,
    ):
        if url is None:
            url = f"http://{host}:{port}"
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.headers = additional_headers or {}

    def _post(self, route: str, payload: dict):
        import requests

        resp = requests.post(
            f"{self.url}{route}",
            json=payload,
            headers=self.headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        return resp.json()

    def answer(self, prompt: str, filters: str | None = None, **kwargs):
        return self._post(
            "/v2/answer", {"prompt": prompt, "filters": filters, **kwargs}
        )

    pw_ai_answer = answer

    def summarize(self, text_list: list[str], **kwargs):
        return self._post("/v2/summarize", {"text_list": text_list, **kwargs})

    pw_ai_summary = summarize

    def retrieve(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    def statistics(self):
        return self._post("/v1/statistics", {})

    def list_documents(self, filters: str | None = None, keys: list | None = None):
        return self._post("/v2/list_documents", {"metadata_filter": filters})

    pw_list_documents = list_documents
