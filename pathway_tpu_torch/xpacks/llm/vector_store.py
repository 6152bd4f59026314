"""The port's own copy of ``pathway_tpu/xpacks/llm/vector_store.py``:
``VectorStoreServer`` (a live document index: parse → post-process →
split → embed → ``DataIndex``), its retrieve/statistics/inputs queries, and
``VectorStoreClient``.

The chunks' vectors live on ``device`` (default ``"cuda"``): the store
passes it to the ``USearchKnn`` it builds, so every retrieval is one launch
of the hand-written block top-k kernel per tick's query batch. Without a
card it raises unless ``device="cpu"`` is passed. The embedder keeps its
own ``device=``. ``run_server`` serves the three queries over REST
(``/v1/retrieve``, ``/v1/statistics``, ``/v1/inputs``) on the port's stdlib
server, and ``drain`` shuts it down gracefully.
``VectorStoreClient`` imports ``requests`` only when it posts."""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Sequence

import pathway_tpu_torch as pw
import pathway_tpu_torch.reducers as reducers
from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.internals import dtype as dtp
from pathway_tpu_torch.internals.common import apply_with_type, if_else
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.schema import column_definition
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import right, this
from pathway_tpu_torch.observability import REGISTRY
from pathway_tpu_torch.observability.tracing import get_tracer
from pathway_tpu_torch.stdlib.indexing._filters import compile_filter
from pathway_tpu_torch.stdlib.indexing.colnames import _SCORE
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    USearchKnn,
    USearchMetricKind,
)
from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync, _unwrap_udf


def _coerce_doc_tuple(value: Any) -> tuple:
    """Normalize splitter/parser output entries to (text, metadata-dict)."""
    if isinstance(value, (tuple, list)):
        text = value[0]
        meta = value[1] if len(value) > 1 else {}
    else:
        text, meta = value, {}
    if isinstance(meta, Json):
        meta = meta.value
    return str(text), dict(meta or {})


class VectorStoreServer:
    """A live document index over the tables ``docs`` (``data`` bytes or
    text, optional ``_metadata`` Json): parse → post-process → split →
    ``embedder`` → ``DataIndex`` over ``USearchKnn`` (cosine) on
    ``device``. ``retrieve_query``, ``statistics_query`` and
    ``inputs_query`` answer query tables."""

    def __init__(
        self,
        *docs: Table,
        embedder: Any,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: Sequence[Callable] | None = None,
        index_params: dict | None = None,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.docs = list(docs)
        self.embedder = embedder
        self.parser = parser
        self.splitter = splitter
        self.doc_post_processors = list(doc_post_processors or [])
        try:
            self.embedding_dimension = embedder.get_embedding_dimension()
        except Exception:
            # detect dimensionality with one raw probe call, bypassing the
            # UDF cache
            try:
                self.embedding_dimension = len(
                    _coerce_sync(_unwrap_udf(embedder))(".")
                )
            except Exception:
                self.embedding_dimension = None
        self._index_params = index_params or {}
        self._init_metrics()
        self._graph = self._build_graph()

    def _init_metrics(self) -> None:
        """The store's document-pipeline and retrieval metrics (the
        reference measures REST transport latency in io/http; these cover
        the store's stages)."""
        self._m_chunks = REGISTRY.counter(
            "pathway_vector_store_chunks_total",
            "chunks produced by the split stage (pre-embedding)",
        )
        self._m_retrievals = REGISTRY.counter(
            "pathway_vector_store_retrievals_total",
            "retrieve queries formatted",
        )
        self._m_results = REGISTRY.histogram(
            "pathway_vector_store_result_docs",
            "documents returned per retrieve query",
            buckets=(0, 1, 2, 3, 5, 10, 20, 50, 100),
        )

    # --- document pipeline ---------------------------------------------------

    def _clean_tables(self, docs: Iterable[Table]) -> list[Table]:
        out = []
        for doc in docs:
            cols = doc.column_names()
            exprs: dict[str, Any] = {"data": doc[cols[0]] if "data" not in cols else doc.data}
            if "_metadata" in cols:
                exprs["_metadata"] = doc["_metadata"]
            else:
                exprs["_metadata"] = apply_with_type(
                    lambda *_: Json({}), Json, doc[cols[0]]
                )
            out.append(doc.select(**exprs))
        return out

    def _chunk_documents(self) -> tuple[Table, Table]:
        """parse → post-process → split of the document tables: the
        concatenated ``docs`` and the non-empty ``chunked_docs`` (text,
        metadata), shared with ``DocumentStore``."""
        docs_tables = self._clean_tables(self.docs)
        if not docs_tables:
            raise ValueError("provide at least one document table")
        docs = docs_tables[0]
        if len(docs_tables) > 1:
            docs = docs.concat_reindex(*docs_tables[1:])

        parser = self.parser
        if parser is None:
            from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser

            parser = Utf8Parser()

        def parse_doc(data: Any, metadata: Any) -> list:
            raw = parser.func(data) if hasattr(parser, "func") else parser(data)
            if isinstance(metadata, Json):
                base_meta = dict(metadata.value or {})
            else:
                base_meta = dict(metadata or {})
            out = []
            for entry in raw:
                text, meta = _coerce_doc_tuple(entry)
                out.append(Json({"text": text, "metadata": {**base_meta, **meta}}))
            return out

        parsed = docs.select(
            docs_list=apply_with_type(parse_doc, list, docs.data, docs._metadata)
        ).flatten(this.docs_list)
        parsed = parsed.select(data_json=this.docs_list)

        for processor in self.doc_post_processors:

            def post_proc(data_json: Json, _proc=processor) -> Json:
                d = data_json.value
                text, meta = _proc(d["text"], d["metadata"])
                return Json({"text": text, "metadata": meta})

            parsed = parsed.select(
                data_json=apply_with_type(post_proc, Json, this.data_json)
            )

        splitter = self.splitter
        if splitter is None:
            from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

            splitter = NullSplitter()

        m_chunks = self._m_chunks
        _tracer = get_tracer()

        def split_doc(data_json: Json) -> list:
            with _tracer.span("vector_store.chunk") as sp:
                d = data_json.value
                fn = splitter.func if hasattr(splitter, "func") else splitter
                chunks = fn(d["text"])
                out = []
                for entry in chunks:
                    text, meta = _coerce_doc_tuple(entry)
                    out.append(
                        Json(
                            {
                                "text": text,
                                "metadata": {**d["metadata"], **meta},
                            }
                        )
                    )
                sp.set_attribute("chunks", len(out))
            m_chunks.inc(len(out))
            return out

        chunked = parsed.select(
            chunks=apply_with_type(split_doc, list, this.data_json)
        ).flatten(this.chunks)
        chunked_docs = chunked.select(
            text=apply_with_type(lambda j: j.value["text"], str, this.chunks),
            metadata=apply_with_type(
                lambda j: Json(j.value["metadata"]), Json, this.chunks
            ),
        )
        return docs, chunked_docs.filter(chunked_docs.text.str.len() > 0)

    def _build_graph(self) -> dict:
        docs, chunked_docs = self._chunk_documents()
        embedded = chunked_docs.with_columns(
            embedding=self.embedder(chunked_docs.text)
        )

        inner = USearchKnn(
            embedded.embedding,
            embedded.metadata,
            dimensions=self.embedding_dimension,
            metric=USearchMetricKind.COS,
            device=self.device,
            **self._index_params,
        )
        index = DataIndex(embedded, inner)
        return {
            "docs": docs,
            "chunked_docs": chunked_docs,
            "embedded": embedded,
            "index": index,
        }

    @property
    def index(self) -> DataIndex:
        return self._graph["index"]

    # --- query schemas -------------------------------------------------------

    class StatisticsQuerySchema(pw.Schema):
        pass

    class QueryResultSchema(pw.Schema):
        result: Json

    class InputResultSchema(pw.Schema):
        result: Json

    class FilterSchema(pw.Schema):
        metadata_filter: str | None = column_definition(
            default_value=None, dtype=str
        )
        filepath_globpattern: str | None = column_definition(
            default_value=None, dtype=str
        )

    InputsQuerySchema = FilterSchema

    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int = column_definition(default_value=3, dtype=int)
        metadata_filter: str | None = column_definition(
            default_value=None, dtype=str
        )
        filepath_globpattern: str | None = column_definition(
            default_value=None, dtype=str
        )

    # --- queries -------------------------------------------------------------

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Combine metadata_filter + filepath_globpattern into one filter
        expression."""

        def combine(metadata_filter, globpattern) -> str | None:
            parts = []
            if metadata_filter:
                if "`" in metadata_filter or '"' in metadata_filter:
                    # normalize jmespath-style quoting BEFORE parsing, as
                    # upstream Pathway does: backtick
                    # literals become single-quoted, stray double quotes
                    # are dropped; plain single-quoted filters pass through
                    metadata_filter = (
                        metadata_filter.replace("'", r"\'")
                        .replace("`", "'")
                        .replace('"', "")
                    )
                parts.append(f"({metadata_filter})")
            if globpattern:
                parts.append(f"globmatch('{globpattern}', path)")
            return " && ".join(parts) if parts else None

        queries = queries.with_columns(
            metadata_filter=apply_with_type(
                combine,
                dtp.Optional_(dtp.STR),
                this.metadata_filter,
                this.filepath_globpattern,
            )
        )
        return queries.without("filepath_globpattern")

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        queries = self.merge_filters(retrieval_queries)
        emb = self.embedder(queries.query)
        queries = queries.with_columns(_q_emb=emb)
        jr = self.index.query_as_of_now(
            queries._q_emb,
            number_of_matches=queries.k,
            metadata_filter=queries.metadata_filter,
        )
        raw = jr.select(
            texts=right["text"],
            metas=right["metadata"],
            scores=right[_SCORE],
        )

        m_retrievals, m_results = self._m_retrievals, self._m_results
        _tracer = get_tracer()

        def fmt(texts, metas, scores) -> Json:
            # the last store stage a request crosses before the reply
            with _tracer.span("vector_store.retrieve") as sp:
                out = []
                if texts is not None:
                    for t, m, s in zip(texts, metas, scores):
                        out.append(
                            {
                                "text": t,
                                "metadata": (
                                    m.value if isinstance(m, Json) else m
                                ),
                                # scores are negative distances (cos - 1)
                                "dist": -float(s),
                            }
                        )
                sp.set_attribute("results", len(out))
            m_retrievals.inc()
            m_results.observe(len(out), exemplar=sp.trace_id)
            return Json(out)

        return raw.select(
            result=apply_with_type(
                fmt, Json, raw.texts, raw.metas, raw.scores
            )
        )

    def statistics_query(self, info_queries: Table) -> Table:
        stats = self._graph["chunked_docs"].reduce(
            count=reducers.count(),
        )

        def fmt(count) -> Json:
            return Json(
                {
                    "file_count": int(count) if count is not None else 0,
                    "last_modified": None,
                    "last_indexed": None,
                }
            )

        # every query joins the single global-stats row (constant join key)
        joined = info_queries.join_left(
            stats.with_columns(_one=1),
            if_else(info_queries.id == info_queries.id, 1, 1)
            == right["_one"],
            id=info_queries.id,
        )
        return joined.select(
            result=apply_with_type(fmt, Json, right["count"])
        )

    def inputs_query(self, input_queries: Table) -> Table:
        metas = self._graph["chunked_docs"].reduce(
            metas=reducers.tuple(this.metadata)
        )
        queries = self.merge_filters(input_queries)
        joined = queries.join_left(
            metas.with_columns(_one=1),
            if_else(queries.id == queries.id, 1, 1) == right["_one"],
            id=queries.id,
        )

        def fmt(metas_v, flt) -> Json:
            # the first metadata of each path, in the reducer's order. Hashable
            # paths go in a set; others (a list or dict under "path") in a
            # list compared with ==, as the reference keeps every path
            pred = compile_filter(flt) if flt else None
            seen: set = set()
            seen_unhashable: list = []
            out = []
            for m in metas_v or ():
                mv = m.value if isinstance(m, Json) else m
                if pred is not None and not pred(mv):
                    continue
                key = mv.get("path") if isinstance(mv, dict) else str(mv)
                try:
                    if key in seen:
                        continue
                    seen.add(key)
                except TypeError:
                    if key in seen_unhashable:
                        continue
                    seen_unhashable.append(key)
                out.append(mv)
            return Json(out)

        return joined.select(
            result=apply_with_type(
                fmt, Json, right["metas"], queries.metadata_filter
            )
        )

    # --- REST serving ------------------------------------------------------------

    def run_server(
        self,
        host: str,
        port: int,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = True,
        qos: Any = None,
        **kwargs,
    ):
        from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

        webserver = PathwayWebserver(host=host, port=port)
        self._webserver = webserver

        def serve(route, schema, handler):
            queries, writer = rest_connector(
                webserver=webserver,
                route=route,
                schema=schema,
                methods=("GET", "POST"),
                delete_completed_queries=True,
                qos=qos,
            )
            result = handler(queries)
            writer(result.select(query_id=result.id, result=result.result))

        serve("/v1/retrieve", self.RetrieveQuerySchema, self.retrieve_query)
        serve("/v1/statistics", self.StatisticsQuerySchema, self.statistics_query)
        serve("/v1/inputs", self.InputsQuerySchema, self.inputs_query)

        def run():
            pw.run(terminate_on_error=terminate_on_error)

        if threaded:
            t = threading.Thread(target=run, daemon=True, name="VectorStoreServer")
            t.start()
            return t
        run()

    def drain(self, grace_s: float | None = None) -> bool:
        """Graceful shutdown of a running ``run_server``: stop admitting,
        flush in-flight micro-batches, answer every admitted query, then
        close the webserver (requires ``qos=`` to have enabled the gate;
        ungated servers just stop the listener)."""
        ws = getattr(self, "_webserver", None)
        if ws is None:
            return True
        return ws.drain(grace_s)

    def __repr__(self):
        return f"VectorStoreServer({self.embedder!r})"


class VectorStoreClient:
    """HTTP client for a ``VectorStoreServer`` served over REST."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int = 15,
        additional_headers: dict | None = None,
    ):
        if url is None:
            url = f"http://{host}:{port}"
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.headers = additional_headers or {}

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        import requests

        resp = requests.post(
            f"{self.url}/v1/retrieve",
            json={
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
            headers=self.headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        return resp.json()

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        import requests

        resp = requests.post(
            f"{self.url}/v1/statistics",
            json={},
            headers=self.headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        return resp.json()

    def get_input_files(
        self,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list:
        import requests

        resp = requests.post(
            f"{self.url}/v1/inputs",
            json={
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
            headers=self.headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        return resp.json()
