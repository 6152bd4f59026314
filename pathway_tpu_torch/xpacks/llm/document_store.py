"""The port's own copy of ``pathway_tpu/xpacks/llm/document_store.py``:
``DocumentStore``, the ``VectorStoreServer`` pipeline over any retriever
factory — the dense ones (``BruteForceKnnFactory``, ``UsearchKnnFactory``,
``TpuKnnFactory``), ``LshKnnFactory``, ``IvfKnnFactory``,
``TantivyBM25Factory`` and ``HybridIndexFactory`` over any of them; each
index factory that places data has its own ``device=``. It shares the
store's parse/split pipeline, and so also counts
``pathway_vector_store_chunks_total`` and records ``vector_store.chunk``
spans, which the JAX package's copy of the pipeline does not."""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import pathway_tpu_torch.reducers as reducers
from pathway_tpu_torch.internals.common import apply_with_type, if_else
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import right
from pathway_tpu_torch.stdlib.indexing.colnames import _SCORE
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer


class DocumentStore(VectorStoreServer):
    """Indexing pipeline + queries over an arbitrary retriever factory."""

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: AbstractRetrieverFactory,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: Sequence[Callable] | None = None,
    ):
        self.retriever_factory = retriever_factory
        if isinstance(docs, Table):
            docs = [docs]
        # VectorStoreServer.__init__ builds the graph; embedder lives inside
        # the retriever factory for DocumentStore
        self.docs = list(docs)
        self.parser = parser
        self.splitter = splitter
        self.doc_post_processors = list(doc_post_processors or [])
        self.embedding_dimension = None
        self._index_params = {}
        self._init_metrics()
        self._graph = self._build_graph()

    def _build_graph(self) -> dict:
        # the store's parse/post-proc/split pipeline, then raw text indexed
        # through the retriever factory (which applies its own embedder)
        docs, chunked_docs = self._chunk_documents()
        index = self.retriever_factory.build_index(
            chunked_docs.text,
            chunked_docs,
            metadata_column=chunked_docs.metadata,
        )
        return {
            "docs": docs,
            "chunked_docs": chunked_docs,
            "embedded": chunked_docs,
            "index": index,
        }

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        queries = self.merge_filters(retrieval_queries)
        jr = self.index.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            metadata_filter=queries.metadata_filter,
        )
        raw = jr.select(
            texts=right["text"],
            metas=right["metadata"],
            scores=right[_SCORE],
        )

        def fmt(texts, metas, scores) -> Json:
            out = []
            if texts is not None:
                for t, m, s in zip(texts, metas, scores):
                    out.append(
                        {
                            "text": t,
                            "metadata": m.value if isinstance(m, Json) else m,
                            "dist": -float(s),
                            "score": float(s),
                        }
                    )
            return Json(out)

        return raw.select(
            result=apply_with_type(fmt, Json, raw.texts, raw.metas, raw.scores)
        )

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        parsed = self._graph["chunked_docs"]
        collected = parsed.reduce(
            texts=reducers.tuple(parsed.text),
            metas=reducers.tuple(parsed.metadata),
        )
        joined = parse_docs_queries.join_left(
            collected.with_columns(_one=1),
            if_else(parse_docs_queries.id == parse_docs_queries.id, 1, 1)
            == right["_one"],
            id=parse_docs_queries.id,
        )

        def fmt(texts, metas) -> Json:
            out = []
            for t, m in zip(texts or (), metas or ()):
                out.append(
                    {"text": t, "metadata": m.value if isinstance(m, Json) else m}
                )
            return Json(out)

        return joined.select(
            result=apply_with_type(fmt, Json, right["texts"], right["metas"])
        )
