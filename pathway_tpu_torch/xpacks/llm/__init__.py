"""pathway_tpu_torch.xpacks.llm — the RAG product layer, counterpart of
``pathway_tpu/xpacks/llm``: parsers, splitters, embedders, rerankers,
chats, prompts, ``VectorStoreServer``/``DocumentStore`` and the question
answerers and the REST servers over them, with the reference's names."""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    rerankers,
    splitters,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.question_answering import (
    AdaptiveRAGQuestionAnswerer,
    BaseRAGQuestionAnswerer,
    RAGClient,
    answer_with_geometric_rag_strategy,
)
from pathway_tpu_torch.xpacks.llm.servers import (
    BaseRestServer,
    DocumentStoreServer,
    QARestServer,
    QASummaryRestServer,
)
from pathway_tpu_torch.xpacks.llm.vector_store import (
    VectorStoreClient,
    VectorStoreServer,
)

__all__ = [
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "rerankers",
    "splitters",
    "DocumentStore",
    "VectorStoreServer",
    "VectorStoreClient",
    "BaseRAGQuestionAnswerer",
    "AdaptiveRAGQuestionAnswerer",
    "RAGClient",
    "answer_with_geometric_rag_strategy",
    "BaseRestServer",
    "DocumentStoreServer",
    "QARestServer",
    "QASummaryRestServer",
]
