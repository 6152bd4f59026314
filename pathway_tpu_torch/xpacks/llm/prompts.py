"""The port's own copy of ``pathway_tpu/xpacks/llm/prompts.py``: the prompt
templates and builders, as they are."""

from __future__ import annotations

from typing import Any, Sequence

from pathway_tpu_torch.internals.json import Json


def prompt_short_qa(context: str, query: str) -> str:
    return (
        "Please provide an answer based solely on the provided sources. "
        "Keep your answer concise and accurate.\n"
        f"Sources:\n{context}\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_qa(
    query: str,
    docs: Sequence[Any],
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
) -> str:
    ctx = "\n\n".join(_doc_text(d) for d in docs)
    return (
        "Use the below articles to answer the subsequent question. If the "
        "answer cannot be found in the articles, write "
        f'"{information_not_found_response}".{additional_rules}\n'
        f"Articles:\n{ctx}\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_qa_geometric_rag(
    query: str,
    docs: Sequence[Any],
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
) -> str:
    return prompt_qa(query, docs, information_not_found_response, additional_rules)


def prompt_summarize(text_list: Sequence[str]) -> str:
    joined = "\n".join(str(t) for t in text_list)
    return (
        "Summarize the following documents into one concise summary.\n"
        f"{joined}\nSummary:"
    )


def prompt_query_rewrite(query: str, docs: Sequence[Any] = ()) -> str:
    return (
        "Rewrite the following query to be clearer and more specific for "
        f"retrieval.\nQuery: {query}\nRewritten query:"
    )


def prompt_query_rewrite_hyde(query: str) -> str:
    return (
        "Write a short hypothetical passage that would answer the query "
        f"(HyDE).\nQuery: {query}\nPassage:"
    )


def _doc_text(d: Any) -> str:
    if isinstance(d, Json):
        d = d.value
    if isinstance(d, dict):
        return str(d.get("text", d))
    return str(d)
