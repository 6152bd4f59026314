"""The port's own copy of ``pathway_tpu/xpacks/llm/parsers.py``
(``Utf8Parser``, ``PypdfParser``, the native partitioner and chunkers,
``UnstructuredParser``, ``DoclingParser``, ``ImageParser``, ``SlideParser``).

Parsers are UDFs bytes -> list[tuple[str, dict]] (text, metadata).
Partitioning and all five chunking modes are plain Python (no optional
dependency for text/markdown inputs). ``pypdf``, ``unstructured`` and
``docling`` are imported only inside the function that uses them, as in
the reference, and each path falls back to the native partitioner exactly
where the reference does.
"""

from __future__ import annotations

import io
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Literal

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.udfs import UDF

ChunkingMode = Literal["single", "elements", "paged", "basic", "by_title"]


class Utf8Parser(UDF):
    """Decode bytes as UTF-8."""

    def __init__(self, **kwargs):
        super().__init__(return_type=list, **kwargs)
        self._prepare(self.parse)

    def parse(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        if isinstance(contents, str):
            return [(contents, {})]
        return [(contents.decode("utf-8", errors="replace"), {})]

    @property
    def func(self):
        return self.parse


ParseUtf8 = Utf8Parser


class PypdfParser(UDF):
    """PDF text extraction via pypdf."""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs):
        self.apply_text_cleanup = apply_text_cleanup
        super().__init__(return_type=list, **kwargs)
        self._prepare(self.parse)

    def parse(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        try:
            from pypdf import PdfReader  # type: ignore[import-not-found]
        except ImportError as exc:
            raise ImportError("PypdfParser requires `pypdf`") from exc

        reader = PdfReader(io.BytesIO(contents))
        out = []
        for i, page in enumerate(reader.pages):
            text = page.extract_text() or ""
            if self.apply_text_cleanup:
                text = " ".join(text.split())
            out.append((text, {"page": i}))
        return out

    @property
    def func(self):
        return self.parse


# ---------------------------------------------------------------------------
# Native partitioning: bytes -> typed elements


@dataclass
class Element:
    """One partitioned document element (the `unstructured` Element
    analog: text + category + metadata incl. page_number)."""

    text: str
    category: str = "NarrativeText"
    metadata: dict = field(default_factory=dict)

    def __str__(self) -> str:
        return self.text


_LIST_RE = re.compile(r"^\s*([-*•]|\d+[.)])\s+")


def _looks_like_table(lines: list[str]) -> bool:
    if len(lines) < 2:
        return False
    piped = sum(1 for l in lines if l.count("|") >= 2)
    return piped >= max(2, len(lines) - 1)


def _table_to_html(lines: list[str]) -> str:
    rows = []
    for l in lines:
        cells = [c.strip() for c in l.strip().strip("|").split("|")]
        if all(re.fullmatch(r":?-{2,}:?", c or "--") for c in cells):
            continue  # markdown separator row
        rows.append("".join(f"<td>{c}</td>" for c in cells))
    return "<table>" + "".join(f"<tr>{r}</tr>" for r in rows) + "</table>"


def _classify_block(block: str) -> Element:
    lines = block.splitlines()
    stripped = block.strip()
    if _looks_like_table(lines):
        return Element(
            stripped, "Table", {"text_as_html": _table_to_html(lines)}
        )
    if _LIST_RE.match(stripped):
        return Element(stripped, "ListItem")
    first = lines[0].strip()
    if first.startswith("#"):
        return Element(stripped.lstrip("# ").strip(), "Title")
    if (
        len(lines) == 1
        and 0 < len(first) <= 80
        and not first.endswith((".", ",", ";", ":"))
        and (first.isupper() or first.istitle())
    ):
        return Element(stripped, "Title")
    return Element(stripped, "NarrativeText")


def _partition_text(text: str, page_number: int = 1) -> list[Element]:
    """Blank-line blocks classified into Title/ListItem/Table/Narrative;
    form feeds advance the page number."""
    out: list[Element] = []
    for page_offset, page in enumerate(text.split("\f")):
        pno = page_number + page_offset
        for block in re.split(r"\n\s*\n", page):
            if not block.strip():
                continue
            el = _classify_block(block)
            el.metadata.setdefault("page_number", pno)
            out.append(el)
    return out


def native_partition(
    contents: bytes, filename: str | None = None
) -> list[Element]:
    """bytes -> elements without optional dependencies: PDFs page by page
    via pypdf when available, everything else as (decoded) text."""
    if contents[:5] == b"%PDF-":
        try:
            from pypdf import PdfReader

            reader = PdfReader(io.BytesIO(contents))
            out: list[Element] = []
            for i, page in enumerate(reader.pages):
                out.extend(_partition_text(page.extract_text() or "", i + 1))
            return out
        except ImportError:
            pass
    try:
        text = contents.decode("utf-8")
    except UnicodeDecodeError:
        text = contents.decode("latin-1")
    return _partition_text(text)


# ---------------------------------------------------------------------------
# Native chunking (reference: unstructured.chunking basic/title)


def _merge_chunk_meta(left: dict, right: dict) -> dict:
    links = left.pop("links", []) + right.pop("links", [])
    languages = list(set(left.pop("languages", []) + right.pop("languages", [])))
    result = {**left, **right}
    if links:
        result["links"] = links
    if languages:
        result["languages"] = languages
    for k in ("coordinates", "parent_id", "category_depth", "category"):
        result.pop(k, None)
    return result


def chunk_elements_basic(
    elements: list[Element],
    max_characters: int = 500,
    new_after_n_chars: int | None = None,
    overlap: int = 0,
    **_kwargs: Any,
) -> list[Element]:
    """Pack consecutive elements into chunks of at most `max_characters`
    (soft-break after new_after_n_chars); oversized elements split hard
    with `overlap` characters carried between splits."""
    soft = new_after_n_chars or max_characters
    # an overlap >= max_characters would never shrink the remainder
    overlap = max(0, min(overlap, max_characters - 1))
    chunks: list[Element] = []
    cur_text: list[str] = []
    cur_meta: dict = {}
    cur_len = 0

    def flush():
        nonlocal cur_text, cur_meta, cur_len
        if cur_text:
            chunks.append(
                Element("\n\n".join(cur_text), "CompositeElement", cur_meta)
            )
        cur_text, cur_meta, cur_len = [], {}, 0

    for el in elements:
        text = el.text
        while len(text) > max_characters:
            flush()
            chunks.append(
                Element(
                    text[:max_characters], "CompositeElement", dict(el.metadata)
                )
            )
            start = max_characters - overlap if overlap else max_characters
            text = text[start:]
        if cur_len + len(text) + 2 > soft:
            flush()
        cur_text.append(text)
        cur_meta = _merge_chunk_meta(cur_meta, dict(el.metadata))
        cur_len += len(text) + 2
    flush()
    return chunks


def chunk_by_title(
    elements: list[Element],
    max_characters: int = 500,
    **kwargs: Any,
) -> list[Element]:
    """Like basic chunking, but a Title element always starts a new chunk
    (section-aware splitting, reference: unstructured chunk_by_title)."""
    sections: list[list[Element]] = []
    cur: list[Element] = []
    for el in elements:
        if el.category == "Title" and cur:
            sections.append(cur)
            cur = []
        cur.append(el)
    if cur:
        sections.append(cur)
    out: list[Element] = []
    for section in sections:
        out.extend(
            chunk_elements_basic(
                section, max_characters=max_characters, **kwargs
            )
        )
    return out


class UnstructuredParser(UDF):
    """Partition + chunk documents.

    chunking_mode:
      - "single": whole document as one chunk
      - "elements": one chunk per partitioned element
      - "paged": one chunk per page
      - "basic": max_characters-packed chunks
      - "by_title": section-aware chunks starting at titles
    Partitioning uses the `unstructured` library when installed, else the
    native partitioner (text/markdown/PDF-via-pypdf)."""

    _CHUNKING_MODES = ("single", "elements", "paged", "basic", "by_title")

    def __init__(
        self,
        chunking_mode: ChunkingMode = "single",
        partition_kwargs: dict | None = None,
        post_processors: list[Callable] | None = None,
        chunking_kwargs: dict | None = None,
        mode: str | None = None,  # legacy alias for chunking_mode
        **kwargs: Any,
    ):
        if mode is not None:
            chunking_mode = mode  # type: ignore[assignment]
        self._validate_chunking_mode(chunking_mode)
        self.chunking_mode = chunking_mode
        self.partition_kwargs = partition_kwargs or {}
        self.post_processors = list(post_processors or [])
        self.chunking_kwargs = chunking_kwargs or {}
        super().__init__(return_type=list, **kwargs)
        self._prepare(self.parse)

    @classmethod
    def _validate_chunking_mode(cls, chunking_mode) -> None:
        if chunking_mode not in cls._CHUNKING_MODES:
            raise ValueError(
                f"Got {chunking_mode} for `chunking_mode`, but should be "
                f"one of `{cls._CHUNKING_MODES}`"
            )

    def _combine_metadata(self, left: dict, right: dict) -> dict:
        return _merge_chunk_meta(dict(left), dict(right))

    @staticmethod
    def _extract_element_meta(element) -> tuple[str, dict]:
        meta_obj = getattr(element, "metadata", None)
        if meta_obj is not None and not isinstance(meta_obj, dict):
            metadata = meta_obj.to_dict()
        else:
            metadata = dict(meta_obj or {})
        if getattr(element, "category", None):
            metadata["category"] = element.category
        return str(element), metadata

    def _as_native(self, elements: list) -> list[Element]:
        out = []
        for e in elements:
            text, meta = self._extract_element_meta(e)
            out.append(
                Element(text, meta.get("category", "NarrativeText"), meta)
            )
        return out

    def _partition(self, contents: bytes) -> list:
        try:
            from unstructured.partition.auto import (  # type: ignore[import-not-found]
                partition,
            )

            return partition(
                file=io.BytesIO(contents), **self.partition_kwargs
            )
        except ImportError:
            return native_partition(contents)

    def _chunk(
        self,
        elements: list,
        chunking_mode: ChunkingMode | None = None,
        chunking_kwargs: dict | None = None,
    ) -> list[tuple[str, dict]]:
        chunking_mode = chunking_mode or self.chunking_mode
        chunking_kwargs = {**self.chunking_kwargs, **(chunking_kwargs or {})}
        if chunking_mode == "basic":
            return [
                self._extract_element_meta(el)
                for el in chunk_elements_basic(
                    self._as_native(elements), **chunking_kwargs
                )
            ]
        if chunking_mode == "by_title":
            return [
                self._extract_element_meta(el)
                for el in chunk_by_title(
                    self._as_native(elements), **chunking_kwargs
                )
            ]
        if chunking_mode == "elements":
            return [self._extract_element_meta(el) for el in elements]
        if chunking_mode == "paged":
            text_by_page: dict[int, str] = {}
            meta_by_page: dict[int, dict] = {}
            for element in elements:
                text, metadata = self._extract_element_meta(element)
                page = metadata.get("page_number", 1)
                text_by_page[page] = text_by_page.get(page, "") + text + "\n\n"
                meta_by_page[page] = self._combine_metadata(
                    meta_by_page.get(page, {}), metadata
                )
            return [
                (text_by_page[p], meta_by_page[p]) for p in sorted(text_by_page)
            ]
        # single
        metadata: dict = {}
        for element in elements:
            metadata = self._combine_metadata(
                metadata, self._extract_element_meta(element)[1]
            )
        return [("\n\n".join(str(el) for el in elements), metadata)]

    def parse(
        self,
        contents: bytes,
        chunking_mode: ChunkingMode | None = None,
        **kwargs: Any,
    ) -> list[tuple[str, dict]]:
        elements = self._partition(contents)
        for post in self.post_processors:
            elements = [post(e) for e in elements]
        return self._chunk(
            elements, chunking_mode, kwargs.get("chunking_kwargs")
        )

    @property
    def func(self):
        return self.parse

    def __call__(self, contents: Any, **kwargs) -> expr_mod.ColumnExpression:
        return super().__call__(contents, **kwargs)


class ParseUnstructured(UnstructuredParser):
    def __init__(self, *args, **kwargs):
        import warnings

        warnings.warn(
            "This class is deprecated, use `UnstructuredParser` instead."
        )
        super().__init__(*args, **kwargs)


class DoclingParser(UnstructuredParser):
    """Markdown document conversion. Uses
    `docling` when installed; otherwise converts natively partitioned
    elements to markdown (titles -> #, tables kept as pipes)."""

    def __init__(self, chunking_mode: ChunkingMode = "single", **kwargs):
        super().__init__(chunking_mode=chunking_mode, **kwargs)

    def _partition(self, contents: bytes) -> list:
        try:
            from docling.document_converter import (  # type: ignore[import-not-found]
                DocumentConverter,
            )

            conv = DocumentConverter()
            result = conv.convert(io.BytesIO(contents))
            md = result.document.export_to_markdown()
            return _partition_text(md)
        except ImportError:
            elements = native_partition(contents)
            for el in elements:
                if el.category == "Title" and not el.text.startswith("#"):
                    el.text = f"# {el.text}"
            return elements


class ImageParser(UDF):
    """Describe an image with a vision LLM.
    `llm` is any callable/UDF taking (prompt, image_bytes) -> str; table
    and schema extraction ride the prompt."""

    DEFAULT_PROMPT = "Describe the contents of this image in detail."

    def __init__(
        self,
        llm: Any = None,
        parse_prompt: str | None = None,
        **kwargs: Any,
    ):
        self.llm = llm
        self.parse_prompt = parse_prompt or self.DEFAULT_PROMPT
        super().__init__(return_type=list, **kwargs)
        self._prepare(self.parse)

    def _describe(self, contents: bytes) -> str:
        if self.llm is None:
            raise ValueError(
                "ImageParser needs a vision `llm` callable "
                "(prompt, image_bytes) -> str"
            )
        from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync, _unwrap_udf

        return str(
            _coerce_sync(_unwrap_udf(self.llm))(self.parse_prompt, contents)
        )

    def parse(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        return [(self._describe(contents), {"parser": "image"})]

    @property
    def func(self):
        return self.parse


class SlideParser(ImageParser):
    """Per-slide/page vision parsing: PDFs are
    split into single-page documents, each one goes through the vision LLM
    separately, keeping page metadata."""

    def parse(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        pages: list[bytes]
        if contents[:5] == b"%PDF-":
            try:
                from pypdf import PdfReader, PdfWriter

                reader = PdfReader(io.BytesIO(contents))
                pages = []
                for page in reader.pages:
                    writer = PdfWriter()
                    writer.add_page(page)
                    buf = io.BytesIO()
                    writer.write(buf)
                    pages.append(buf.getvalue())
            except ImportError:
                pages = [contents]
        else:
            pages = [contents]
        docs = []
        for i, page_bytes in enumerate(pages):
            docs.append(
                (
                    self._describe(page_bytes),
                    {"page_number": i + 1, "parser": "slide"},
                )
            )
        return docs
