"""Text splitters (port of the JAX package's ``ingest/splitters.py``, on
the port's byte tokenizer: the HF tokenizers are ``ROADMAP.md`` Queue 1
item 5).

Parity targets (SURVEY.md §2.1/§2.2): the token-aware splitter the chain
server uses for ingestion (``SentenceTransformersTokenTextSplitter`` with
chunk 510 / overlap 200, ``common/utils.py:321-331``,
``common/configuration.py:92-101``), the recursive character splitter of the
multimodal path (1000/100, ``vectorstore_updater.py:49-59``), and the plain
character splitter of the 5-minute example (2000/200,
``examples/5_mins_rag_no_gpu/main.py``).  Implementations are our own.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

from generativeaiexamples_tpu_torch.core.configuration import AppConfig, get_config


class TextSplitter(Protocol):
    def split(self, text: str) -> list[str]: ...


class CharacterSplitter:
    """Fixed-size character windows with overlap, preferring separator
    boundaries when available."""

    def __init__(
        self, chunk_size: int = 2000, chunk_overlap: int = 200, separator: str = "\n\n"
    ) -> None:
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separator = separator

    def split(self, text: str) -> list[str]:
        if not text:
            return []
        chunks: list[str] = []
        step = self.chunk_size - self.chunk_overlap
        start = 0
        while start < len(text):
            end = min(start + self.chunk_size, len(text))
            chunk = text[start:end].strip()
            if chunk:
                chunks.append(chunk)
            if end == len(text):
                break
            start += step
        return chunks


class RecursiveCharacterSplitter:
    """Split on progressively finer separators until chunks fit.

    Separator ladder: paragraph, line, sentence, word, character — keeping
    semantic units intact when possible (multimodal path: 1000/100).
    """

    SEPARATORS = ["\n\n", "\n", ". ", " ", ""]
    # Separators that BELONG to the start of the following piece (e.g.
    # "\nclass " in the code splitter): these split with a lookahead so
    # each piece keeps its own header, instead of the suffix restoration
    # below, which would decapitate definitions at chunk boundaries.
    PREFIX_SEPARATORS: frozenset = frozenset()

    def __init__(self, chunk_size: int = 1000, chunk_overlap: int = 100) -> None:
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap

    def split(self, text: str) -> list[str]:
        pieces = self._split(text, 0)
        return self._merge(pieces)

    def _split(self, text: str, sep_idx: int) -> list[str]:
        import re as _re

        if len(text) <= self.chunk_size:
            return [text] if text.strip() else []
        if sep_idx >= len(self.SEPARATORS):
            return [text]
        sep = self.SEPARATORS[sep_idx]
        if sep == "":
            # Hard character cut.
            return [
                text[i : i + self.chunk_size]
                for i in range(0, len(text), self.chunk_size)
            ]
        prefix_mode = sep in self.PREFIX_SEPARATORS
        if prefix_mode:
            # Lookahead split: pieces retain the separator as their own
            # prefix, so no restoration is needed.
            parts = [
                p
                for p in _re.split(f"(?={_re.escape(sep)})", text)
                if p.strip()
            ]
        else:
            parts = [p for p in text.split(sep) if p.strip()]
        out: list[str] = []
        for p in parts:
            if prefix_mode:
                restored = p
            else:
                restored = (
                    p if p.endswith(sep) else p + (sep if sep != "\n\n" else "\n\n")
                )
            if len(restored) > self.chunk_size:
                out.extend(self._split(p, sep_idx + 1))
            else:
                out.append(restored)
        return out

    def _merge(self, pieces: Sequence[str]) -> list[str]:
        """Greedily pack pieces into chunks <= chunk_size with overlap."""
        chunks: list[str] = []
        current = ""
        for p in pieces:
            if current and len(current) + len(p) > self.chunk_size:
                chunks.append(current.strip())
                # Seed the next chunk with the overlap tail.
                tail = current[-self.chunk_overlap :] if self.chunk_overlap else ""
                current = tail.lstrip() + p
            else:
                current += p
        if current.strip():
            chunks.append(current.strip())
        return chunks


class PythonCodeSplitter(RecursiveCharacterSplitter):
    """Language-aware splitting for Python source.

    The separator ladder prefers top-level class/def boundaries, then
    indented defs, then blank lines — keeping whole definitions together
    when they fit (reference idiom:
    ``experimental/rag-developer-chatbot/notebooks/rapids_notebook.ipynb``
    step 3 uses LangChain's ``Language.PYTHON`` recursive splitter with
    the same boundary preference).
    """

    SEPARATORS = [
        "\nclass ",
        "\ndef ",
        "\n    def ",
        "\n\n",
        "\n",
        " ",
        "",
    ]
    PREFIX_SEPARATORS = frozenset({"\nclass ", "\ndef ", "\n    def "})


class MarkdownSplitter(RecursiveCharacterSplitter):
    """Heading-preferring splitter for markdown/rst documentation files
    (same reference notebook, docs pipeline)."""

    SEPARATORS = ["\n## ", "\n### ", "\n\n", "\n", ". ", " ", ""]
    PREFIX_SEPARATORS = frozenset({"\n## ", "\n### "})


class TokenSplitter:
    """Token-count-bounded windows with token overlap.

    The ingestion default (510/200): chunk boundaries are measured with the
    embedder's tokenizer so every chunk fits the encoder context.  The
    reference subtracts 2 from the configured size for special tokens
    (``common/utils.py:321-331``); we do the same.
    """

    def __init__(
        self,
        chunk_size: int = 510,
        chunk_overlap: int = 200,
        tokenizer=None,
        reserved_tokens: int = 2,
    ) -> None:
        # Checked against the size left after the reserved tokens: the
        # reference checks the configured size, and an overlap between the
        # two makes its window step zero or negative (an endless loop).
        if chunk_overlap >= chunk_size - reserved_tokens:
            raise ValueError("chunk_overlap must be smaller than chunk_size minus the reserved tokens")
        from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

        self.tokenizer = tokenizer or get_tokenizer(None)
        self.chunk_size = chunk_size - reserved_tokens
        self.chunk_overlap = chunk_overlap

    def split(self, text: str) -> list[str]:
        if not text.strip():
            return []
        ids = self.tokenizer.encode(text, add_bos=False)
        if not ids:
            return []
        step = self.chunk_size - self.chunk_overlap
        chunks: list[str] = []
        start = 0
        while start < len(ids):
            window = ids[start : start + self.chunk_size]
            piece = self.tokenizer.decode(window).strip()
            if piece:
                chunks.append(piece)
            if start + self.chunk_size >= len(ids):
                break
            start += step
        return chunks


def get_text_splitter(config: Optional[AppConfig] = None) -> TokenSplitter:
    """Configured ingestion splitter (reference ``get_text_splitter``)."""
    config = config or get_config()
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

    return TokenSplitter(
        chunk_size=config.text_splitter.chunk_size,
        chunk_overlap=config.text_splitter.chunk_overlap,
        tokenizer=get_tokenizer(config.text_splitter.model_name),
    )
