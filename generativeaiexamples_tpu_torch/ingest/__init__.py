"""Document ingestion: loaders and text splitters (the reference's bulk
pipeline, ``ingest/pipeline.py``, is not ported: ``ROADMAP.md``)."""

from generativeaiexamples_tpu_torch.ingest.loaders import load_document
from generativeaiexamples_tpu_torch.ingest.splitters import (
    CharacterSplitter,
    MarkdownSplitter,
    PythonCodeSplitter,
    RecursiveCharacterSplitter,
    TokenSplitter,
    get_text_splitter,
)

__all__ = [
    "load_document",
    "CharacterSplitter",
    "MarkdownSplitter",
    "PythonCodeSplitter",
    "RecursiveCharacterSplitter",
    "TokenSplitter",
    "get_text_splitter",
]
