"""Document ingestion: loaders, text splitters and the bulk pipeline."""

from generativeaiexamples_tpu_torch.ingest.loaders import load_document
from generativeaiexamples_tpu_torch.ingest.pipeline import IngestPipeline, ingest_metrics_lines
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
    "IngestPipeline",
    "MarkdownSplitter",
    "PythonCodeSplitter",
    "RecursiveCharacterSplitter",
    "TokenSplitter",
    "get_text_splitter",
    "ingest_metrics_lines",
]
