"""Multimodal RAG pipeline: PDFs/PPTX with tables, images, and charts
(port of the JAX package's ``chains/multimodal.py``).

Parity with the reference's ``multimodal_rag`` example
(``examples/multimodal_rag/chains.py``): ingestion routes documents
through the multimodal parsers, describes every image with the vision
analyst (charts additionally get a DePlot-style linearized data table),
and indexes text blocks, table linearizations, and captions as chunks.
The answering path (retrieve -> context concat -> streamed generation) is
inherited from :class:`QAChatbot` — only ingestion is multimodal-specific.
"""

from __future__ import annotations

import os

from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot
from generativeaiexamples_tpu_torch.chains.factory import get_embedder, get_store
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.core.tracing import traced
from generativeaiexamples_tpu_torch.engine.vision_service import get_vision_analyst
from generativeaiexamples_tpu_torch.ingest.loaders import load_document
from generativeaiexamples_tpu_torch.ingest.splitters import RecursiveCharacterSplitter
from generativeaiexamples_tpu_torch.retrieval.base import Chunk

logger = get_logger(__name__)

# Reference multimodal updater uses RecursiveCharacterTextSplitter(1000/100)
# (``vectorstore/vectorstore_updater.py:49-59``).
_CHUNK_SIZE = 1000
_CHUNK_OVERLAP = 100


class MultimodalRAG(QAChatbot):
    """RAG over documents containing text, tables, images, and charts."""

    @staticmethod
    def prepare(device=None) -> None:
        """Build the vision analyst on ``device`` before serving (the chain
        server calls this with its own device)."""
        get_vision_analyst(device)

    def __init__(self) -> None:
        super().__init__()
        self._mm_splitter = RecursiveCharacterSplitter(
            chunk_size=_CHUNK_SIZE, chunk_overlap=_CHUNK_OVERLAP
        )

    def _segments(self, file_path: str) -> list[tuple[str, str]]:
        """(kind, text) units for any supported file type."""
        ext = os.path.splitext(file_path)[1].lower()
        analyst = get_vision_analyst()
        out: list[tuple[str, str]] = []

        def add_image(image, caption: str) -> None:
            graph = analyst.is_graph(image)
            description = analyst.describe_image(image)
            if graph:
                table = analyst.chart_to_table(image)
                out.append(
                    (
                        "chart",
                        f"Chart: {caption}\n{description}\nData table:\n{table}",
                    )
                )
            else:
                out.append(("image", f"Image: {caption}\n{description}"))

        if ext == ".pdf":
            from generativeaiexamples_tpu_torch.ingest.multimodal_pdf import parse_pdf

            for seg in parse_pdf(file_path):
                if seg.kind == "image" and seg.image is not None:
                    add_image(seg.image, seg.text)
                elif seg.kind == "table":
                    out.append(("table", f"Table:\n{seg.text}"))
                else:
                    out.append(("text", seg.text))
        elif ext == ".pptx":
            from generativeaiexamples_tpu_torch.ingest.pptx import parse_pptx

            for slide in parse_pptx(file_path):
                text = slide.text
                if slide.notes:
                    text += f"\n[notes] {slide.notes}"
                if text.strip():
                    out.append(("text", text))
                for img in slide.images:
                    add_image(img, slide.text[:200])
        else:
            out.append(("text", load_document(file_path)))
        return out

    @traced("ingest_docs")
    def ingest_docs(self, file_path: str, filename: str) -> None:
        chunks: list[Chunk] = []
        for kind, text in self._segments(file_path):
            if not text.strip():
                continue
            if kind == "text":
                pieces = self._mm_splitter.split(text)
            else:
                pieces = [text]  # tables/captions stay whole
            chunks.extend(
                Chunk(text=p, source=filename, metadata={"kind": kind})
                for p in pieces
            )
        if not chunks:
            logger.warning("%s produced no chunks", filename)
            return
        embeddings = get_embedder().embed_documents([c.text for c in chunks])
        get_store().add(chunks, embeddings)
        logger.info("ingested %s: %d multimodal chunks", filename, len(chunks))
