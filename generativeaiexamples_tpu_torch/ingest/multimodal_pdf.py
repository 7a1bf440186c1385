"""Multimodal PDF parsing: text blocks, tables, and embedded images (port
of the JAX package's ``ingest/multimodal_pdf.py``; ``re`` and ``zlib``,
with numpy for images where PIL is absent).

Per-page text grouped into <=500-char blocks, header/footer removal (lines
repeated at the top or bottom of most pages), tables from aligned
multi-column text runs, images decoded straight from PDF image XObjects
with a caption from the text of their page, and an OCR fallback for
documents with images but no text layer (gated on pytesseract, as in the
reference).

Images are PIL images where PIL imports, as the reference's.  Without
PIL, FlateDecode and raw ``/DeviceRGB`` / ``/DeviceGray`` XObjects decode
with ``zlib`` and numpy into (H, W, 3) uint8 arrays, the same pixels as
``np.asarray`` of the reference's image, and DCTDecode (JPEG) streams are
skipped with a warning (the reference returns no image without PIL).
"""

from __future__ import annotations

import dataclasses
import io
import re
import zlib
from collections import Counter
from typing import Optional

import numpy as np

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.ingest.pdf import _text_from_content

logger = get_logger(__name__)

MAX_BLOCK_CHARS = 500  # reference char-block grouping cap
_TABLE_SPLIT = re.compile(r"\t|\s{2,}|\s?\|\s?")

_OBJ_RE = re.compile(
    rb"(\d+)\s+(\d+)\s+obj\s*(<<.*?>>)\s*stream\r?\n(.*?)\r?\nendstream",
    re.S,
)
_ANY_STREAM_RE = re.compile(
    rb"<<(.*?)>>\s*stream\r?\n(.*?)\r?\nendstream", re.S
)


@dataclasses.dataclass
class Segment:
    """One extracted unit of a document."""

    kind: str  # "text" | "table" | "image"
    text: str  # block text, linearized table, or image caption
    page: int
    image: Optional[object] = None  # PIL.Image or (H, W, 3) uint8 array for kind == "image"


def _dict_value(d: bytes, key: bytes) -> Optional[bytes]:
    m = re.search(re.escape(key) + rb"\s*(/?\w+|\d+)", d)
    return m.group(1) if m else None


def _decode_image(obj_dict: bytes, raw: bytes):
    """PDF image XObject -> PIL.Image (where PIL imports) or an (H, W, 3)
    uint8 array, or None for unsupported filters."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    filt = obj_dict
    if b"/DCTDecode" in filt:
        if Image is None:
            logger.warning("skipping a DCTDecode (JPEG) image: PIL is not installed")
            return None
        try:
            return Image.open(io.BytesIO(raw)).convert("RGB")
        except Exception:
            return None
    if b"/FlateDecode" in filt or b"Filter" not in filt:
        width = _dict_value(obj_dict, b"/Width")
        height = _dict_value(obj_dict, b"/Height")
        if not width or not height:
            return None
        w, h = int(width), int(height)
        try:
            data = zlib.decompress(raw) if b"/FlateDecode" in filt else raw
        except Exception:
            return None
        if b"/DeviceRGB" in obj_dict and len(data) >= w * h * 3:
            if Image is not None:
                return Image.frombytes("RGB", (w, h), data[: w * h * 3])
            return np.frombuffer(data, np.uint8, w * h * 3).reshape(h, w, 3).copy()
        if b"/DeviceGray" in obj_dict and len(data) >= w * h:
            if Image is not None:
                return Image.frombytes("L", (w, h), data[: w * h]).convert("RGB")
            return np.repeat(np.frombuffer(data, np.uint8, w * h).reshape(h, w, 1), 3, axis=2)
    return None


def extract_images(data: bytes) -> list[tuple[int, object]]:
    """Decodable image XObjects in document order as (byte_offset, image)."""
    images = []
    for m in _OBJ_RE.finditer(data):
        obj_dict, raw = m.group(3), m.group(4)
        if b"/Subtype" in obj_dict and b"/Image" in obj_dict:
            img = _decode_image(obj_dict, raw)
            if img is not None:
                images.append((m.start(), img))
    return images


def _page_texts(data: bytes) -> list[tuple[int, list[str]]]:
    """Per-content-stream (byte_offset, text lines) — our page granularity."""
    pages: list[tuple[int, list[str]]] = []
    for m in _ANY_STREAM_RE.finditer(data):
        obj_dict, raw = m.group(1), m.group(2)
        if b"/Image" in obj_dict:
            continue
        content = raw
        try:
            content = zlib.decompress(raw)
        except Exception:
            pass
        if b"Tj" not in content and b"TJ" not in content:
            continue
        lines: list[str] = []
        for block in _text_from_content(content):
            lines.extend(l for l in block.splitlines() if l.strip())
        if lines:
            pages.append((m.start(), lines))
    return pages


def _strip_page_furniture(
    pages: list[list[str]],
) -> list[list[str]]:
    """Drop headers/footers: short lines repeated across most pages
    (equivalent of the reference's 10%/90% page-height crop)."""
    if len(pages) < 3:
        return pages
    counts = Counter()
    for lines in pages:
        for l in set(lines[:2] + lines[-2:]):
            if len(l) < 80:
                counts[l] += 1
    furniture = {l for l, c in counts.items() if c >= max(3, len(pages) // 2)}
    if furniture:
        logger.info("dropping %d repeated header/footer lines", len(furniture))

    def strip(lines: list[str]) -> list[str]:
        # Only remove occurrences in the same top/bottom window the counter
        # sampled — a running head repeated mid-page (e.g. a chapter title
        # as a body heading) is real content and must survive.
        out = list(lines)
        head = min(2, len(out))
        for i in range(head):
            if out[i] in furniture:
                out[i] = None
        for i in range(max(len(out) - 2, head), len(out)):
            if out[i] in furniture:
                out[i] = None
        return [l for l in out if l is not None]

    return [strip(lines) for lines in pages]


def _is_table_row(line: str) -> bool:
    parts = [p for p in _TABLE_SPLIT.split(line.strip()) if p]
    return len(parts) >= 2


def _segment_page(lines: list[str], page: int) -> list[Segment]:
    """Group lines into text blocks (<=500 chars) and table runs."""
    segments: list[Segment] = []
    block: list[str] = []
    table: list[str] = []

    def flush_block():
        if block:
            segments.append(Segment("text", "\n".join(block), page))
            block.clear()

    def flush_table():
        if len(table) >= 2:
            rows = [
                " | ".join(p for p in _TABLE_SPLIT.split(l.strip()) if p)
                for l in table
            ]
            segments.append(Segment("table", "\n".join(rows), page))
        else:
            block.extend(table)
        table.clear()

    for line in lines:
        if _is_table_row(line):
            if not table:
                flush_block()
            table.append(line)
            continue
        flush_table()
        if sum(len(b) for b in block) + len(line) > MAX_BLOCK_CHARS:
            flush_block()
        block.append(line)
    flush_table()
    flush_block()
    return segments


def _page_caption(segments: list[Segment], page: int) -> str:
    """Caption an image from text on its own page, falling back to the
    document opening (reference pattern: caption from surrounding text)."""
    for seg in segments:
        if seg.kind == "text" and seg.page == page and seg.text.strip():
            return seg.text[:200]
    for seg in segments:
        if seg.kind == "text" and seg.text.strip():
            return seg.text[:200]
    return ""


def _ocr_page_images(images: list) -> list[str]:
    """OCR fallback when a page has images but no text layer; gated on
    pytesseract availability exactly like the reference's tesseract dep."""
    try:
        import pytesseract  # noqa: F401
    except Exception:
        logger.warning("no text layer and pytesseract unavailable; skipping OCR")
        return []
    out = []
    for img in images:
        try:
            text = pytesseract.image_to_string(img)
            if text.strip():
                out.append(text.strip())
        except Exception:
            logger.exception("OCR failed")
    return out


def parse_pdf(path: str) -> list[Segment]:
    """Full multimodal parse: text blocks, tables, and images with captions."""
    with open(path, "rb") as fh:
        data = fh.read()

    located = _page_texts(data)
    offsets = [off for off, _ in located]
    pages = _strip_page_furniture([lines for _, lines in located])
    segments: list[Segment] = []
    for i, lines in enumerate(pages):
        segments.extend(_segment_page(lines, page=i))

    images = extract_images(data)
    if not pages and images:
        for text in _ocr_page_images([img for _, img in images]):
            segments.append(Segment("text", text, page=0))
    for img_offset, img in images:
        # Page association: the last page whose content stream precedes the
        # image object in the file (object order tracks page order in the
        # linear writers this parser targets).
        page = 0
        for i, off in enumerate(offsets):
            if off < img_offset:
                page = i
        segments.append(
            Segment("image", _page_caption(segments, page), page=page, image=img)
        )

    logger.info(
        "parsed %s: %d text/table segments, %d images",
        path,
        sum(1 for s in segments if s.kind != "image"),
        len(images),
    )
    return segments
