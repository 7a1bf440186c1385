"""Minimal dependency-free PDF text extraction (a copy of the JAX
package's ``ingest/pdf.py``: standard-library code, ``re`` and ``zlib``).

FlateDecode (zlib) content streams with ``Tj`` / ``TJ`` / ``'``
text-showing operators, which covers machine-generated PDFs (reports,
exports, LaTeX/docx output).  Scanned images, exotic filters (JBIG2,
CCITT) and CID-keyed fonts with custom CMaps are out of scope; the
multimodal parser (``ingest.multimodal_pdf``) adds images and OCR.
"""

from __future__ import annotations

import re
import zlib

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
# PDF literal string: balanced-paren-free approximation with escape support.
_STRING_RE = re.compile(rb"\((?:\\.|[^\\()])*\)")
_BT_ET_RE = re.compile(rb"BT(.*?)ET", re.S)

_ESCAPES = {
    b"n": b"\n",
    b"r": b"\r",
    b"t": b"\t",
    b"b": b"\b",
    b"f": b"\f",
    b"(": b"(",
    b")": b")",
    b"\\": b"\\",
}


def _unescape(raw: bytes) -> bytes:
    """Decode a PDF literal string body (without the outer parens)."""
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal \ooo
                oct_digits = raw[i + 1 : i + 4]
                oct_digits = re.match(rb"[0-7]{1,3}", oct_digits)
                if oct_digits:
                    out.append(int(oct_digits.group(0), 8) & 0xFF)
                    i += 1 + len(oct_digits.group(0))
                    continue
            i += 1
            continue
        out += c
        i += 1
    return bytes(out)


def _text_from_content(content: bytes) -> list[str]:
    lines: list[str] = []
    blocks = _BT_ET_RE.findall(content) or [content]
    for block in blocks:
        parts: list[bytes] = []
        # Scan operators in order so words stay in sequence.
        for m in re.finditer(
            rb"(\((?:\\.|[^\\()])*\))\s*(?:Tj|')|\[((?:\((?:\\.|[^\\()])*\)|[^\]])*)\]\s*TJ|(T\*|Td|TD)",
            block,
        ):
            if m.group(1) is not None:
                parts.append(_unescape(m.group(1)[1:-1]))
            elif m.group(2) is not None:
                for s in _STRING_RE.finditer(m.group(2)):
                    parts.append(_unescape(s.group(0)[1:-1]))
            else:
                parts.append(b"\n")
        text = b"".join(parts).decode("latin-1", errors="replace")
        text = "\n".join(t.strip() for t in text.splitlines())
        if text.strip():
            lines.append(text.strip())
    return lines


def extract_pdf_text(path: str) -> str:
    with open(path, "rb") as fh:
        data = fh.read()
    pages: list[str] = []
    for m in _STREAM_RE.finditer(data):
        raw = m.group(1)
        content = raw
        try:
            content = zlib.decompress(raw)
        except Exception:
            pass
        if b"Tj" not in content and b"TJ" not in content:
            continue
        pages.extend(_text_from_content(content))
    if not pages:
        logger.warning(
            "%s: no extractable text (scanned or unsupported encoding)", path
        )
    return "\n\n".join(pages)
