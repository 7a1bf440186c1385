"""Document loaders (port of the JAX package's ``ingest/loaders.py``).

The text-like formats load in-process: txt/md/rst/py/log as text, HTML
through the standard library's ``html.parser`` (the reference uses
BeautifulSoup, which the card machine lacks; the text is the same:
every text node but those of ``<script>`` and ``<style>``, comments and
declarations, joined by newlines), CSV as ``col: value`` lines, JSON
re-indented, PDF through the content-stream reader (``ingest.pdf``) and
PPTX through the OOXML reader (``ingest.pptx``), both standard-library
code as in the reference.
"""

from __future__ import annotations

import csv
import html
import html.entities
import json
import os
from html.parser import HTMLParser
from typing import Callable

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def _load_text(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        return fh.read()


class _TextNodes(HTMLParser):
    """The text nodes of a document, as BeautifulSoup builds them with
    ``html.parser``: a node is a run of character data between two markup
    events; CDATA sections are nodes too; text inside ``<script>`` and
    ``<style>`` is dropped.  References resolve as BeautifulSoup resolves
    them: an unknown name stays as ``&name`` (its ``;`` dropped)."""

    _SKIP = frozenset(("script", "style"))

    def __init__(self) -> None:
        super().__init__(convert_charrefs=False)
        self.nodes: list[str] = []
        self._run: list[str] = []
        self._skip_depth = 0

    def _end_run(self) -> None:
        if self._run:
            self.nodes.append("".join(self._run))
            self._run = []

    def handle_data(self, data) -> None:
        if not self._skip_depth:
            self._run.append(data)

    def handle_entityref(self, name) -> None:
        self.handle_data(html.entities.html5.get(name + ";", "&" + name))

    def handle_charref(self, name) -> None:
        self.handle_data(html.unescape(f"&#{name};"))

    def handle_starttag(self, tag, attrs) -> None:
        self._end_run()
        if tag in self._SKIP:
            self._skip_depth += 1

    def handle_startendtag(self, tag, attrs) -> None:
        self._end_run()

    def handle_endtag(self, tag) -> None:
        self._end_run()
        if tag in self._SKIP and self._skip_depth:
            self._skip_depth -= 1

    def handle_comment(self, data) -> None:
        self._end_run()

    def handle_decl(self, decl) -> None:
        self._end_run()

    def handle_pi(self, data) -> None:
        self._end_run()

    def unknown_decl(self, data) -> None:
        self._end_run()
        if data.upper().startswith("CDATA[") and not self._skip_depth:
            self.nodes.append(data[len("CDATA["):])

    def close(self) -> None:
        super().close()
        self._end_run()


def _load_html(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        parser = _TextNodes()
        parser.feed(fh.read())
        parser.close()
    return "\n".join(parser.nodes)


def _load_csv(path: str) -> str:
    """CSV rows flattened to 'col: value' lines per record."""
    lines: list[str] = []
    with open(path, "r", encoding="utf-8", errors="replace", newline="") as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None:
            return _load_text(path)
        for row in reader:
            lines.append(", ".join(f"{k}: {v}" for k, v in row.items()))
    return "\n".join(lines)


def _load_json(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        data = json.load(fh)
    return json.dumps(data, indent=1, ensure_ascii=False)


def _load_pdf(path: str) -> str:
    from generativeaiexamples_tpu_torch.ingest.pdf import extract_pdf_text

    return extract_pdf_text(path)


def _load_pptx(path: str) -> str:
    from generativeaiexamples_tpu_torch.ingest.pptx import extract_pptx_text

    return extract_pptx_text(path)


_LOADERS: dict[str, Callable[[str], str]] = {
    ".txt": _load_text,
    ".md": _load_text,
    ".markdown": _load_text,
    ".rst": _load_text,
    ".py": _load_text,
    ".log": _load_text,
    ".html": _load_html,
    ".htm": _load_html,
    ".csv": _load_csv,
    ".json": _load_json,
    ".pdf": _load_pdf,
    ".pptx": _load_pptx,
}


def supported_extensions() -> list[str]:
    return sorted(_LOADERS)


def load_document(path: str) -> str:
    """File -> plain text. Raises ValueError for unsupported types."""
    ext = os.path.splitext(path)[1].lower()
    loader = _LOADERS.get(ext)
    if loader is None:
        raise ValueError(
            f"unsupported document type {ext!r}; supported: "
            f"{', '.join(supported_extensions())}"
        )
    text = loader(path)
    logger.info("loaded %s: %d chars", os.path.basename(path), len(text))
    return text
