"""PPTX parsing without python-pptx (port of the JAX package's
``ingest/pptx.py``; standard-library code: ``zipfile`` and ``xml.etree``).

A .pptx file is a zip of OOXML parts: slide text comes from the slide
XML's ``a:t`` runs, speaker notes from the notes slide its relationship
file names, and embedded images from the ``media/`` parts it names.
Images decode through PIL where it imports, as in the reference; without
PIL every media part is skipped with the reference's warning for an
undecodable part (the reference returns no images then).
"""

from __future__ import annotations

import dataclasses
import io
import posixpath
import re
import xml.etree.ElementTree as ET
import zipfile

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_SLIDE_RE = re.compile(r"ppt/slides/slide(\d+)\.xml$")


@dataclasses.dataclass
class Slide:
    index: int
    text: str
    notes: str
    images: list  # PIL.Image


def _slide_text(root: ET.Element) -> str:
    """All a:t runs, paragraph-joined."""
    paras: list[str] = []
    for para in root.iter(f"{_A}p"):
        runs = [t.text or "" for t in para.iter(f"{_A}t")]
        line = "".join(runs).strip()
        if line:
            paras.append(line)
    return "\n".join(paras)


def _rels_name(slide_name: str) -> str:
    return posixpath.join(posixpath.dirname(slide_name), "_rels", posixpath.basename(slide_name) + ".rels")


def _slide_images(zf: zipfile.ZipFile, slide_name: str) -> list:
    """Resolve r:embed image relationships to decoded PIL images."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    try:
        rels_root = ET.fromstring(zf.read(_rels_name(slide_name)))
    except KeyError:
        return []
    targets = [
        posixpath.normpath(posixpath.join(posixpath.dirname(slide_name), rel.get("Target", "")))
        for rel in rels_root
        if "media/" in rel.get("Target", "")
    ]
    images = []
    for t in targets:
        try:
            if Image is None:
                raise ImportError("PIL is not installed")
            images.append(Image.open(io.BytesIO(zf.read(t))).convert("RGB"))
        except Exception:
            logger.warning("undecodable media part %s", t)
    return images


def _slide_notes(zf: zipfile.ZipFile, slide_name: str) -> str:
    """Resolve the slide's notesSlide via its relationship file.

    OOXML only guarantees the association through slideN.xml.rels (the
    notesSlide part number can diverge from the slide number after
    deletes/reorders), so numeric filename matching is wrong; fall back to
    it only when the rels part is absent.
    """
    target = None
    try:
        rels_root = ET.fromstring(zf.read(_rels_name(slide_name)))
        for rel in rels_root:
            if rel.get("Type", "").endswith("/notesSlide"):
                target = posixpath.normpath(posixpath.join(posixpath.dirname(slide_name), rel.get("Target", "")))
                break
    except KeyError:
        m = _SLIDE_RE.search(slide_name)
        if m:
            target = f"ppt/notesSlides/notesSlide{m.group(1)}.xml"
    if not target:
        return ""
    try:
        root = ET.fromstring(zf.read(target))
    except KeyError:
        return ""
    return _slide_text(root)


def parse_pptx(path: str) -> list[Slide]:
    """Parse all slides in presentation order."""
    slides: list[Slide] = []
    with zipfile.ZipFile(path) as zf:
        names = sorted((int(m.group(1)), m.string) for m in filter(None, map(_SLIDE_RE.match, zf.namelist())))
        for index, name in names:
            root = ET.fromstring(zf.read(name))
            slides.append(
                Slide(index=index, text=_slide_text(root), notes=_slide_notes(zf, name),
                      images=_slide_images(zf, name))
            )
    logger.info("parsed %s: %d slides, %d images", path, len(slides), sum(len(s.images) for s in slides))
    return slides


def extract_pptx_text(path: str) -> str:
    """Plain-text loader entry (slides + notes)."""
    parts = []
    for s in parse_pptx(path):
        chunk = s.text
        if s.notes:
            chunk += f"\n[notes] {s.notes}"
        if chunk.strip():
            parts.append(chunk)
    return "\n\n".join(parts)
