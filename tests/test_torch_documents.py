"""The port's document readers (``ingest/pdf.py``, ``ingest/pptx.py``,
``ingest/multimodal_pdf.py``) against the JAX package's, on PDFs and decks
built here (``chip_smoke.write_pdf`` / ``write_pptx``): text, segments
(kind, text, page, pixels) and slides (text, notes through the rels,
images) are equal, with PIL and with PIL hidden (then the port's images
are numpy arrays equal to ``np.asarray`` of the reference's PIL images,
and JPEG images and PPTX media are skipped)."""

import io
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke as cs
from generativeaiexamples_tpu.ingest import loaders as jloaders
from generativeaiexamples_tpu.ingest import multimodal_pdf as jmm
from generativeaiexamples_tpu.ingest import pdf as jpdf
from generativeaiexamples_tpu.ingest import pptx as jpptx
from generativeaiexamples_tpu_torch.ingest import loaders as tloaders
from generativeaiexamples_tpu_torch.ingest import multimodal_pdf as tmm
from generativeaiexamples_tpu_torch.ingest import pdf as tpdf
from generativeaiexamples_tpu_torch.ingest import pptx as tpptx


def _jpeg(rgb) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG")
    return buf.getvalue()


@pytest.fixture
def docs(tmp_path):
    chart, photo = cs.chart_pixels(np), cs.photo_pixels(np)
    rgb_photo = np.random.default_rng(3).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    report = tmp_path / "report.pdf"
    cs.write_pdf(np, report, cs.report_pages(), [(0, chart), (2, photo), (2, rgb_photo)])
    jpeg = tmp_path / "scan.pdf"
    cs.write_pdf(np, jpeg, [["A scanned page.", "col a  col b", "1  2"]],
                 [(0, _jpeg(chart), (chart.shape[1], chart.shape[0])), (0, photo)])
    image_only = tmp_path / "figure.pdf"
    cs.write_pdf(np, image_only, [[]], [(0, chart)])
    deck = tmp_path / "deck.pptx"
    cs.write_pptx(deck, [(["Fusion Update", "Ignition at 2x gain"], "Speaker: mention the gain"),
                         (["Next steps", "Budget & (risks)"], ""), (["Appendix"], "Backup notes")],
                  cs.png_bytes(np, chart))
    return {"report": str(report), "jpeg": str(jpeg), "image_only": str(image_only), "deck": str(deck)}


def _pixels(image):
    return None if image is None else np.asarray(image)


# The image segments (by order among a document's images) that are JPEG:
# without PIL the port skips them.
DCT_IMAGES = {"jpeg": {0}}


def _same_segments(got, want, pil: bool, dct=frozenset()) -> None:
    if not pil:
        images = [i for i, s in enumerate(want) if s.kind == "image"]
        want = [s for i, s in enumerate(want) if i not in {images[j] for j in dct}]
    assert [(s.kind, s.text, s.page) for s in got] == [(s.kind, s.text, s.page) for s in want]
    for g, w in zip(got, want):
        if w.image is None:
            assert g.image is None
            continue
        assert hasattr(g.image, "convert") == pil
        assert np.array_equal(_pixels(g.image), w.pixels)


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "no_pil"])
def test_pdf_and_pptx_equal_the_reference(docs, monkeypatch, pil):
    want = {name: jmm.parse_pdf(path) for name, path in docs.items() if name != "deck"}
    for segs in want.values():
        for seg in segs:  # the reference's pixels, read while PIL imports
            seg.pixels = _pixels(seg.image)
    want_pixels = [[np.asarray(i) for i in s.images] for s in jpptx.parse_pptx(docs["deck"])]
    want_text = {name: jpdf.extract_pdf_text(path) for name, path in docs.items() if name != "deck"}
    want_slides = jpptx.parse_pptx(docs["deck"])
    assert [len(s.images) for s in want_slides] == [1, 0, 0]
    assert [s.kind for s in want["report"]].count("table") == 1
    assert [s.kind for s in want["report"]].count("image") == 3
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for name in want:
        _same_segments(tmm.parse_pdf(docs[name]), want[name], pil, DCT_IMAGES.get(name, frozenset()))
        assert tpdf.extract_pdf_text(docs[name]) == want_text[name]
    slides = tpptx.parse_pptx(docs["deck"])
    assert [(s.index, s.text, s.notes) for s in slides] == [(s.index, s.text, s.notes) for s in want_slides]
    assert want_slides[0].notes == "Speaker: mention the gain" and want_slides[2].notes == "Backup notes"
    for g, w in zip(slides, want_pixels):
        assert len(g.images) == (len(w) if pil else 0)
        for gi, wi in zip(g.images, w):
            assert np.array_equal(np.asarray(gi), wi)
    assert tpptx.extract_pptx_text(docs["deck"]) == jpptx.extract_pptx_text(docs["deck"])
    for path in docs.values():
        assert tloaders.load_document(path) == jloaders.load_document(path)


def test_furniture_tables_and_captions(docs):
    segs = tmm.parse_pdf(docs["report"])
    texts = "\n".join(s.text for s in segs if s.kind == "text")
    assert cs.REPORT_HEADER not in texts and cs.REPORT_FOOTER not in texts
    table = [s for s in segs if s.kind == "table"][0]
    assert table.text.splitlines()[0] == "region | sales | growth" and table.page == 1
    images = [s for s in segs if s.kind == "image"]
    assert [s.page for s in images] == [0, 2, 2]
    assert images[0].text.startswith("Hydra Inc annual report")
    assert np.array_equal(np.asarray(images[0].image), cs.chart_pixels(np))
    assert np.array_equal(np.asarray(images[1].image)[..., 0], cs.photo_pixels(np))


def test_ocr_fallback_is_gated_like_the_reference(docs):
    # No text layer: both fall back to OCR, which is absent here, so both
    # keep only the image with an empty caption.
    got, want = tmm.parse_pdf(docs["image_only"]), jmm.parse_pdf(docs["image_only"])
    assert [(s.kind, s.text) for s in got] == [(s.kind, s.text) for s in want] == [("image", "")]


def test_pdf_string_escapes_match(docs):
    for raw in (rb"a\(b\)c", rb"tab\there", rb"oct\101\102", rb"back\\slash", rb"dangling\q"):
        assert tpdf._unescape(raw) == jpdf._unescape(raw)
    content = b"BT (Hello) Tj T* [(Wor) -20 (ld)] TJ (next) ' ET BT (x) Tj ET"
    assert tpdf._text_from_content(content) == jpdf._text_from_content(content)
