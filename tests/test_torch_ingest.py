"""The port's loaders and splitters against the JAX package's on the CPU.

Texts are generated from numpy seed 0 (paragraphs, headings, code,
non-ASCII words, HTML with scripts, styles, comments and references,
CSV, JSON); every splitter and loader must give exactly the reference's
output.  The token splitter runs on the byte tokenizer on both sides
(the port has no other yet).
"""

import json

import numpy as np
import pytest

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import tokenizer as jtokenizer
from generativeaiexamples_tpu.ingest import loaders as jloaders
from generativeaiexamples_tpu.ingest import splitters as jsplitters
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.engine import tokenizer as ttokenizer
from generativeaiexamples_tpu_torch.ingest import loaders as tloaders
from generativeaiexamples_tpu_torch.ingest import splitters as tsplitters

WORDS = ["tpu", "gpu", "cache", "vector", "café", "naïve", "日本", "search", "the", "a", "of", "HBM3", "ünï",
         "def", "class", "return", "—", "token", "x=1;", "(y)", "\t", "store"]


def _sentence(rng) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(int(rng.integers(3, 14)))) + rng.choice([".", "?", "!", ""])


def _prose(rng, n_par: int) -> str:
    pars = []
    for _ in range(n_par):
        lines = [" ".join(_sentence(rng) for _ in range(int(rng.integers(1, 5)))) for _ in range(int(rng.integers(1, 4)))]
        pars.append("\n".join(lines))
    return "\n\n".join(pars)


def _markdown(rng) -> str:
    out = ["# Title"]
    for i in range(int(rng.integers(3, 8))):
        out.append(f"\n## Section {i}\n{_prose(rng, 2)}")
        if rng.random() < 0.5:
            out.append(f"\n### Sub {i}\n{_prose(rng, 1)}")
    return "\n".join(out)


def _code(rng) -> str:
    out = ["import os\n"]
    for i in range(int(rng.integers(3, 9))):
        body = "\n".join(f"        v{j} = {_sentence(rng)!r}" for j in range(int(rng.integers(1, 12))))
        out.append(f"\nclass C{i}:\n    def m{i}(self):\n{body}\n        return v0\n\n    def n{i}(self):\n        pass\n")
        out.append(f"\ndef f{i}(x):\n    return x + {i}\n")
    return "".join(out)


def _texts():
    rng = np.random.default_rng(0)
    return [_prose(rng, int(rng.integers(1, 12))) for _ in range(6)] + [_markdown(rng) for _ in range(3)] + [
        _code(rng) for _ in range(3)] + ["", "   \n\n  ", "x" * 3000, "é" * 1500, "word " * 900]


TEXTS = _texts()

SPLITTERS = [
    ("CharacterSplitter", dict(chunk_size=2000, chunk_overlap=200)),
    ("CharacterSplitter", dict(chunk_size=120, chunk_overlap=30)),
    ("RecursiveCharacterSplitter", dict(chunk_size=1000, chunk_overlap=100)),
    ("RecursiveCharacterSplitter", dict(chunk_size=80, chunk_overlap=20)),
    ("RecursiveCharacterSplitter", dict(chunk_size=60, chunk_overlap=0)),
    ("PythonCodeSplitter", dict(chunk_size=300, chunk_overlap=50)),
    ("PythonCodeSplitter", dict(chunk_size=90, chunk_overlap=10)),
    ("MarkdownSplitter", dict(chunk_size=400, chunk_overlap=40)),
    ("MarkdownSplitter", dict(chunk_size=70, chunk_overlap=15)),
]


@pytest.mark.parametrize("name,kw", SPLITTERS)
def test_character_splitters_match_reference(name, kw):
    port, ref = getattr(tsplitters, name)(**kw), getattr(jsplitters, name)(**kw)
    n = 0
    for text in TEXTS:
        got = port.split(text)
        assert got == ref.split(text)
        n += len(got)
    assert n > len(TEXTS)


@pytest.mark.parametrize("size,overlap", [(510, 200), (64, 16), (20, 17)])
def test_token_splitter_matches_reference(size, overlap):
    port = tsplitters.TokenSplitter(size, overlap, tokenizer=ttokenizer.ByteTokenizer())
    ref = jsplitters.TokenSplitter(size, overlap, tokenizer=jtokenizer.ByteTokenizer())
    assert port.chunk_size == ref.chunk_size == size - 2
    for text in TEXTS:
        assert port.split(text) == ref.split(text)


def test_configured_splitter_matches_reference(monkeypatch):
    monkeypatch.setenv("APP_TEXTSPLITTER_CHUNKSIZE", "300")
    monkeypatch.setenv("APP_TEXTSPLITTER_CHUNKOVERLAP", "100")
    monkeypatch.setattr(jtokenizer, "get_tokenizer", lambda *a, **k: jtokenizer.ByteTokenizer())
    try:
        for configuration in (jconfiguration, tconfiguration):
            configuration.reset_config_cache()
        port, ref = tsplitters.get_text_splitter(), jsplitters.get_text_splitter()
        assert (port.chunk_size, port.chunk_overlap) == (ref.chunk_size, ref.chunk_overlap) == (298, 100)
        for text in TEXTS:
            assert port.split(text) == ref.split(text)
    finally:
        for configuration in (jconfiguration, tconfiguration):
            configuration.reset_config_cache()
    for mod in (tsplitters, jsplitters):
        with pytest.raises(ValueError):
            mod.CharacterSplitter(chunk_size=10, chunk_overlap=10)
        with pytest.raises(ValueError):
            mod.TokenSplitter(10, 10, tokenizer=ttokenizer.ByteTokenizer())


@pytest.mark.parametrize("overlap", [18, 19])
def test_token_splitter_refuses_an_overlap_past_the_reserved_tokens(overlap):
    """A fault of the reference the port does not copy: it checks the
    overlap against the size before the 2 reserved tokens, so (20, 18) or
    (20, 19) pass its check and its split never ends (a window step of 0
    or -1).  The port refuses them."""
    with pytest.raises(ValueError, match="reserved tokens"):
        tsplitters.TokenSplitter(20, overlap, tokenizer=ttokenizer.ByteTokenizer())
    ref = jsplitters.TokenSplitter(20, overlap, tokenizer=jtokenizer.ByteTokenizer())
    assert ref.chunk_size - ref.chunk_overlap <= 0


def _html(rng) -> str:
    parts = ["<!DOCTYPE html><html><head><title>", _sentence(rng), "</title>",
             "<style>p { color: red; } /* <b>not text</b> */</style></head><body>"]
    for _ in range(int(rng.integers(2, 8))):
        kind = rng.integers(0, 6)
        if kind == 0:
            parts.append(f"<p>{_sentence(rng)} <b>{_sentence(rng)}</b> &amp; &lt;tag&gt; &nbsp;&copy; &#233;&#x41;</p>")
        elif kind == 1:
            parts.append(f"<script>var s = '{_sentence(rng)}'; if (a < b) {{}}</script>")
        elif kind == 2:
            parts.append(f"<!-- {_sentence(rng)} --><div>{_sentence(rng)}<br/>{_sentence(rng)}</div>")
        elif kind == 3:
            parts.append(f"<ul><li>{_sentence(rng)}</li>\n<li>&unknownref; {_sentence(rng)}</li></ul>\n")
        elif kind == 4:
            parts.append(f"<table><tr><td>{_sentence(rng)}</td><td>café</td></tr></table>")
        else:
            parts.append(f"<![CDATA[{_sentence(rng)}]]> text after &#150; &quot;q&quot;")
    parts.append("</body></html>")
    return "".join(parts)


def _files(tmp_path):
    rng = np.random.default_rng(0)
    files = {}
    for i in range(4):
        files[f"doc{i}.html"] = _html(rng)
    files["page.htm"] = _html(rng)
    for i, text in enumerate(TEXTS[:4]):
        files[f"t{i}.txt"] = text
    files["m.md"] = TEXTS[7]
    files["c.py"] = TEXTS[10]
    rows = [["name", "note", "n"]] + [[_sentence(rng), f'"{_sentence(rng)}, quoted"', str(i)] for i in range(12)]
    files["rows.csv"] = "\n".join(",".join(r) for r in rows) + "\n"
    files["empty.csv"] = ""
    records = [{"id": i, "text": _sentence(rng), "tags": [str(t) for t in rng.choice(WORDS, 3)],
                "nested": {"ok": bool(i % 2), "v": float(i) / 3}} for i in range(6)]
    files["data.json"] = json.dumps(records, ensure_ascii=False)
    paths = {}
    for name, content in files.items():
        path = tmp_path / name
        path.write_text(content, encoding="utf-8")
        paths[name] = str(path)
    return paths


def test_loaders_match_reference(tmp_path):
    paths = _files(tmp_path)
    for name, path in paths.items():
        got = tloaders.load_document(path)
        assert got == jloaders.load_document(path), name
    assert "not text" not in tloaders.load_document(paths["doc0.html"])
    assert tloaders.supported_extensions() == jloaders.supported_extensions()


def test_unsupported_and_unported_types(tmp_path):
    odd = tmp_path / "x.exe"
    odd.write_bytes(b"MZ")
    for mod in (tloaders, jloaders):
        with pytest.raises(ValueError, match="unsupported document type"):
            mod.load_document(str(odd))
    for ext in (".pdf", ".pptx"):
        path = tmp_path / f"doc{ext}"
        path.write_bytes(b"%PDF-1.4")
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            tloaders.load_document(str(path))
