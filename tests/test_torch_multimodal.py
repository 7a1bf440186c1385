"""The port's multimodal chain (``chains/multimodal.py``) against the JAX
package's: the chunks (kind, text, source) that ``ingest_docs`` stores
for a PDF (text, a table, furniture, a Flate chart, a gray photo) and a
PPTX (text, notes, an image), under the heuristic analyst and under the
VLM on the same params (f32 tiny; texts compared with the port's
``<|id|>`` markers removed, ids equal: ``tests/test_torch_vision_service.py``);
and the port's chain server serving the plugin from
``GAIE_EXAMPLE_MODULE``."""

import json
import os
import re
import threading
import urllib.request

import jax
import numpy as np
import pytest

import chip_smoke as cs
from generativeaiexamples_tpu.chains import factory as jfactory
from generativeaiexamples_tpu.chains import multimodal as jmm
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import tokenizer as jtokenizer
from generativeaiexamples_tpu.engine import vision_service as jvs
from generativeaiexamples_tpu.models import vision as JV
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.chains import multimodal as tmm
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.engine import tokenizer as ttokenizer
from generativeaiexamples_tpu_torch.engine import vision_service as tvs
from generativeaiexamples_tpu_torch.engine.weights import vlm_params_from_numpy
from tests.test_torch_vision import vlm_f32


def _reset():
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()
    jvs.reset_vision_analyst()
    tvs.reset_vision_analyst()


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    for key, value in (("APP_LLM_MODELENGINE", "echo"), ("APP_EMBEDDINGS_MODELENGINE", "hash"),
                       ("APP_EMBEDDINGS_DIMENSIONS", "64"), ("APP_VECTORSTORE_NAME", "tpu"),
                       ("APP_VLM_MODELENGINE", "heuristic"), ("APP_RETRIEVER_SCORETHRESHOLD", "-1.0"),
                       ("GAIE_UPLOAD_DIR", str(tmp_path / "up")), ("APP_SLO_LATENCYP95MS", "")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(jtokenizer, "get_tokenizer", lambda *a, **k: jtokenizer.ByteTokenizer())
    _reset()
    tfactory.get_retriever("cpu")
    yield monkeypatch
    _reset()


@pytest.fixture
def documents(tmp_path):
    pdf, deck = tmp_path / "report.pdf", tmp_path / "deck.pptx"
    cs.write_pdf(np, pdf, cs.report_pages(), [(0, cs.chart_pixels(np)), (2, cs.photo_pixels(np))])
    cs.write_pptx(deck, [(["Fusion Update", "Ignition at 2x gain"], "Speaker: mention the gain"),
                         (["Next steps"], "")], cs.png_bytes(np, cs.photo_pixels(np, seed=1)[..., None].repeat(3, 2)))
    return {"report.pdf": str(pdf), "deck.pptx": str(deck)}


def _chunks(module, monkeypatch, path, name):
    """(kind, text, source) of every chunk ``ingest_docs`` stores."""
    stored = []

    class Store:
        def add(self, chunks, embeddings):
            assert len(chunks) == len(embeddings)
            stored.extend((c.metadata["kind"], c.text, c.source) for c in chunks)

    monkeypatch.setattr(module, "get_store", lambda *a, **k: Store())
    module.MultimodalRAG().ingest_docs(path, name)
    return stored


def _unmarked(chunks):
    return [(k, re.sub(r"<\|\d+\|>", "", t), s) for k, t, s in chunks]


def test_chunks_equal_the_reference_under_the_heuristic(env, documents):
    for name, path in documents.items():
        got, want = _chunks(tmm, env, path, name), _chunks(jmm, env, path, name)
        assert got == want
        kinds = {k for k, _, _ in got}
        assert kinds == ({"text", "table", "chart", "image"} if name.endswith(".pdf") else {"text", "image"})
        assert all(s == name for _, _, s in got)


def test_chunks_equal_the_reference_under_the_vlm(env, documents):
    jc, tc = vlm_f32()
    jp = JV.init_vlm_params(jc, jax.random.PRNGKey(0))
    janalyst = jvs.TPUVisionAnalyst(cfg=jc, params=jp, tokenizer=jtokenizer.ByteTokenizer(), max_new_tokens=8)
    tanalyst = tvs.GPUVisionAnalyst(cfg=tc, params=vlm_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu"),
                                    tokenizer=ttokenizer.ByteTokenizer(), max_new_tokens=8, device="cpu")
    env.setattr(jmm, "get_vision_analyst", lambda: janalyst)
    env.setattr(tmm, "get_vision_analyst", lambda *a: tanalyst)
    for name, path in documents.items():
        got, want = _chunks(tmm, env, path, name), _chunks(jmm, env, path, name)
        assert _unmarked(got) == want
        assert any(k in ("chart", "image") for k, _, _ in got)


def test_chain_server_serves_the_plugin(env, documents):
    from generativeaiexamples_tpu_torch.server import app as tapp

    env.setenv("GAIE_EXAMPLE_MODULE", "generativeaiexamples_tpu_torch.chains.multimodal")
    server = tapp.create_app(device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert server.example_cls is tmm.MultimodalRAG
        for name, path in documents.items():
            with open(path, "rb") as fh:
                cs._upload_bytes(base, name, fh.read())
        with urllib.request.urlopen(base + "/documents", timeout=60) as resp:
            assert sorted(json.loads(resp.read())["documents"]) == sorted(documents)
        req = urllib.request.Request(base + "/search", data=json.dumps({"query": "region sales", "top_k": 20}).encode(),
                                     method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            contents = [c["content"] for c in json.loads(resp.read())["chunks"]]
        assert any(c.startswith("Table:\nregion | sales | growth") for c in contents)
        assert any(c.startswith("Chart: Hydra Inc annual report") for c in contents)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
