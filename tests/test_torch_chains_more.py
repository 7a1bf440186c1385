"""The port's ``multi_turn``, ``query_decomposition`` and ``api_catalog``
chains against the JAX package's on the CPU.

Both packages run from the same ``APP_*`` overlay (hash embeddings at 64,
the exact ``tpu`` store: ``GPUVectorStore(device="cpu")`` on the port's
side, ``TPUVectorStore`` on the JAX side) with the same documents.  The
echo LLM's answers depend on the whole prompt, so equal answers mean
equal prompts; the agent loop runs on a scripted LLM whose recorded calls
(every prompt it was sent) must be equal.
"""

import json
import os

import pytest

from generativeaiexamples_tpu.chains import api_catalog as japi
from generativeaiexamples_tpu.chains import developer_rag as jdev
from generativeaiexamples_tpu.chains import factory as jfactory
from generativeaiexamples_tpu.chains import multi_turn as jmulti
from generativeaiexamples_tpu.chains import query_decomposition as jqd
from generativeaiexamples_tpu.chains.llm import ScriptedChatLLM as JScripted
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import tokenizer as jtokenizer
from generativeaiexamples_tpu_torch.chains import api_catalog as tapi
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.chains import multi_turn as tmulti
from generativeaiexamples_tpu_torch.chains import query_decomposition as tqd
from generativeaiexamples_tpu_torch.chains.llm import ScriptedChatLLM
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

DOCS = {"kb.txt": "The capital of France is Paris.\n\nAlice is 30 years old. Bob is 40 years old.",
        "notes.md": "# Notes\n\nThe exact store scans every row.\n\nKernels run on the card."}


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    for key, value in (("APP_LLM_MODELENGINE", "echo"), ("APP_EMBEDDINGS_MODELENGINE", "hash"),
                       ("APP_EMBEDDINGS_DIMENSIONS", "64"), ("APP_VECTORSTORE_NAME", "tpu"),
                       ("APP_RETRIEVER_SCORETHRESHOLD", "-1.0")):
        monkeypatch.setenv(key, value)
    # The splitter's tokenizer: the port has only the byte tokenizer.
    monkeypatch.setattr(jtokenizer, "get_tokenizer", lambda *a, **k: jtokenizer.ByteTokenizer())
    _reset()
    # The port's singletons on the CPU (a request builds nothing).
    tfactory.get_chat_llm("cpu")
    tfactory.get_retriever("cpu")
    for name, text in DOCS.items():
        (tmp_path / name).write_text(text)
    yield tmp_path
    _reset()


def _reset():
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()


def _ingest(bots, tmp_path):
    for bot in bots:
        for name in DOCS:
            bot.ingest_docs(str(tmp_path / name), name)


def test_multi_turn_remembers_like_the_reference(env):
    tmulti.MultiTurnChatbot.prepare("cpu")
    port, ref = tmulti.MultiTurnChatbot(), jmulti.MultiTurnChatbot()
    memory = tfactory.get_memory_store()
    assert isinstance(memory, GPUVectorStore) and memory.device.type == "cpu" and memory is not tfactory.get_store()
    _ingest((port, ref), env)
    for i, (question, history) in enumerate((("What is the capital of France?", []),
                                             ("What did I just ask?", [("user", "hi"), ("assistant", "hello")]),
                                             ("How old is Alice?", []))):
        got = "".join(port.rag_chain(question, history, max_tokens=256))
        want = "".join(ref.rag_chain(question, history, max_tokens=256))
        assert got == want and got
        assert len(memory) == len(jfactory.get_memory_store()) == i + 1
    rows = sorted(c.text for c in memory._mirror._chunks)
    assert rows == sorted(c.text for c in jfactory.get_memory_store()._mirror._chunks)
    assert rows[0].startswith("User: ") and "\nAssistant: " in rows[0]
    assert memory.sources() == ["__conversation__"]
    # The plain chain remembers too.
    assert "".join(port.llm_chain("hello there", [])) == "".join(ref.llm_chain("hello there", []))
    assert len(memory) == 4


def _plans():
    return [
        json.dumps({"Tool_Request": "Search", "Generated Sub Questions": ["How old is Alice?", "How old is Bob?"]}),
        "Alice is 30.", "Bob is 40.",
        json.dumps({"Tool_Request": "Math", "Generated Sub Questions": ["What is 30 + 40?"]}),
        json.dumps({"operand1": 30, "operand2": 40, "operator": "+"}),
        "not a plan",
        "Together they are 70.",
    ]


@pytest.mark.parametrize("script", [_plans(), ["{\"Tool_Request\": \"Search\", \"Generated Sub Questions\": [\"q\"]}",
                                               "a1"] * 3 + ["final"], ["no json", "direct"],
                                    [json.dumps({"Tool_Request": "Math", "Generated Sub Questions": ["1/0"]}),
                                     json.dumps({"operand1": 1, "operand2": 0, "operator": "/"}),
                                     json.dumps({"Tool_Request": "Final Answer"}), "undefined"]],
                         ids=["search_math", "hop_limit", "unparseable", "division_by_zero"])
def test_query_decomposition_matches_the_reference(env, monkeypatch, script):
    port, ref = tqd.QueryDecompositionChatbot(), jqd.QueryDecompositionChatbot()
    _ingest((port, ref), env)
    scripted, jscripted = ScriptedChatLLM(list(script)), JScripted(list(script))
    monkeypatch.setattr(tqd, "get_chat_llm", lambda: scripted)
    monkeypatch.setattr(jqd, "get_chat_llm", lambda: jscripted)
    got = "".join(port.rag_chain("How old are Alice and Bob together?", []))
    want = "".join(ref.rag_chain("How old are Alice and Bob together?", []))
    assert got == want and scripted.calls == jscripted.calls
    assert port.last_ledger == ref.last_ledger
    assert got == script[-1]


def test_api_catalog_matches_the_reference(env, monkeypatch):
    port, ref = tapi.APICatalogChatbot(), japi.APICatalogChatbot()
    _ingest((port, ref), env)
    for question in ("What is the capital of France?", "kernels"):
        got, want = "".join(port.rag_chain(question, [])), "".join(ref.rag_chain(question, []))
        assert got == want and got

    def boom(query, top_k=None):
        raise RuntimeError("store down")

    # A failed retrieval answers without context, on both.
    monkeypatch.setattr(port._retriever, "retrieve", boom)
    monkeypatch.setattr(ref._retriever, "retrieve", boom)
    got, want = "".join(port.rag_chain("question?", [])), "".join(ref.rag_chain("question?", []))
    assert got == want and got
    assert "".join(port.llm_chain("plain", [])) == "".join(jdev.QAChatbot.llm_chain(ref, "plain", []))
