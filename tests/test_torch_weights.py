"""HF checkpoints through the port's loaders against the JAX package's, on
the CPU.

Tiny Llama checkpoints written by ``transformers`` (untied, tied, saved in
bf16, and sharded) load through the port's ``load_hf_llama`` to leaves
equal to the JAX ``load_hf_llama``'s bit for bit, in bf16 and f32; the
port's ``prepare_params`` quantizes them to the reference's int8 codes and
scales; the port's ``Scheduler`` emits the JAX scheduler's greedy tokens
on them; ``build_server`` serves a provisioned checkpoint (and a draft's)
with the JAX engine's tokens.  Safetensors files cross between the
packages in both directions (the JAX writer has no integer dtypes, so I32
and I64 cross one way).  BERT and cross-encoder checkpoints load to the
JAX loaders' leaves and score as they do, and the chain factories load the
provisioned embedder and reranker as the JAX factories do.
"""

import dataclasses
import json
import queue
import shutil
import threading
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.engine import weights as jweights
from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import decode as tdecode
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine import weights as tweights
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer, WordPieceTokenizer
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.models import llama as tllama

transformers = pytest.importorskip("transformers")

SCHED_KW = dict(max_batch=2, max_len=128, decode_chunk_size=2, prefill_chunk_tokens=8, prefix_cache="shared")
VOCAB = ("[PAD] [CLS] [SEP] [UNK] the quick brown fox dog retrieval augment ##ed generation "
         "over lazy jump ##s embed ##ding").split()
# Port and JAX BERT in bf16 on weights of 5x the usual spread: the
# embedding bound of tests/test_torch_bert.py, and chip_smoke.py's BERT_TOL
# for scores (bf16 roundings in other orders through both layers).
BF16_EMBED = dict(atol=1e-2, rtol=0)
BF16_SCORE = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=1e-5, rtol=1e-5)


def _hf_llama_config(tie: bool):
    # The llama-tiny preset's geometry, so build_server serves it by name.
    return transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tie, attention_bias=False, mlp_bias=False,
    )


@pytest.fixture(scope="module")
def llama_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("llama")
    out = {}
    for name, tie in (("untied", False), ("tied", True)):
        torch.manual_seed(0)
        model = transformers.LlamaForCausalLM(_hf_llama_config(tie)).eval()
        model.save_pretrained(root / name, safe_serialization=True)
        if name == "untied":
            model.save_pretrained(root / "sharded", safe_serialization=True, max_shard_size="200KB")
            model.to(torch.bfloat16).save_pretrained(root / "bf16", safe_serialization=True)
        out[name] = root / name
    out["sharded"], out["bf16"] = root / "sharded", root / "bf16"
    assert len(list(out["sharded"].glob("*.safetensors"))) > 1
    return {k: str(v) for k, v in out.items()}


def _cfgs(dtype: str):
    return (jllama.llama_tiny(dtype=dtype, max_seq_len=128, kv_dtype="int8"),
            tllama.llama_tiny(dtype=dtype, max_seq_len=128, kv_dtype="int8"))


def _bytes(x) -> np.ndarray:
    """A leaf's raw bytes: a torch tensor or a JAX / numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_tree_bits_equal(got, want, where=""):
    assert set(got) == set(want), where
    for name, leaf in want.items():
        if isinstance(leaf, dict):
            _assert_tree_bits_equal(got[name], leaf, f"{where}{name}.")
            continue
        g = got[name]
        assert tuple(g.shape) == tuple(np.shape(leaf)), f"{where}{name}"
        assert str(g.dtype).split(".")[-1] == np.asarray(leaf).dtype.name, f"{where}{name}"
        assert np.array_equal(_bytes(g), _bytes(leaf)), f"{where}{name}"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ckpt", ["untied", "tied", "bf16", "sharded"])
def test_load_hf_llama_leaves_equal_reference(llama_ckpts, ckpt, dtype):
    jcfg, tcfg = _cfgs(dtype)
    want = jweights.load_hf_llama(jcfg, llama_ckpts[ckpt])
    got = tweights.load_hf_llama(tcfg, llama_ckpts[ckpt], device="cpu")
    _assert_tree_bits_equal(got, want)
    if ckpt == "tied":
        assert torch.equal(got["lm_head"], got["embed"].T)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prepare_params_quantizes_as_the_reference(llama_ckpts, dtype):
    """int8 codes and scales of the loaded tree after the port's
    ``prepare_params`` equal the reference's ``quantize_llama_params``
    (through its ``prepare_params``, packed and pre-blocked)."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jdecode.prepare_params(jcfg, jweights.load_hf_llama(jcfg, llama_ckpts["untied"]), None, quantize=True,
                                pack=True, matmul_kernel="pallas_w8a8")
    want = tweights.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    got = tdecode.w8a8_params(tcfg, tweights.load_hf_llama(tcfg, llama_ckpts["untied"], device="cpu"), device="cpu")
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        assert torch.equal(got["layers"][name].w, want["layers"][name].w), name
        assert torch.equal(got["layers"][name].scale, want["layers"][name].scale), name
    for name in ("embed", "lm_head"):
        assert torch.equal(got[name].q, want[name].q) and torch.equal(got[name].scale, want[name].scale), name
    for name in ("attn_norm", "mlp_norm"):
        assert torch.equal(got["layers"][name], want["layers"][name]), name


def _collect(mod, sched, prompt, max_tokens=6):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    sched.submit(mod.Request(token_ids=list(prompt), sampling=mod.SamplingParams(temperature=0.0, max_tokens=max_tokens),
                             on_token=tokens.append, on_done=done.put))
    return tokens, done.get(timeout=180)


def _streams(mod, sched, prompts):
    sched.start()
    try:
        return [_collect(mod, sched, p) for p in prompts]
    finally:
        sched.stop()


@pytest.fixture(scope="module")
def jax_f32_prepared(llama_ckpts):
    jcfg, _ = _cfgs("float32")
    return jdecode.prepare_params(jcfg, jweights.load_hf_llama(jcfg, llama_ckpts["untied"]), None, quantize=True,
                                  pack=True, matmul_kernel="pallas_w8a8")


def _jax_streams(jax_prepared, prompts, monkeypatch, **kw):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    jcfg, _ = _cfgs("float32")
    return _streams(jsched, jsched.Scheduler(jcfg, jax_prepared, matmul_kernel="pallas_w8a8", **SCHED_KW, **kw),
                    prompts)


PROMPTS = ([1, 2, 3, 4], list(range(5, 29)))


def test_loaded_greedy_streams_equal_the_jax_scheduler(llama_ckpts, jax_f32_prepared, monkeypatch):
    _, tcfg = _cfgs("float32")
    params = tweights.load_hf_llama(tcfg, llama_ckpts["sharded"], device="cpu")
    got = _streams(tsched, tsched.Scheduler(tcfg, params, device="cpu", matmul_kernel="pallas_w8a8", **SCHED_KW),
                   PROMPTS)
    want = _jax_streams(jax_f32_prepared, PROMPTS, monkeypatch)
    assert got == want and all(tokens for tokens, _ in got)


def _write_config(path, **hf):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))


def test_llama_config_from_hf_matches_and_refuses_as_the_reference(llama_ckpts, tmp_path):
    want = jweights.llama_config_from_hf(llama_ckpts["untied"], dtype="float32")
    got = tweights.llama_config_from_hf(llama_ckpts["untied"], dtype="float32")
    for field in dataclasses.fields(got):
        if field.name != "kv_dtype":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got == tweights.llama_config_from_hf(llama_ckpts["untied"], dtype="float32", kv_dtype=got.kv_dtype)
    with open(f"{llama_ckpts['untied']}/config.json", encoding="utf-8") as fh:
        hf = json.load(fh)
    for mtype, arch in (("gemma", "GemmaForCausalLM"), ("starcoder2", "Starcoder2ForCausalLM"),
                        ("llama", "GemmaForCausalLM")):
        path = tmp_path / f"{mtype}-{arch}"
        _write_config(path, **{**hf, "model_type": mtype, "architectures": [arch]})
        for mod in (jweights, tweights):
            with pytest.raises(ValueError, match="only maps the llama/mistral family"):
                mod.llama_config_from_hf(str(path))


def _hf_family_models():
    """The reference tests' tiny HF Gemma, StarCoder2 and Mixtral models
    (``tests/test_weights.py``), at the tiny presets' geometry (vocab 512,
    so ``build_server`` serves them by name), and the presets that map
    them."""
    common = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=512, rope_theta=10000.0)
    return {
        "gemma": (transformers.GemmaConfig(**common, num_key_value_heads=1, head_dim=16, rms_norm_eps=1e-6,
                                           hidden_activation="gelu_pytorch_tanh", attention_bias=False),
                  transformers.GemmaForCausalLM, "gemma-tiny", {}),
        "starcoder2": (transformers.Starcoder2Config(**common, num_key_value_heads=2, norm_epsilon=1e-5,
                                                     hidden_act="gelu_pytorch_tanh", use_bias=True,
                                                     tie_word_embeddings=True, sliding_window=None,
                                                     residual_dropout=0.0, embedding_dropout=0.0),
                       transformers.Starcoder2ForCausalLM, "starcoder2-tiny", {}),
        "mixtral": (transformers.MixtralConfig(**common, num_key_value_heads=2, rms_norm_eps=1e-5,
                                               num_local_experts=4, num_experts_per_tok=2,
                                               tie_word_embeddings=False),
                    transformers.MixtralForCausalLM, "llama-moe-tiny", {"moe_dropless": True}),
    }


@pytest.fixture(scope="module")
def family_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    out = {}
    for seed, (family, (hf_cfg, cls, preset, extra)) in enumerate(_hf_family_models().items()):
        torch.manual_seed(seed + 1)
        model = cls(hf_cfg).eval()
        model.save_pretrained(root / family, safe_serialization=True)
        cfgs = tuple(mod.PRESETS[preset](dtype="float32", max_seq_len=128, kv_dtype="int8", **extra)
                     for mod in (jllama, tllama))
        out[family] = (str(root / family), model, cfgs)
    return out


FAMILIES = ("gemma", "starcoder2", "mixtral")


@pytest.mark.parametrize("family", FAMILIES)
def test_family_loaders_leaves_equal_reference(family_ckpts, family):
    """The Gemma (tied head), StarCoder2 (biases, LayerNorm, tied head) and
    Mixtral (router and experts) checkpoints load through the port's
    ``load_hf_causal_lm`` to the JAX loader's leaves bit for bit."""
    path, _, (jcfg, tcfg) = family_ckpts[family]
    want = jweights.load_hf_causal_lm(jcfg, path)
    got = tweights.load_hf_causal_lm(tcfg, path, device="cpu")
    _assert_tree_bits_equal(got, want)
    if family != "mixtral":
        assert torch.equal(got["lm_head"], got["embed"].T)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_logits_equal_the_hf_model(family_ckpts, family):
    """The loaded tree through the port's cacheless forward gives the HF
    model's logits within the reference test's 2e-3 (f32, another order of
    sums; Mixtral routed droplessly, as HF routes)."""
    path, model, (_, tcfg) = family_ckpts[family]
    params = tweights.load_hf_causal_lm(tcfg, path, device="cpu")
    tokens = torch.tensor([[1, 5, 9, 17, 33, 2, 40, 77]], dtype=torch.long)
    with torch.no_grad():
        ref = model(tokens).logits.numpy()
        hidden, _ = tllama.forward(params, tcfg, tokens, torch.arange(8, dtype=torch.int32)[None])
        ours = tllama.logits(params, hidden).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)


def test_resolve_model_preset_equals_reference():
    names = ("meta-llama/Meta-Llama-3-8B-Instruct", "meta-llama/Meta-Llama-3-70B", "llama-tiny",
             "meta-llama/Llama-3.2-1B-Instruct", "mistralai/Mixtral-8x7B-Instruct-v0.1", "mixtral-8x7b",
             "google/gemma-2b", "google/gemma-2b-it", "google/gemma-7b", "gemma-tiny", "bigcode/starcoder2-3b",
             "starcoder2-tiny", "llama-moe-tiny", "acme/llama-11b", "something-else")
    for name in names:
        assert tweights.resolve_model_preset(name) == jweights.resolve_model_preset(name), name
    assert tweights.resolve_model_preset("google/gemma-7b") == "gemma-7b"


def test_family_loader_guards_raise_as_the_reference(family_ckpts):
    """StarCoder2's loader refuses a checkpoint of another depth than the
    config's (it would serve a truncated model), and ``load_hf_causal_lm``
    refuses a gated MLP with LayerNorm or biases (no published family has
    that shape), in both packages."""
    path = family_ckpts["starcoder2"][0]
    for mod, cfgs in ((jweights, jllama), (tweights, tllama)):
        kw = {} if mod is jweights else {"device": "cpu"}
        with pytest.raises(ValueError, match="checkpoint has 2 layers but config expects 3"):
            mod.load_hf_starcoder2(cfgs.starcoder2_tiny(dtype="float32", n_layers=3), path, **kw)
        with pytest.raises(ValueError, match="no HF converter for gated-MLP"):
            mod.load_hf_causal_lm(cfgs.starcoder2_tiny(dtype="float32", mlp_gated=True), path, **kw)


ST_ARRAYS = {
    "F32": np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6),
    "F16": np.linspace(-2, 2, 10, dtype=np.float16),
    "BF16": np.linspace(-1, 1, 12, dtype=np.float32).astype(ml_dtypes.bfloat16).reshape(3, 4),
    "I32": np.arange(-6, 6, dtype=np.int32).reshape(2, 6),
    "I64": np.arange(7, dtype=np.int64) * (1 << 40),
}


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", list(ST_ARRAYS))
def test_safetensors_cross_between_the_packages(tmp_path, dtype):
    arrays = {"w": ST_ARRAYS[dtype], "layers.0.x": ST_ARRAYS[dtype][::-1].copy()}
    # The port writes (numpy or torch leaves); the reference reads (BF16 as f32).
    for i, leaves in enumerate((arrays, {k: _as_torch(v) for k, v in arrays.items()})):
        path = str(tmp_path / f"port{i}.safetensors")
        tweights.save_safetensors(leaves, path)
        back = jweights._open_safetensors(path)
        for name, a in arrays.items():
            want = a.astype(np.float32) if dtype == "BF16" else a
            assert back[name].dtype == want.dtype and np.array_equal(back[name], want), name
        port_back = tweights._open_safetensors(path)
        for name, a in arrays.items():
            assert torch.equal(port_back[name], _as_torch(a)), name
    if dtype.startswith("I"):
        return  # the reference's writer has no integer dtypes
    path = str(tmp_path / "jax.safetensors")
    jweights.save_safetensors(arrays, path)
    back = tweights._open_safetensors(path)
    for name, a in arrays.items():
        assert back[name].dtype == _as_torch(a).dtype and torch.equal(back[name], _as_torch(a)), name


def test_save_safetensors_pads_its_header_to_8_bytes(tmp_path):
    path = tmp_path / "x.safetensors"
    tweights.save_safetensors({"abc": np.ones(3, np.float32)}, str(path))
    raw = path.read_bytes()
    assert (8 + int.from_bytes(raw[:8], "little")) % 8 == 0
    assert np.frombuffer(raw[-12:], np.float32).tolist() == [1.0, 1.0, 1.0]


def _hf_bert_config(num_labels=1):
    return transformers.BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                   intermediate_size=128, max_position_embeddings=128, type_vocab_size=2,
                                   layer_norm_eps=1e-12, hidden_act="gelu", num_labels=num_labels)


def _vocab_dir(path):
    (path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def bert_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert")
    out = {}
    for name, cls in (("acme--embed-tiny", transformers.BertModel),
                      ("acme--rerank-tiny", transformers.BertForSequenceClassification)):
        torch.manual_seed(2)
        model = cls(_hf_bert_config()).eval()
        with torch.no_grad():  # spread the weights so the outputs tell leaves apart
            for p in model.parameters():
                p.mul_(5.0)
        model.save_pretrained(root / name, safe_serialization=True)
        out[name] = _vocab_dir(root / name)
    torch.manual_seed(3)
    transformers.BertForSequenceClassification(_hf_bert_config(num_labels=2)).save_pretrained(
        root / "two-logits", safe_serialization=True)
    out["two-logits"] = str(root / "two-logits")
    out["root"] = str(root)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bert_loaders_leaves_equal_reference(bert_ckpts, dtype):
    jcfg, tcfg = jbert.bert_tiny(dtype=dtype), tbert.bert_tiny(dtype=dtype)
    emb, rr = bert_ckpts["acme--embed-tiny"], bert_ckpts["acme--rerank-tiny"]
    assert tweights.bert_config_from_hf(emb, dtype=dtype) == tcfg
    _assert_tree_bits_equal(tweights.load_hf_bert(tcfg, emb, device="cpu"), jweights.load_hf_bert(jcfg, emb))
    # A cross-encoder's bert.-prefixed encoder loads through load_hf_bert too.
    _assert_tree_bits_equal(tweights.load_hf_bert(tcfg, rr, device="cpu"), jweights.load_hf_bert(jcfg, rr))
    got, got_head = tweights.load_hf_cross_encoder(tcfg, rr, device="cpu")
    want, want_head = jweights.load_hf_cross_encoder(jcfg, rr)
    _assert_tree_bits_equal(got, want)
    _assert_tree_bits_equal(got_head, want_head)
    for mod, cfg, kw in ((jweights, jcfg, {}), (tweights, tcfg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="1 logit"):
            mod.load_hf_cross_encoder(cfg, bert_ckpts["two-logits"], **kw)


def test_loaded_bert_embeds_and_scores_as_the_reference(bert_ckpts):
    from generativeaiexamples_tpu.engine.embedder import TPUEmbedder
    from generativeaiexamples_tpu.engine.reranker import TPUReranker
    from generativeaiexamples_tpu.engine.tokenizer import WordPieceTokenizer as JWordPiece
    from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker

    jcfg, tcfg = jbert.bert_tiny(dtype="float32"), tbert.bert_tiny(dtype="float32")
    emb, rr = bert_ckpts["acme--embed-tiny"], bert_ckpts["acme--rerank-tiny"]
    vocab = f"{emb}/vocab.txt"
    docs = ["the quick brown fox", "retrieval augmented generation over the lazy dog", "embedding jumps"]
    want = TPUEmbedder(jcfg, jweights.load_hf_bert(jcfg, emb), tokenizer=JWordPiece(vocab)).embed_documents(docs)
    got = GPUEmbedder(tcfg, tweights.load_hf_bert(tcfg, emb, device="cpu"), tokenizer=WordPieceTokenizer(vocab),
                      device="cpu").embed_documents(docs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **F32)
    jr = TPUReranker(jcfg, *jweights.load_hf_cross_encoder(jcfg, rr), tokenizer=JWordPiece(vocab))
    tr = GPUReranker(tcfg, *tweights.load_hf_cross_encoder(tcfg, rr, device="cpu"), tokenizer=WordPieceTokenizer(vocab),
                     device="cpu")
    want = jr.score("the quick fox", docs)
    np.testing.assert_allclose(tr.score("the quick fox", docs), want, **F32)
    assert np.ptp(want) > 1e-3  # the scores tell the passages apart


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=180) as resp:
        return resp.status, resp.read().decode()


def test_build_server_serves_a_provisioned_checkpoint(llama_ckpts, bert_ckpts, jax_f32_prepared, tmp_path,
                                                      monkeypatch):
    """``$GAIE_WEIGHTS_DIR/llama-tiny`` through ``build_server`` answers
    ``/v1/completions`` with the JAX engine's greedy tokens on the same
    checkpoint; ``--embedder arctic`` loads ``--embedder-model``'s
    checkpoint and WordPiece vocab."""
    from generativeaiexamples_tpu_torch.engine.server import build_server

    shutil.copytree(llama_ckpts["untied"], tmp_path / "llama-tiny")
    shutil.copytree(bert_ckpts["acme--embed-tiny"], tmp_path / "acme--embed-tiny")
    monkeypatch.setenv("GAIE_WEIGHTS_DIR", str(tmp_path))
    # f32 compute, as the JAX side here, so the greedy tokens compare exactly.
    monkeypatch.setitem(tllama.PRESETS, "llama-tiny", lambda **kw: tllama.llama_tiny(dtype="float32", **kw))
    prompt = "hello port"
    ids = ByteTokenizer().encode(prompt)
    server = build_server([
        "--device", "cpu", "--model", "llama-tiny", "--host", "127.0.0.1", "--port", "0",
        "--max-batch", "2", "--max-len", "128", "--decode-chunk-size", "2", "--prefill-chunk-tokens", "8",
        "--embedder", "arctic", "--embedder-model", "acme/embed-tiny", "--embed-max-batch", "1",
        "--matmul-kernel", "pallas_w8a8",
    ])
    assert isinstance(server.embedder.tokenizer, WordPieceTokenizer)
    assert server.embedder.cfg.d_model == 64
    sched = server.scheduler
    sched.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
                             {"prompt": prompt, "max_tokens": 6, "temperature": 0})
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=10)
    assert status == 200
    want_ids, _ = _jax_tokens(jax_f32_prepared, ids, monkeypatch)
    assert want_ids and json.loads(body)["choices"][0]["text"] == ByteTokenizer().decode(want_ids)


def _jax_tokens(jax_prepared, ids, monkeypatch):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    jcfg, _ = _cfgs("float32")
    sched = jsched.Scheduler(jcfg, jax_prepared, matmul_kernel="pallas_w8a8", **SCHED_KW)
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    sched.start()
    try:
        sched.submit(jsched.Request(token_ids=list(ids), sampling=jsched.SamplingParams(temperature=0.0, max_tokens=6),
                                    on_token=tokens.append, on_done=done.put, eos_id=ByteTokenizer().eos_id))
        reason = done.get(timeout=180)
    finally:
        sched.stop()
    return tokens, reason


def test_a_draft_checkpoint_loads(llama_ckpts, tmp_path, monkeypatch):
    """``--draft-checkpoint``, or ``$GAIE_WEIGHTS_DIR/<draft model>``, loads
    the draft as ``w8a8_params(load_hf_causal_lm(...))`` on the W8A8 route."""
    from generativeaiexamples_tpu_torch.engine.server import parse_args, spec_scheduler_kwargs

    _, tcfg = _cfgs("bfloat16")
    want = tdecode.w8a8_params(tcfg, tweights.load_hf_llama(tcfg, llama_ckpts["untied"], device="cpu"),
                               device="cpu")
    shutil.copytree(llama_ckpts["untied"], tmp_path / "llama-tiny")
    for argv, env in ((["--draft-checkpoint", llama_ckpts["untied"]], ""), ([], str(tmp_path))):
        monkeypatch.setenv("GAIE_WEIGHTS_DIR", env)
        args = parse_args(["--device", "cpu", "--model", "llama-tiny", "--draft-model", "llama-tiny",
                           "--matmul-kernel", "pallas_w8a8", *argv])
        spec = spec_scheduler_kwargs(args, tcfg, torch.device("cpu"))
        got = spec["draft_params"]
        for name in ("wqkv", "wo", "w_gu", "w_down"):
            assert torch.equal(got["layers"][name].w, want["layers"][name].w), name
        assert torch.equal(got["lm_head"].q, want["lm_head"].q)


def _factory_env(monkeypatch, root, dims="64"):
    monkeypatch.setenv("GAIE_WEIGHTS_DIR", root)
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "tpu")
    monkeypatch.setenv("APP_EMBEDDINGS_MODELNAME", "acme/embed-tiny")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", dims)
    monkeypatch.setenv("APP_RANKING_MODELENGINE", "tpu")
    monkeypatch.setenv("APP_RANKING_MODELNAME", "acme/rerank-tiny")


def test_factories_load_the_provisioned_embedder_and_reranker_as_the_reference(bert_ckpts, clean_app_env):
    """The chain factories' ``tpu`` embedder and reranker pick up converted
    checkpoints and their WordPiece vocab from ``$GAIE_WEIGHTS_DIR``, as the
    JAX factories do (bf16 both, within the port's BERT bounds); a
    checkpoint whose width is not ``embeddings.dimensions`` raises."""
    from generativeaiexamples_tpu.chains import factory as jfactory
    from generativeaiexamples_tpu.core import configuration as jconfiguration
    from generativeaiexamples_tpu_torch.chains import factory as tfactory
    from generativeaiexamples_tpu_torch.core import configuration as tconfiguration

    _factory_env(clean_app_env, bert_ckpts["root"])
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    jfactory.reset_factories()
    tfactory.reset_factories()
    try:
        jemb, temb = jfactory.get_embedder(), tfactory.get_embedder(device="cpu")
        assert isinstance(temb.tokenizer, WordPieceTokenizer) and temb.cfg.dtype == "bfloat16"
        docs = ["the quick brown fox", "retrieval augmented generation", "lazy dog jumps"]
        assert [temb.tokenizer.encode(d) for d in docs] == [jemb.tokenizer.encode(d) for d in docs]
        np.testing.assert_allclose(np.asarray(temb.embed_documents(docs)), np.asarray(jemb.embed_documents(docs)),
                                   **BF16_EMBED)
        jrr, trr = jfactory.get_reranker(), tfactory.get_reranker(device="cpu")
        assert isinstance(trr.tokenizer, WordPieceTokenizer)
        np.testing.assert_allclose(trr.score("the quick fox", docs), jrr.score("the quick fox", docs), **BF16_SCORE)
    finally:
        jfactory.reset_factories()
        tfactory.reset_factories()
    clean_app_env.setenv("APP_EMBEDDINGS_DIMENSIONS", "32")
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    try:
        for mod, kw in ((jfactory, {}), (tfactory, {"device": "cpu"})):
            with pytest.raises(ValueError, match="embeddings.dimensions"):
                mod.get_embedder(**kw)
    finally:
        jfactory.reset_factories()
        tfactory.reset_factories()
        jconfiguration.reset_config_cache()
        tconfiguration.reset_config_cache()
