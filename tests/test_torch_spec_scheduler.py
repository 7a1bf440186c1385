"""Speculative decoding in the port's Scheduler, on the CPU.

Greedy streams of the port's speculating Scheduler equal the JAX
speculating Scheduler's and the port's plain Scheduler's, bit for bit, on
the cold, chunked, graft_warm, graft and shared admission paths, for
prompt lookup (n-gram), a tiny W8A8 int8-KV draft (``draft_quantize=True``
on the JAX side; the port's draft is W8A8 by construction) and self-draft, on the contiguous cache and the paged
pool (the JAX side runs each mode on the contiguous cache).  Same int8 weights on both sides; the JAX side runs the
append-buffer verify and exact candidate selection
(``GAIE_FORCE_APPEND_BUFFER`` / ``GAIE_EXACT_SAMPLING``).

Ported from the reference's ``tests/test_spec_serving.py``: rejected
drafts never reach parked history, a hostile draft shrinks gamma, a
``spec_draft`` fault (always and at 50%) degrades the tick and not the
request, token-normalized tick time.  Also: rows finish before the
flush-clip zone (``effective_max_len``); sampled rows' first-token
marginal matches the analytic warped target distribution (total
variation, as the reference's ``tests/test_speculative.py`` does; torch
draws cannot equal JAX keys); the server's spec flags and ``/metrics``
families from zero against the JAX server's.
"""

import asyncio
import dataclasses
import queue
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.engine import spec_decode as jspec
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import sampler as tsampler
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine import spec_decode as tspec
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, reset_faults

TINY = dict(dtype="float32", max_seq_len=128, kv_dtype="int8")
DRAFT = dict(n_layers=1, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2, head_dim=32)
JCFG, TCFG = jllama.llama_tiny(**TINY), tllama.llama_tiny(**TINY)
JDCFG, TDCFG = jllama.llama_tiny(**TINY, **DRAFT), tllama.llama_tiny(**TINY, **DRAFT)
SCHED_KW = dict(max_batch=4, max_len=128, decode_chunk_size=4, prefill_chunk_tokens=8, prefix_cache="shared")
LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged", kv_page_size=16)}
GAMMA = 3


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_threads():
    """One large elementwise op first: the first parallel torch op after
    JAX work has been seen to compute ``exp`` at reduced precision in
    fresh worker threads (``tests/test_torch_paged_scheduler.py``)."""
    torch.exp(torch.linspace(-5.0, 5.0, 1 << 20)).sum()


@pytest.fixture(scope="module")
def weights():
    raw = jdecode.init_random_int8_params(JCFG, jax.random.PRNGKey(0))
    jp = jdecode.prepare_params(
        JCFG, jdecode.prepare_params(JCFG, raw, None, pack=True), None, matmul_kernel="pallas_w8a8"
    )
    # The JAX scheduler quantizes a float draft itself (draft_quantize=True);
    # the port gets the tree it serves.
    jd_float = jllama.init_params(JDCFG, jax.random.PRNGKey(7))
    jd = jdecode.prepare_params(JDCFG, jd_float, None, quantize=True, pack=True, matmul_kernel="pallas_w8a8")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    td = params_from_numpy(jax.tree.map(np.asarray, jd), TDCFG, "cpu")
    return jp, jd_float, tp, td


def _collect(mod, scheduler, prompt, max_tokens=5, session_id="", **sampling):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    scheduler.submit(
        mod.Request(
            token_ids=list(prompt),
            sampling=mod.SamplingParams(max_tokens=max_tokens, **{"temperature": 0.0, **sampling}),
            on_token=tokens.append,
            on_done=done.put,
            session_id=session_id,
        )
    )
    return tokens, done.get(timeout=180)


PATHS = ("cold", "chunked", "graft_warm", "graft", "shared")


def _run_paths(mod, sched, paths=PATHS):
    out = {}
    sched.start()
    try:
        out["cold"] = _collect(mod, sched, [1, 2, 3, 4], 7)
        if "chunked" in paths:
            out["chunked"] = _collect(mod, sched, list(range(2, 26)), 10)
        out["graft_warm"] = _collect(mod, sched, [7, 8, 9, 7, 8, 9, 7, 8], 6, session_id="s1")
        out["graft"] = _collect(mod, sched, [7, 8, 9, 7, 8, 9, 7, 8, 9, 11], 6, session_id="s1")
        if "shared" in paths:
            # The chunked request parked its 33-token history (prompt + all
            # but the last emitted token); a prompt extending it past
            # MIN_PREFIX takes the cross-request shared-prefix graft.
            history = list(range(2, 26)) + out["chunked"][0][:9]
            out["shared"] = _collect(mod, sched, history + [100, 101], 6)
    finally:
        sched.stop()
    return out


def _spec_kw(mode, draft_cfg, draft_params, cfg, params):
    jax_side = isinstance(cfg, jllama.LlamaConfig)
    if mode == "ngram":
        return dict(spec_mode="ngram", gamma=GAMMA)
    if mode == "draft":
        quantize = dict(draft_quantize=True) if jax_side else {}
        return dict(draft_cfg=draft_cfg, draft_params=draft_params, gamma=GAMMA, **quantize)
    spec = jspec if jax_side else tspec
    dcfg, dparams = spec.self_draft(cfg, params, 1)
    return dict(draft_cfg=dcfg, draft_params=dparams, gamma=GAMMA)


@pytest.fixture(scope="module")
def plain_streams(weights):
    _, _, tp, _ = weights
    return {
        layout: _run_paths(tsched, tsched.Scheduler(TCFG, tp, device="cpu", **SCHED_KW, **kw))
        for layout, kw in LAYOUTS.items()
    }


# The JAX speculating schedulers each compile their own executables (10-20 s
# apiece on the CPU), so they run at a fixed gamma, side by side, on the
# contiguous cache: the JAX package's paged streams equal its contiguous
# ones by its own contract (``tests/test_paged_kv.py``), so the port's
# paged streams are held against the same reference.  The draft-model
# modes skip the chunked prefill and the shared-prefix graft that follows
# it, the costliest compiles: greedy streams do not depend on the draft
# (the JAX modes agree wherever they both run, checked below), so the
# port's streams on those paths are held against the n-gram run's.
JAX_PATHS = {"ngram": PATHS, "draft": ("cold", "graft_warm", "graft"), "self": ("cold", "graft_warm", "graft")}


@pytest.fixture(scope="module")
def jax_streams(weights):
    jp, jd_float, _, _ = weights
    mp = pytest.MonkeyPatch()
    mp.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    mp.setenv("GAIE_EXACT_SAMPLING", "1")
    def run(mode):
        sched = jsched.Scheduler(
            JCFG, jp, matmul_kernel="pallas_w8a8", adaptive_gamma=False, **SCHED_KW,
            **_spec_kw(mode, JDCFG, jd_float, JCFG, jp),
        )
        return _run_paths(jsched, sched, JAX_PATHS[mode]), sched.stats.snapshot()

    try:
        # Each scheduler's XLA compiles release the GIL: the three run side
        # by side.
        with ThreadPoolExecutor(len(JAX_PATHS)) as pool:
            return dict(zip(JAX_PATHS, pool.map(run, JAX_PATHS)))
    finally:
        mp.undo()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["ngram", "draft", "self"])
def test_greedy_spec_streams_equal_jax_and_plain(weights, plain_streams, jax_streams, mode, layout):
    """The port speculates with adaptive gamma, the JAX side at a fixed
    gamma: greedy streams do not depend on the lookahead."""
    _, _, tp, td = weights
    ref, ref_snap = jax_streams[mode]
    for path, stream in ref.items():
        assert stream == jax_streams["ngram"][0][path]
    ref = dict(jax_streams["ngram"][0], **ref)
    port = tsched.Scheduler(TCFG, tp, device="cpu", **SCHED_KW, **LAYOUTS[layout],
                            **_spec_kw(mode, TDCFG, td, TCFG, tp))
    out = _run_paths(tsched, port)
    assert out == ref
    assert out == plain_streams[layout]
    for snap, paths in ((ref_snap, JAX_PATHS[mode]), (port.stats.snapshot(), PATHS)):
        assert snap["spec_rounds"] > 0 and snap["spec_proposed"] >= snap["spec_accepted"] >= 0
        assert snap["prefill_chunks"] > 0 and snap["shared_prefix_hits"] == ("shared" in paths)
    assert port.effective_max_len == SCHED_KW["max_len"] - (GAMMA + 1)
    if mode == "self":  # the draft is the target's first layer: it agrees often
        assert port.stats.snapshot()["spec_accepted"] > 0


# ---------------------------------------------------------------------------
# the reference's tests/test_spec_serving.py, on the port
# ---------------------------------------------------------------------------

KW = dict(max_batch=2, max_len=128, decode_chunk_size=4, device="cpu")


def _draft(weights, **kw):
    _, _, tp, td = weights
    return tsched.Scheduler(TCFG, tp, **KW, draft_cfg=TDCFG, draft_params=td, **kw)


def _stream(sched, prompt, max_tokens, **kw):
    sched.start()
    try:
        return _collect(tsched, sched, prompt, max_tokens, **kw)
    finally:
        sched.stop()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rejected_drafts_never_reach_parked_history(weights, layout):
    """A mostly rejecting draft writes KV past the verified length every
    round; the parked segment and the radix index hold exactly prompt +
    emitted history."""
    spec = _draft(weights, gamma=4, prefix_cache="shared", **LAYOUTS[layout])
    base = list(range(2, 44))
    out, reason = _stream(spec, base, 3)
    assert reason == "length"
    segs = list(spec._prefix_index.segments())
    assert len(segs) == 1
    # A length finish never wrote the last sampled token's KV.
    assert spec._prefix_index.tokens(segs[0]) == base + out[:-1]
    snap = spec.stats.snapshot()
    assert snap["spec_proposed"] > snap["spec_accepted"]
    if layout == "paged":  # the segment holds exactly the history's pages
        pages = spec._prefix_index.pages(segs[0])
        assert len(pages) == -(-len(base + out[:-1]) // 16)


def test_hostile_draft_shrinks_gamma(weights):
    spec = _draft(weights, gamma=4)
    out, _ = _stream(spec, [5, 3, 5, 8], 24)
    assert len(out) == 24
    snap = spec.stats.snapshot()
    assert snap["spec_acceptance_ewma"] < 0.8
    assert snap["spec_gamma"] <= 2


def test_adaptive_off_keeps_max_gamma(weights):
    spec = _draft(weights, gamma=4, adaptive_gamma=False)
    _stream(spec, [5, 3, 5, 8], 12)
    assert spec.stats.snapshot()["spec_gamma"] == 4


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_spec_draft_fault_degrades_tick_not_request(weights, rate):
    """``spec_draft`` armed: the faulted ticks fall back to the plain
    chunk (always, or half the ticks, leaving the draft cache stale across
    the gaps); the stream stays the plain scheduler's."""
    _, _, tp, _ = weights
    want, _ = _stream(tsched.Scheduler(TCFG, tp, **KW), [4, 4, 2], 12)
    spec = _draft(weights, gamma=3)
    get_fault_injector().install("spec_draft", error_rate=rate)
    try:
        got, reason = _stream(spec, [4, 4, 2], 12)
    finally:
        reset_faults()
    assert reason == "length" and got == want
    snap = spec.stats.snapshot()
    assert snap["spec_fallbacks"] > 0
    if rate == 1.0:
        assert snap["spec_rounds"] == 0


def test_multi_token_ticks_normalize_tick_ms(weights):
    """A tick emitting 24 tokens for one lane of a 4-step chunk in 60 ms
    costs 10 ms per chunk-equivalent; the raw EWMA keeps 60."""
    _, _, tp, _ = weights
    sched = tsched.Scheduler(TCFG, tp, **KW)  # never started
    for _ in range(60):
        sched._tick_tokens, sched._tick_decoded = 24, 1
        sched._note_tick(60.0)
    snap = sched.stats.snapshot()
    assert snap["tick_ms_ewma"] == pytest.approx(60.0, rel=0.05)
    assert snap["tick_ms_norm_ewma"] == pytest.approx(10.0, rel=0.05)
    assert snap["tick_tokens_ewma"] == pytest.approx(24.0, rel=0.05)
    for _ in range(60):  # plain ticks: no more than the baseline, norm == raw
        sched._tick_tokens, sched._tick_decoded = 4, 1
        sched._note_tick(20.0)
    snap = sched.stats.snapshot()
    assert snap["tick_ms_norm_ewma"] == pytest.approx(snap["tick_ms_ewma"], rel=0.01)


def test_append_verify_near_length_cap(weights):
    """A row decoding to the cap finishes gamma + 1 tokens early
    (``effective_max_len``), and every token it emits is the plain
    stream's: a clipped round flush would corrupt the tail."""
    _, _, _, td = weights
    cfg = tllama.llama_tiny(dtype="float32", max_seq_len=64, kv_dtype="int8", n_heads=4, n_kv_heads=2)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    prompt = [5, 3, 5, 8, 9, 7, 9]
    kw = dict(max_batch=2, max_len=64, decode_chunk_size=4, device="cpu")
    want, want_reason = _stream(tsched.Scheduler(cfg, params, **kw), prompt, 100)
    assert want_reason == "length"
    dcfg = dataclasses.replace(TDCFG, max_seq_len=64)
    spec = tsched.Scheduler(cfg, params, **kw, draft_cfg=dcfg, draft_params=td, gamma=GAMMA)
    assert spec.effective_max_len == 64 - (GAMMA + 1)
    got, got_reason = _stream(spec, prompt, 100)
    assert got_reason == "length"
    assert len(got) == len(want) - (GAMMA + 1)
    assert got == want[: len(got)]


def test_validation(weights):
    _, _, tp, td = weights
    with pytest.raises(ValueError, match="excludes a draft model"):
        tsched.Scheduler(TCFG, tp, **KW, spec_mode="ngram", draft_cfg=TDCFG, draft_params=td)
    with pytest.raises(ValueError, match="unknown spec_mode"):
        tsched.Scheduler(TCFG, tp, **KW, spec_mode="medusa")
    with pytest.raises(ValueError, match="share a vocabulary"):
        tsched.Scheduler(TCFG, tp, **KW, draft_cfg=dataclasses.replace(TDCFG, vocab_size=256))
    with pytest.raises(ValueError, match="gamma must be"):
        tsched.Scheduler(TCFG, tp, **KW, spec_mode="ngram", gamma=0)
    with pytest.raises(ValueError, match="ngram must be"):
        tsched.Scheduler(TCFG, tp, **KW, spec_mode="ngram", ngram=0)


# ---------------------------------------------------------------------------
# sampled rows: the emitted marginal is the warped target distribution
# ---------------------------------------------------------------------------

PROMPT = [3, 1, 4, 1, 5]
SAMPLED = dict(temp=1.2, top_p=0.98, top_k=4)


def _prefilled(cfg, params, b, max_len=64):
    """A cache holding the prompt but its last token, b identical rows."""
    toks = torch.tensor([PROMPT[:-1]] * b)
    cache = tllama.init_kv_cache(cfg, b, max_len, device="cpu")
    pos = torch.arange(toks.shape[1], dtype=torch.int32).expand(b, -1)
    tllama.forward(params, cfg, toks, pos, cache, torch.full((b,), toks.shape[1], dtype=torch.int32),
                   cold_prefill=True)
    return cache


def _target_dist(params, temp, top_p, top_k):
    toks = torch.tensor([PROMPT])
    pos = torch.arange(len(PROMPT), dtype=torch.int32)[None]
    cache = tllama.init_kv_cache(TCFG, 1, 64, device="cpu")
    hidden, _ = tllama.forward(params, TCFG, toks, pos, cache, torch.tensor([len(PROMPT)], dtype=torch.int32),
                               cold_prefill=True)
    lg = tllama.logits(params, hidden)[:, -1]
    ids, probs = tsampler.warped_candidates(lg, torch.tensor([temp]), torch.tensor([top_p]), torch.tensor([top_k]))
    return ids[0].numpy(), probs[0].numpy()


def _tv(firsts, ids, probs):
    emp = np.zeros_like(probs)
    other = 0.0
    for t in firsts:
        where = np.nonzero(ids == t)[0]
        if len(where):
            emp[where[0]] += 1.0 / len(firsts)
        else:
            other += 1.0 / len(firsts)
    return 0.5 * (np.abs(emp - probs).sum() + other)


def _first_tokens(kind, tp, dparams, dcfg, temp, top_p, top_k, n_calls=64, b=16, gamma=2):
    max_len = 64
    gen = torch.Generator().manual_seed(11)
    tok = torch.full((b,), PROMPT[-1], dtype=torch.int32)
    lens = torch.full((b,), len(PROMPT) - 1, dtype=torch.int32)
    sampling = (torch.full((b,), temp), torch.full((b,), top_p), torch.full((b,), top_k, dtype=torch.int32))
    if kind == "draft":
        fn = tspec.make_spec_chunk_fn(TCFG, dcfg, max_len)
    else:
        fn = tspec.make_ngram_spec_chunk_fn(TCFG, max_len, ngram=2)
    firsts, emits = [], []
    for _ in range(n_calls):
        tcache = _prefilled(TCFG, tp, b)
        if kind == "draft":
            args = ((tp, dparams), tcache, _prefilled(dcfg, dparams, b))
        else:
            hist = torch.zeros((b, max_len), dtype=torch.int32)
            hist[:, : len(PROMPT)] = torch.tensor(PROMPT, dtype=torch.int32)
            args = (tp, tcache, hist)
        _, _, outs, n_emits = fn(*args, tok, lens, gen, *sampling, 1, gamma, max_len, True)
        firsts += outs[0, :, 0].tolist()
        emits += n_emits[0].tolist()
    return np.array(firsts), np.array(emits)


@pytest.fixture
def one_thread():
    """The sampled tests run thousands of tiny ops: with every intra-op
    thread of a busy machine contending (the tier-1 run's parallel
    workers) they took 50-117 s a case instead of 1-2 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sampled_model():
    params = tllama.init_params(tllama.llama_tiny(dtype="float32", max_seq_len=64, kv_dtype="int8"),
                                torch.Generator().manual_seed(4), "cpu")
    from generativeaiexamples_tpu_torch.engine.decode import w8a8_params

    with torch.inference_mode():
        return w8a8_params(TCFG, params, device="cpu")


def test_self_draft_sampled_rows_accept_everything(sampled_model, one_thread):
    """q == p: every draft is kept (u * q < p never fails), so each round
    emits gamma + 1 tokens, all inside the warped pool."""
    firsts, emits = _first_tokens("draft", sampled_model, sampled_model, TCFG, 1.0, 0.95, 8, n_calls=8, b=4)
    assert (emits == 3).all()
    ids, probs = _target_dist(sampled_model, 1.0, 0.95, 8)
    assert set(firsts.tolist()) <= set(ids[probs > 0].tolist())


@pytest.mark.parametrize("kind", ["perturbed", "weak", "ngram"])
def test_sampled_marginal_is_the_warped_target(sampled_model, weights, kind, one_thread):
    """A near-target draft (both accept and reject paths run), a random
    draft (the residual dominates) and prompt lookup (one-hot q): the
    first emitted token's distribution over 1,024 draws stays within total
    variation 0.08 of the analytic warped target."""
    _, _, _, td = weights
    if kind == "perturbed":
        dparams = dict(sampled_model)
        head = sampled_model["lm_head"]
        noise = torch.randn(head.q.shape, generator=torch.Generator().manual_seed(7))
        dparams["lm_head"] = dataclasses.replace(head, q=head.q + 24.0 * noise)
        firsts, emits = _first_tokens("draft", sampled_model, dparams, TCFG, **SAMPLED)
        assert (emits > 1).any() and (emits == 1).any()
    elif kind == "weak":
        firsts, _ = _first_tokens("draft", sampled_model, td, TDCFG, **SAMPLED)
    else:
        firsts, _ = _first_tokens("ngram", sampled_model, None, None, **SAMPLED)
    ids, probs = _target_dist(sampled_model, SAMPLED["temp"], SAMPLED["top_p"], SAMPLED["top_k"])
    tv = _tv(firsts, ids, probs)
    assert tv < 0.08, f"TV distance {tv:.3f} (n={len(firsts)})"


def test_unfiltered_sampled_rows_emit_one_token(sampled_model, one_thread):
    firsts, emits = _first_tokens("draft", sampled_model, sampled_model, TCFG, 1.0, 1.0, 0, n_calls=8, b=4)
    assert (emits == 1).all()
    assert ((0 <= firsts) & (firsts < TCFG.vocab_size)).all()


# ---------------------------------------------------------------------------
# the engine server: flags and /metrics
# ---------------------------------------------------------------------------


def _jax_metrics_families():
    from generativeaiexamples_tpu.engine import server as jserver

    class _Engine:
        stats = jsched.Stats()
        matmul_kernel = "xla"

    class _Request:
        app = {jserver.SCHED_KEY: _Engine(), jserver.EMBEDDER_KEY: None}

    text = asyncio.run(jserver.handle_metrics(_Request())).text
    types = [line.split() for line in text.splitlines() if line.startswith("# TYPE engine_spec")]
    return {name: kind for _, _, name, kind in types}, text


def test_metrics_spec_families_from_zero_match_jax(weights):
    from generativeaiexamples_tpu_torch.engine.server import metrics_text

    _, _, tp, _ = weights
    jfams, jtext = _jax_metrics_families()
    assert len(jfams) == 7
    text = metrics_text(tsched.Scheduler(TCFG, tp, **KW))
    fams = {line.split()[2]: line.split()[3] for line in text.splitlines() if line.startswith("# TYPE engine_spec")}
    assert list(fams.items()) == list(jfams.items())  # names, types and order
    for name in fams:
        value = next(line.split()[1] for line in text.splitlines() if line.startswith(name + " "))
        jvalue = next(line.split()[1] for line in jtext.splitlines() if line.startswith(name + " "))
        assert float(value) == float(jvalue) == 0.0


def test_server_spec_flags_map_to_scheduler_kwargs(monkeypatch):
    from generativeaiexamples_tpu_torch.engine import server as tserver

    for env in ("GAIE_SPEC_DECODE", "GAIE_SPEC_NGRAM", "GAIE_DRAFT_MODEL", "GAIE_SPEC_GAMMA",
                "GAIE_DRAFT_CHECKPOINT", "GAIE_WEIGHTS_DIR"):
        monkeypatch.delenv(env, raising=False)
    cfg = TCFG
    assert tserver.spec_scheduler_kwargs(tserver.parse_args([]), cfg, "cpu") == {}
    # --spec-decode without a draft means prompt lookup.
    kw = tserver.spec_scheduler_kwargs(tserver.parse_args(["--spec-decode"]), cfg, "cpu")
    assert kw == {"spec_mode": "ngram", "gamma": 4}
    kw = tserver.spec_scheduler_kwargs(tserver.parse_args(["--spec-ngram", "--gamma", "3"]), cfg, "cpu")
    assert kw == {"spec_mode": "ngram", "gamma": 3}
    # --spec-gamma is --gamma's other name: one value, the last given.
    kw = tserver.spec_scheduler_kwargs(tserver.parse_args(["--spec-decode", "--spec-gamma", "2"]), cfg, "cpu")
    assert kw == {"spec_mode": "ngram", "gamma": 2}
    assert tserver.parse_args(["--gamma", "3", "--spec-gamma", "2"]).gamma == 2
    monkeypatch.setenv("GAIE_SPEC_DECODE", "1")
    monkeypatch.setenv("GAIE_SPEC_GAMMA", "5")
    assert tserver.spec_scheduler_kwargs(tserver.parse_args([]), cfg, "cpu") == {"spec_mode": "ngram", "gamma": 5}
    monkeypatch.delenv("GAIE_SPEC_DECODE")
    # A draft preset, random from --seed: on xla (the default) float and
    # packed with its preset's KV dtype, on pallas_w8a8 W8A8 with int8 KV.
    kw = tserver.spec_scheduler_kwargs(tserver.parse_args(["--spec-decode", "--draft-model", "llama-tiny"]), cfg, "cpu")
    assert kw["draft_cfg"].kv_dtype == "bfloat16" and kw["draft_cfg"].n_layers == 2 and "spec_mode" not in kw
    assert kw["gamma"] == 5 and kw["draft_params"]["layers"]["wqkv"].dtype == torch.bfloat16
    kw = tserver.spec_scheduler_kwargs(
        tserver.parse_args(["--spec-decode", "--draft-model", "llama-tiny", "--matmul-kernel", "pallas_w8a8"]), cfg,
        "cpu")
    assert kw["draft_cfg"].kv_dtype == "int8" and kw["draft_params"]["layers"]["wqkv"].w.dtype == torch.int8
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserver.spec_scheduler_kwargs(
            tserver.parse_args(["--spec-ngram", "--draft-model", "llama-tiny"]), cfg, "cpu")
    # A draft checkpoint loads (tests/test_torch_weights.py); a directory
    # without safetensors raises, as the reference's loader does.
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        tserver.spec_scheduler_kwargs(
            tserver.parse_args(["--draft-model", "llama-tiny", "--draft-checkpoint", "/nonexistent"]), cfg, "cpu")


def test_server_spec_flags_fall_back_to_llm_config(monkeypatch):
    from generativeaiexamples_tpu_torch.core import configuration
    from generativeaiexamples_tpu_torch.engine import server as tserver

    for env in ("GAIE_SPEC_DECODE", "GAIE_SPEC_NGRAM", "GAIE_DRAFT_MODEL", "GAIE_SPEC_GAMMA"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("APP_LLM_SPECDECODE", "true")
    monkeypatch.setenv("APP_LLM_SPECGAMMA", "2")
    configuration.reset_config_cache()
    try:
        kw = tserver.spec_scheduler_kwargs(tserver.parse_args([]), TCFG, "cpu")
    finally:
        monkeypatch.undo()
        configuration.reset_config_cache()
    assert kw == {"spec_mode": "ngram", "gamma": 2}
