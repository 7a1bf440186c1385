"""The port's training (``engine/training.py``, ``models/llama.py``'s
remat) against the JAX package's, on the CPU: the same numpy-seeded
params and batch, tiny f32 configs (dense, MoE, Gemma), one jitted JAX
step per config (its compile is most of this file's time).

Tolerances (f32; measured in brackets):
* the loss within 1e-6 relative (0 to 1e-7);
* every gradient leaf, read as Adam's first moment after step one
  (``mu = (1 - b1) * g``, the same rounding on both sides), within 1e-5
  of the leaf's largest value (up to 1e-6);
* 3 ``make_train_step`` steps at lr 1e-3 against JAX's jitted step: each
  step's loss and grad norm within 1e-5 relative, the params within 0.1 x
  lr a step (3e-4 after three; measured up to 3.3e-5): Adam divides a
  gradient by its own size, so an element whose gradient is near 1e-8
  (next to eps) moves by a fraction of lr that its gradient's last bits
  decide;
* AdamW updates against ``optax.adamw`` on the same gradients, leaf by
  leaf, within 4 ulp of the larger of each sum's operand and result
  (measured up to 2; the moments differ by up to 2 ulp: XLA's CPU code
  contracts multiplies and adds into FMAs, torch rounds each);
* remat on and off give the same loss and gradients bit for bit (the same
  ops);
* the contrastive step on bert-tiny: loss and grad norm within 1e-5
  relative, the params after it within 1e-4 absolute (0.1 x lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativeaiexamples_tpu.engine import training as jt
from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.engine import training as tt
from generativeaiexamples_tpu_torch.engine import weights as tw
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.models import llama as tl

CONFIGS = ("llama_tiny", "llama_moe_tiny", "gemma_tiny")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Training runs thousands of tiny ops: on one intra-op thread each
    takes microseconds, on contended ones milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LR = 1e-3
STEP_ATOL = 0.1 * LR


def _batch(vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "targets": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}


def numpy_tree(shapes: dict, seed: int, gains=("attn_norm", "mlp_norm", "final_norm")) -> dict:
    """0.02-std normal leaves from numpy (norm gains around 1)."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        w = (rng.normal(size=shape) * 0.02).astype(np.float32)
        return w + 1.0 if name in gains else w

    out = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _leaves_close(jtree, ttree, atol=None, rel=None):
    """Every leaf of the JAX tree against the port's same leaf."""
    for path, want in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        want = np.asarray(want)
        got = _get(ttree, path).detach().numpy()
        assert got.shape == want.shape, path
        bound = atol if atol is not None else rel * max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=CONFIGS)
def run(request):
    """Both packages from one numpy tree: JAX's jitted step three times
    (the state after each kept as numpy), the port's step three times."""
    name = request.param
    jc = getattr(jl, name)(dtype="float32", n_layers=2, max_seq_len=64)
    tc = getattr(tl, name)(dtype="float32", n_layers=2, max_seq_len=64)
    tree = numpy_tree(tl.param_shapes(tc), seed=CONFIGS.index(name))
    b = _batch(jc.vocab_size, seed=1)
    jopt, topt = jt.make_optimizer(LR), tt.make_optimizer(LR)
    jp = _jnp(tree)
    js = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jt.make_train_step(jc, jopt))
    jstates, jmetrics = [], []
    for _ in range(3):
        js, jm = jstep(js, _jnp(b))
        jstates.append(jax.tree.map(np.asarray, js))
        jmetrics.append({k: float(v) for k, v in jm.items()})
    tp = tw.params_from_numpy(tree, tc, "cpu")
    ts = tt.TrainState(tp, topt.init(tp), 0)
    tstep = tt.make_train_step(tc, topt)
    tstates, tmetrics = [], []
    for _ in range(3):
        ts, tm = tstep(ts, b)
        tstates.append(ts)
        tmetrics.append({k: float(v) for k, v in tm.items()})
    return dict(name=name, tc=tc, tree=tree, batch=b, jstates=jstates, jmetrics=jmetrics, tstates=tstates,
                tmetrics=tmetrics, tstep=tstep)


def test_loss_and_every_gradient_match_jax(run):
    tc, b = run["tc"], {k: torch.as_tensor(v) for k, v in run["batch"].items()}
    params = tw.params_from_numpy(run["tree"], tc, "cpu")
    cfg = dataclasses.replace(tc, moe_dropless=False)  # make_train_step's MoE rule, on both sides
    loss, grads = tt.value_and_grad(lambda p: tt.loss_fn(p, cfg, b["tokens"], b["targets"], b["mask"]), params)
    want = run["jmetrics"][0]["loss"]
    assert abs(float(loss) - want) <= 1e-6 * abs(want)
    assert not any(t.requires_grad for t in tt.tree_leaves(params))  # the caller's tensors stay as they were
    b1 = tt.make_optimizer().b1
    _leaves_close(run["jstates"][0].opt_state[0].mu, tt.tree_map(lambda g: (1 - b1) * g, grads), rel=1e-5)


def test_three_steps_match_the_jitted_jax_step(run):
    for got, want in zip(run["tmetrics"], run["jmetrics"]):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    ts, js = run["tstates"][-1], run["jstates"][-1]
    assert ts.step == int(js.step) == 3 and ts.opt_state.count == 3
    _leaves_close(js.params, ts.params, atol=3 * STEP_ATOL)


def test_train_state_carried_from_jax_continues_alike(run):
    """JAX's state after step one, carried over (params, optax moments,
    count, step), takes step two as JAX does."""
    js1, js2 = run["jstates"][0], run["jstates"][1]
    ts = tw.train_state_from_numpy(js1, tw.params_from_numpy(js1.params, run["tc"], "cpu"), "cpu")
    assert ts.step == 1 and ts.opt_state.count == 1
    _leaves_close(js1.opt_state[0].mu, ts.opt_state.mu, atol=0.0)
    _leaves_close(js1.opt_state[0].nu, ts.opt_state.nu, atol=0.0)
    ts, tm = run["tstep"](ts, run["batch"])
    want = run["jmetrics"][1]["loss"]
    assert abs(float(tm["loss"]) - want) <= 1e-5 * abs(want)
    _leaves_close(js2.params, ts.params, atol=STEP_ATOL)


def test_adamw_update_matches_optax_leaf_by_leaf():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(64, 33)).astype(np.float32), "n": {"g": rng.normal(size=(7,)).astype(np.float32)}}
    opt = optax.adamw(LR, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    topt = tt.make_optimizer(LR, weight_decay=0.01)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init(tp)

    def jstep(g, s, p):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    jstep = jax.jit(jstep)
    for i in range(4):
        grads = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 10.0 ** -(2 * i)).astype(np.float32), params)
        before = jax.tree.map(np.asarray, jp)
        jp, js = jstep(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = topt.step(tp, jax.tree.map(torch.from_numpy, grads), ts)
        for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
            want = np.asarray(want)
            got = _get(tp, path).numpy()
            # ulps of the larger of the sum's operand and result
            ulp = np.spacing(np.maximum(np.abs(want), np.abs(_get(before, path))))
            assert (np.abs(got - want) <= 4 * ulp).all(), jax.tree_util.keystr(path)
        assert ts.count == int(js[0].count) == i + 1


def test_adam_without_weight_decay_is_optax_adam():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(16, 8)).astype(np.float32)
    g = rng.normal(size=(16, 8)).astype(np.float32)
    opt = optax.adam(LR)
    u, _ = opt.update(jnp.asarray(g), opt.init(jnp.asarray(p)))
    want = np.asarray(optax.apply_updates(jnp.asarray(p), u))
    topt = tt.make_optimizer(LR, weight_decay=0.0)
    got, _ = topt.step(torch.from_numpy(p), torch.from_numpy(g), topt.init(torch.from_numpy(p)))
    assert (np.abs(got.numpy() - want) <= 4 * np.spacing(np.maximum(np.abs(want), np.abs(p)))).all()


@pytest.mark.parametrize("name", ("llama_tiny", "llama_moe_tiny"))
def test_remat_gives_the_same_gradients(name):
    cfg = dataclasses.replace(getattr(tl, name)(dtype="float32", n_layers=2, max_seq_len=64), moe_dropless=False)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size, seed=4).items()}
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)

    def loss(p, remat):
        hidden, _, aux = tl.forward(p, cfg, b["tokens"], pos, remat=remat, return_aux=True)
        return tt.masked_cross_entropy(p, hidden, b["targets"], b["mask"]) + tt.MOE_AUX_WEIGHT * aux

    v1, g1 = tt.value_and_grad(lambda p: loss(p, True), params)
    v0, g0 = tt.value_and_grad(lambda p: loss(p, False), params)
    assert torch.equal(v1, v0)
    for a, c in zip(tt.tree_leaves(g1), tt.tree_leaves(g0)):
        assert torch.equal(a, c)
    off = dataclasses.replace(cfg, remat=False)
    hidden, _ = tl.forward(params, off, b["tokens"], pos, remat=True)
    assert torch.equal(hidden, tl.forward(params, cfg, b["tokens"], pos)[0])


def test_contrastive_step_matches_jax():
    jcfg, tcfg = jbert.bert_tiny(dtype="float32"), tbert.bert_tiny(dtype="float32")
    jopt, topt = jt.make_optimizer(1e-3), tt.make_optimizer(1e-3)
    tree = numpy_tree(tbert.param_shapes(tcfg), seed=5, gains=tbert._NORM_GAINS)
    js = jt.init_bert_train_state(jcfg, jopt, params=_jnp(tree))
    ts = tw.bert_train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, "cpu")
    rng = np.random.default_rng(6)
    b, n_p, s = 3, 3, 12
    lengths_q = rng.integers(4, s + 1, b)
    lengths_p = rng.integers(4, s + 1, (b, n_p))
    batch = {
        "q_tokens": rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32),
        "q_mask": (np.arange(s)[None] < lengths_q[:, None]).astype(np.int32),
        "p_tokens": rng.integers(1, jcfg.vocab_size, (b, n_p, s)).astype(np.int32),
        "p_mask": (np.arange(s)[None, None] < lengths_p[..., None]).astype(np.int32),
    }
    js, jm = jax.jit(jt.make_contrastive_train_step(jcfg, jopt))(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tm = tt.make_contrastive_train_step(tcfg, topt)(ts, batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    _leaves_close(js.params, ts.params, atol=STEP_ATOL)


def test_contrastive_batch_matches_jax():
    from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JTok
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer as TTok

    examples = [{"query": "what is a tpu", "pos_doc": "a tensor chip", "neg_doc": ["a cpu"]},
                {"query": "what is hbm", "pos_doc": "stacked memory"}]
    want = jt.make_contrastive_batch(examples, JTok(), max_length=16, n_negs=2, query_prefix="q: ")
    got = tt.make_contrastive_batch(examples, TTok(), max_length=16, n_negs=2, query_prefix="q: ")
    for key, arr in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(arr)), key


def test_train_state_checkpoint_round_trip(tmp_path):
    cfg = tl.llama_tiny(dtype="float32", n_layers=1, max_seq_len=64)
    opt = tt.make_optimizer(LR)
    state = tt.init_train_state(cfg, opt, torch.Generator().manual_seed(1), device="cpu")
    state, _ = tt.make_train_step(cfg, opt)(state, _batch(cfg.vocab_size))
    path = str(tmp_path / "state.pt")
    tt.save_train_state(state, path)
    fresh = tt.init_train_state(cfg, opt, torch.Generator().manual_seed(2), device="cpu")
    restored = tt.load_train_state(fresh, path)
    assert restored.step == state.step == 1 and restored.opt_state.count == 1
    for a, b in zip(tt.tree_leaves((state.params, state.opt_state.mu, state.opt_state.nu)),
                    tt.tree_leaves((restored.params, restored.opt_state.mu, restored.opt_state.nu))):
        assert torch.equal(a, b)
    wrong = tt.init_train_state(tl.llama_tiny(dtype="float32", n_layers=2, max_seq_len=64), opt, device="cpu")
    with pytest.raises(ValueError):
        tt.load_train_state(wrong, path)


class TestTrainedPairAcceptance:
    """``tests/test_speculative.py``'s trained pair on the port: a target
    and a draft trained with the port's trainer on one cyclic corpus reach
    non-floor acceptance for sampled requests through the port's
    ``Scheduler``, and the spec stream equals the plain one greedily."""

    @pytest.fixture(scope="class")
    def trained_pair(self):
        tcfg = tl.llama_tiny(dtype="float32", max_seq_len=64)
        dcfg = tl.llama_tiny(dtype="float32", max_seq_len=64, n_layers=1)
        rng = np.random.default_rng(0)
        period, base = 7, np.arange(10, 17)

        def batch(bsz=32, seq=33):
            rows = np.stack([np.tile(base, 6)[p : p + seq] for p in rng.integers(0, period, bsz)])
            return {"tokens": rows[:, :-1].astype(np.int32), "targets": rows[:, 1:].astype(np.int32),
                    "mask": np.ones((bsz, seq - 1), np.float32)}

        pair = []
        for cfg, seed in ((tcfg, 0), (dcfg, 1)):
            opt = tt.make_optimizer(3e-3, weight_decay=0.0)  # optax.adam(3e-3), as the reference's
            state = tt.init_train_state(cfg, opt, torch.Generator().manual_seed(seed), device="cpu")
            step = tt.make_train_step(cfg, opt)
            for _ in range(120):
                state, metrics = step(state, batch())
            assert float(metrics["loss"]) < 0.2, float(metrics["loss"])
            pair.append(state.params)
        return tcfg, dcfg, pair[0], pair[1]

    @staticmethod
    def _collect(sched, prompt, max_tokens, **sampling):
        import queue

        from generativeaiexamples_tpu_torch.engine import scheduler as tsched

        tokens, done = [], queue.Queue()
        sched.submit(tsched.Request(token_ids=list(prompt), on_token=tokens.append, on_done=done.put,
                                    sampling=tsched.SamplingParams(max_tokens=max_tokens,
                                                                   **{"temperature": 0.0, **sampling})))
        return tokens, done.get(timeout=120)

    def test_sampled_acceptance_above_floor(self, trained_pair):
        from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler

        tcfg, dcfg, tparams, dparams = trained_pair
        gamma = 3
        sched = Scheduler(tcfg, tparams, max_batch=2, max_len=64, decode_chunk_size=4, device="cpu",
                          draft_cfg=dcfg, draft_params=dparams, gamma=gamma)
        sched.start()
        try:
            tokens, reason = self._collect(sched, [10, 11, 12, 13, 14, 15, 16, 10, 11, 12], 24, temperature=0.7)
        finally:
            sched.stop()
        assert reason == "length" and len(tokens) == 24
        snap = sched.stats.snapshot()
        accept = (snap["spec_tokens"] / snap["spec_rounds"] - 1.0) / gamma
        assert accept > 0.5, f"acceptance {accept:.2f}"
        assert all(0 <= t < tcfg.vocab_size for t in tokens)

    def test_greedy_bit_identity_trained_pair(self, trained_pair):
        from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler

        tcfg, dcfg, tparams, dparams = trained_pair
        streams = []
        for kw in ({}, dict(draft_cfg=dcfg, draft_params=dparams, gamma=3)):
            sched = Scheduler(tcfg, tparams, max_batch=2, max_len=64, decode_chunk_size=4, device="cpu", **kw)
            sched.start()
            try:
                streams.append(self._collect(sched, [10, 11, 12], 20)[0])
            finally:
                sched.stop()
        assert streams[1] == streams[0] and len(streams[0]) == 20
