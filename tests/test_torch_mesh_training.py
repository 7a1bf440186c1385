"""Training over a mesh: the port's steps on four CPU ranks against the
JAX package's jitted steps over the same mesh axes on its virtual CPU
devices, from one numpy-seeded tree and batch (the reference's tiny
training geometry, ``__graft_entry__.py``: 4 / 2 heads, d 64, d_ff 128,
vocabulary 512, 2 layers, f32).

Meshes: ``(data=2, tensor=2)`` and ``(fsdp=2, tensor=2)`` on dense
llama; ``(seq=2, expert=2)`` on MoE with ring attention and ``(expert=2,
tensor=2)`` (the reference's mesh 2, dp x sp x ep x tp over 8 devices, cut
to four ranks); LoRA on ``(data=2, tensor=2)``; the contrastive step on
``(data=2, fsdp=2)``.

Tolerances (f32; as ``tests/test_torch_training.py``'s): the loss and the
grad norm within 1e-5 relative; every gradient, read as Adam's first
moment after the step, within 1e-5 of the leaf's largest value (or 1e-6
of the tree's largest, for a leaf whose exact gradient is zero: see
``_states_close``); the updated params within 0.1 x lr.  Sharded sums run in another order than
one device's (partial products psummed over ``tensor``, the batch's terms
over ``data``), which moves the last bits only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from generativeaiexamples_tpu.engine import lora as jlora
from generativeaiexamples_tpu.engine import training as jt
from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.parallel.mesh import MeshSpec as JMeshSpec
from generativeaiexamples_tpu.parallel.mesh import fsdp_rules as jfsdp_rules
from generativeaiexamples_tpu.parallel.mesh import make_mesh as jmake_mesh
from generativeaiexamples_tpu.parallel.mesh import shard_pytree as jshard
from generativeaiexamples_tpu_torch.engine import lora as tlora
from generativeaiexamples_tpu_torch.engine import mesh_training
from generativeaiexamples_tpu_torch.engine import training as tt
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec
from test_torch_training import LR, STEP_ATOL, _get, _jnp, _leaves_close, numpy_tree

GEOM = dict(dtype="float32", n_heads=4, n_kv_heads=2, d_model=64, d_ff=128, vocab_size=512, n_layers=2,
            max_seq_len=256)
REL = 1e-5


@pytest.fixture(scope="module")
def runtime():
    return progs.cpu_ranks()


def _batch(vocab: int, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _jmesh(spec: dict):
    return jmake_mesh(JMeshSpec(**{**dict(data=1, fsdp=1, pipe=1, seq=1, expert=1, tensor=1), **spec}),
                      devices=jax.devices()[:4])


def _tmesh(runtime, spec: dict):
    return runtime.new_mesh(MeshSpec(**{**dict(tensor=1), **spec}).resolve(4))


def _adam(opt_state):
    return next(p for p in (opt_state if isinstance(opt_state, tuple) else (opt_state,)) if hasattr(p, "mu"))


def _metrics_close(tm: dict, jm: dict) -> None:
    for key in ("loss", "grad_norm"):
        want = float(jm[key])
        assert abs(float(tm[key]) - want) <= REL * abs(want), (key, float(tm[key]), want)


def _states_close(js, got) -> None:
    """Every gradient (Adam's mu after one step) and every updated leaf.
    A gradient leaf is held within REL of its own largest value, or of
    1e-6 of the tree's largest where that is more: BERT's key bias has a
    zero gradient in exact arithmetic (the softmax ignores a constant a
    query), so both sides hold rounding noise near 1e-11 there."""
    mu = _adam(js.opt_state).mu
    floor = 1e-6 * max(float(np.abs(np.asarray(leaf)).max()) for leaf in jax.tree.leaves(mu))
    for path, want in jax.tree_util.tree_flatten_with_path(mu)[0]:
        _leaves_close({"x": want}, {"x": _get(got.opt_state.mu, path)},
                      atol=max(REL * float(np.abs(np.asarray(want)).max()), floor))
    _leaves_close(js.params, got.params, atol=STEP_ATOL)


def _llama_step(runtime, spec: dict, moe: bool, seed: int, s: int = 16):
    make_j, make_t = (jl.llama_moe_tiny, tl.llama_moe_tiny) if moe else (jl.llama_tiny, tl.llama_tiny)
    kw = dict(GEOM, n_experts=4) if moe else GEOM
    jc, tc = make_j(**kw), make_t(**kw)
    tree = numpy_tree(tl.param_shapes(tc), seed=seed)
    batch = _batch(tc.vocab_size, 4, s, seed + 1)
    jmesh = _jmesh(spec)
    jopt = jt.make_optimizer(LR)
    jp = jshard(_jnp(tree), jl.partition_specs(jc, jfsdp_rules()), jmesh)
    js = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    js, jm = jax.jit(jt.make_train_step(jc, jopt, jmesh))(js, _jnp(batch))
    mesh = _tmesh(runtime, spec)
    topt = tt.make_optimizer(LR)
    state = tt.init_train_state(tc, topt, mesh=mesh, params=tree)
    try:
        state, tm = tt.make_train_step(tc, topt, mesh=mesh)(state, batch)
        got = state.gather()
    finally:
        state.release()
    return jax.tree.map(np.asarray, js), jm, got, tm


@pytest.mark.parametrize("spec,moe", [
    (dict(data=2, tensor=2), False),
    (dict(fsdp=2, tensor=2), False),
    (dict(seq=2, expert=2), True),
    (dict(expert=2, tensor=2), True),
], ids=["data2-tensor2", "fsdp2-tensor2", "seq2-expert2-moe-ring", "expert2-tensor2-moe"])
def test_train_step_matches_the_jax_mesh_step(runtime, spec, moe):
    js, jm, got, tm = _llama_step(runtime, spec, moe, seed=len(spec) + 3 * moe)
    _metrics_close(tm, jm)
    assert got.step == 1 and got.opt_state.count == 1
    _states_close(js, got)


def test_a_short_sequence_on_seq_keeps_the_global_128_token_groups(runtime):
    """192 tokens on seq=2 (96 a rank; data=2 beside it fills the four
    ranks): the reference dispatches in groups
    of 128 cut from the whole sequence, which cross the ranks' chunks; a
    rank forming its own min(96, 128)-token groups would size capacity and
    drop tokens otherwise.  Capacity drops here (factor 0.5)."""
    kw = dict(GEOM, n_experts=4, expert_capacity_factor=0.5)
    jc, tc = jl.llama_moe_tiny(**kw), tl.llama_moe_tiny(**kw)
    tree = numpy_tree(tl.param_shapes(tc), seed=11)
    batch = _batch(tc.vocab_size, 2, 192, 12)
    jmesh = _jmesh(dict(data=2, seq=2))
    jp = jshard(_jnp(tree), jl.partition_specs(jc, jfsdp_rules()), jmesh)
    jcfg = dataclasses.replace(jc, moe_dropless=False)
    want = float(jax.jit(lambda p: jt.loss_fn(p, jcfg, *(_jnp(batch)[k] for k in ("tokens", "targets", "mask")),
                                                jmesh))(jp))
    mesh = _tmesh(runtime, dict(data=2, seq=2))
    state = tt.init_train_state(tc, tt.make_optimizer(LR), mesh=mesh, params=tree)
    try:
        rows = mesh_training.rank_rows(mesh, batch)
        got = mesh.run(mesh_training.loss_and_norm, state.key, rank_args=rows)[0]
        own = mesh.run(progs.loss_with_local_groups, state.key, rank_args=rows)
    finally:
        state.release()
    assert abs(got - want) <= REL * abs(want), (got, want)
    assert abs(own - want) > 5 * REL * abs(want), (own, want)  # the trap fails the gate (measured 8.9x)


def test_lora_step_matches_the_jax_mesh_step(runtime):
    jc, tc = jl.llama_tiny(**GEOM), tl.llama_tiny(**GEOM)
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wk", "wv", "wo"))
    tcfg = tlora.LoRAConfig(rank=4, alpha=8.0, targets=lcfg.targets)
    tree = numpy_tree(tl.param_shapes(tc), seed=21)
    rng = np.random.default_rng(22)
    adapters = {}
    for name in lcfg.targets:  # B non-zero, so A gets a gradient on step one
        d_in, d_out = tlora._TARGET_DIMS[name](tc)
        adapters[name] = {"a": (rng.normal(size=(tc.n_layers, d_in, 4)) * 0.02).astype(np.float32),
                          "b": (rng.normal(size=(tc.n_layers, 4, d_out)) * 0.02).astype(np.float32)}
    batch = _batch(tc.vocab_size, 4, 16, 23)
    jmesh = _jmesh(dict(data=2, tensor=2))
    jopt = jt.make_optimizer(LR)
    base = jshard(_jnp(tree), jl.partition_specs(jc), jmesh)
    ja = _jnp(adapters)
    js = jt.TrainState(ja, jopt.init(ja), jnp.zeros((), jnp.int32))
    js, jm = jax.jit(jlora.make_lora_train_step(jc, lcfg, jopt, base, jmesh))(js, _jnp(batch))
    mesh = _tmesh(runtime, dict(data=2, tensor=2))
    topt = tt.make_optimizer(LR)
    ta = {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in adapters.items()}
    state = tt.TrainState(ta, topt.init(ta), 0)
    state, tm = tlora.make_lora_train_step(tc, tcfg, topt, tree, mesh=mesh)(state, batch)
    try:
        got = state.gather()
    finally:
        state.release()
    _metrics_close(tm, jm)
    _states_close(jax.tree.map(np.asarray, js), got)


def test_contrastive_step_matches_the_jax_mesh_step(runtime):
    """InfoNCE over (data=2, fsdp=2): each query scored against every
    passage of the whole batch (gathered), labels offset by the rank's
    rows, the loss the mean over every query."""
    jcfg, tcfg = jbert.bert_tiny(dtype="float32"), tbert.bert_tiny(dtype="float32")
    tree = numpy_tree(tbert.param_shapes(tcfg), seed=31, gains=tbert._NORM_GAINS)
    rng = np.random.default_rng(32)
    b, n_p, s = 4, 3, 12
    batch = {
        "q_tokens": rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32),
        "q_mask": (np.arange(s)[None] < rng.integers(4, s + 1, b)[:, None]).astype(np.int32),
        "p_tokens": rng.integers(1, jcfg.vocab_size, (b, n_p, s)).astype(np.int32),
        "p_mask": (np.arange(s)[None, None] < rng.integers(4, s + 1, (b, n_p))[..., None]).astype(np.int32),
    }
    jmesh = _jmesh(dict(data=2, fsdp=2))
    jopt = jt.make_optimizer(LR)
    js = jt.init_bert_train_state(jcfg, jopt, params=_jnp(tree), mesh=jmesh)
    js, jm = jax.jit(jt.make_contrastive_train_step(jcfg, jopt))(js, _jnp(batch))
    mesh = _tmesh(runtime, dict(data=2, fsdp=2))
    topt = tt.make_optimizer(LR)
    state = tt.init_bert_train_state(tcfg, topt, params=tree, mesh=mesh)
    try:
        state, tm = tt.make_contrastive_train_step(tcfg, topt)(state, batch)
        got = state.gather()
    finally:
        state.release()
    _metrics_close(tm, jm)
    _states_close(jax.tree.map(np.asarray, js), got)


@pytest.mark.parametrize("spec", [dict(data=2, tensor=2), dict(fsdp=2, seq=2)], ids=["data2-tensor2", "fsdp2-seq2"])
def test_every_rank_issues_the_same_collectives_in_the_same_order(runtime, spec):
    """A step's collectives on each rank, from the comm counters' trace:
    forward, the remat recomputes and the backward's, op by op, axis and
    bytes; the same sequence on every rank, or a peer would wait."""
    tc = tl.llama_tiny(**GEOM)
    tree = numpy_tree(tl.param_shapes(tc), seed=41)
    mesh = _tmesh(runtime, spec)
    state = tt.init_train_state(tc, tt.make_optimizer(LR), mesh=mesh, params=tree)
    try:
        traces = mesh.run(progs.traced_step, state.key, gather=True,
                          rank_args=mesh_training.rank_rows(mesh, _batch(tc.vocab_size, 4, 16, 42)))
    finally:
        state.release()
    assert traces[0] and all(t == traces[0] for t in traces), [len(t) for t in traces]
    ops = {op for op, _, _ in traces[0]}
    assert {"psum", "all_gather"} <= ops and ("reduce_scatter" in ops) == (spec.get("fsdp", 1) > 1)


def test_global_norm_counts_a_replicated_leaf_once(runtime):
    mesh = _tmesh(runtime, dict(data=2, tensor=2))
    got = mesh.run(progs.norm_of_known_grads, gather=True)
    # A (4,) leaf replicated over both axes, a (4, 4) leaf sharded over
    # tensor (each rank holds 2 columns of ones): 4 * 1 + 16 * 1.
    assert got == [pytest.approx(20.0 ** 0.5)] * 4


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_attention_gradients(runtime, strategy):
    """The attention's dq / dk / dv with the sequence split over seq=4:
    ring attention's flow back through the inverse ppermutes, Ulysses'
    through the inverse all-to-alls (and, on the card, K4's autograd
    wrapper); against one device's autograd of the plain attention, f32
    within 1e-5 of each gradient's largest value."""
    from generativeaiexamples_tpu_torch.ops.flash_attention import flash_gqa_attention_plain

    rng = np.random.default_rng(51)
    q, k, v = (rng.normal(size=(1, 32, h, 16)).astype(np.float32) for h in (8, 4, 4))
    g = rng.normal(size=(1, 32, 8, 16)).astype(np.float32)
    mesh = _tmesh(runtime, dict(seq=4))
    got = mesh.run(progs.seq_attention_grads, q, k, v, g, strategy)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    pos = torch.arange(32, dtype=torch.int32)[None]
    out = flash_gqa_attention_plain(*leaves, pos, None)
    want = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = w.numpy()
        assert np.abs(a - w).max() <= 1e-5 * np.abs(w).max(), name
