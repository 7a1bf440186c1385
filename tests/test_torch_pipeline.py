"""The GPipe pipeline over the ``pipe`` axis (``parallel/pipeline.py``) on
four CPU ranks against the JAX package's ``parallel/pipeline.py`` on its
virtual CPU devices: the seven tests of ``tests/test_pipeline.py``, each
held to the JAX function on the same mesh and the same numpy tree.

The runtime has four ranks, so a mesh of another size runs at the nearest
four-rank shape: ``pipe=2`` becomes ``pipe=2, data=2``; four stages with
``data`` (8 devices) become ``pipe=4``; ``data x pipe x tensor`` (8)
becomes ``pipe=2, tensor=2``.

Tolerances (f32): hidden states within the reference test's 2e-4 relative
and 2e-5 absolute; losses and grad norms within 1e-5 relative; the step's
params within 0.1 x lr and its gradients (Adam's mu) within 1e-5 of each
leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_programs as progs
from generativeaiexamples_tpu.engine import training as jt
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.parallel import pipeline as jpipe
from generativeaiexamples_tpu.parallel.mesh import MeshSpec as JMeshSpec
from generativeaiexamples_tpu.parallel.mesh import make_mesh as jmake_mesh
from generativeaiexamples_tpu.parallel.mesh import shard_pytree as jshard
from generativeaiexamples_tpu_torch.engine import mesh_training
from generativeaiexamples_tpu_torch.engine import training as tt
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.parallel import pipeline as tpipe
from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec
from test_torch_mesh_training import _metrics_close, _states_close
from test_torch_training import LR, _jnp, numpy_tree

JCFG = jl.llama_tiny(dtype="float32", n_layers=4, max_seq_len=64)
TCFG = tl.llama_tiny(dtype="float32", n_layers=4, max_seq_len=64)


def _meshes(runtime, pipe, data=1, tensor=1):
    spec = dict(data=data, fsdp=1, pipe=pipe, seq=1, expert=1, tensor=tensor)
    jmesh = jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[: pipe * data * tensor])
    return jmesh, runtime.new_mesh(MeshSpec(**spec).resolve(4))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (b, s)).astype(np.int32)


def _batch(b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, JCFG.vocab_size, (b, s)).astype(np.int32),
            "targets": rng.integers(0, JCFG.vocab_size, (b, s)).astype(np.int32),
            "mask": np.ones((b, s), np.float32)}


def _forward_both(runtime, pipe, data, tensor, b, seed):
    tree = numpy_tree(tl.param_shapes(TCFG), seed=seed)
    jmesh, mesh = _meshes(runtime, pipe, data, tensor)
    tokens = _tokens(b, 16, seed)
    positions = jnp.broadcast_to(jnp.arange(16), (b, 16)).astype(jnp.int32)
    sharded = jshard(_jnp(tree), jl.partition_specs(JCFG, jpipe.pipeline_rules(tensor=tensor > 1)), jmesh)
    want = np.asarray(jax.jit(lambda p, t: jpipe.pipeline_forward(p, JCFG, t, positions, jmesh))(
        sharded, jnp.asarray(tokens)))
    got = mesh.run(progs.pipeline_hidden, TCFG, tree, tensor > 1, tokens)
    return got, want


def test_pipeline_forward_matches_the_jax_pipeline():
    """``pipe=2`` (the reference's two stages), with ``data=2`` to fill
    four ranks."""
    got, want = _forward_both(progs.cpu_ranks(), pipe=2, data=2, tensor=1, b=4, seed=0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_pipeline_forward_four_stages():
    """Four stages (the reference's ``pipe=4, data=2`` on eight devices;
    ``pipe=4`` here)."""
    got, want = _forward_both(progs.cpu_ranks(), pipe=4, data=1, tensor=1, b=8, seed=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _step_both(runtime, pipe, data, tensor, b, seed):
    tree = numpy_tree(tl.param_shapes(TCFG), seed=seed)
    batch = _batch(b, 16, seed)
    jmesh, mesh = _meshes(runtime, pipe, data, tensor)
    jrules = jpipe.pipeline_rules(tensor=tensor > 1)
    sharded = jshard(_jnp(tree), jl.partition_specs(JCFG, jrules), jmesh)
    jb = _jnp(batch)
    ref_loss = float(jt.loss_fn(_jnp(tree), JCFG, jb["tokens"], jb["targets"], jb["mask"]))
    jopt = jt.make_optimizer(LR)
    js = jt.TrainState(sharded, jopt.init(sharded), jnp.zeros((), jnp.int32))
    js, jm = jax.jit(jpipe.make_pipeline_train_step(JCFG, jopt, jmesh))(js, jb)
    topt = tt.make_optimizer(LR)
    state = tt.init_train_state(TCFG, topt, mesh=mesh, params=tree, rules=tpipe.pipeline_rules(tensor=tensor > 1))
    try:
        state, tm = tpipe.make_pipeline_train_step(TCFG, topt, mesh)(state, batch)
        got = state.gather()
    finally:
        state.release()
    return ref_loss, jax.tree.map(np.asarray, js), jm, got, tm


def test_pipeline_train_step_matches_the_jax_pipelined_step():
    """The pipelined loss equals the plain loss, and one step (loss, grad
    norm, every gradient and updated leaf) equals JAX's pipelined step, at
    ``pipe=2, data=2``."""
    ref_loss, js, jm, got, tm = _step_both(progs.cpu_ranks(), 2, 2, 1, b=4, seed=2)
    assert abs(tm["loss"] - ref_loss) <= 2e-4 * abs(ref_loss) + 2e-5
    _metrics_close(tm, jm)
    assert np.isfinite(tm["loss"]) and tm["grad_norm"] > 0
    _states_close(js, got)


def test_pipeline_loss_has_no_activation_broadcast():
    """The loss forward's collectives, from the comm counters' trace (the
    reference pins its HLO): one ppermute over ``pipe`` a tick, each one
    microbatch activation (mb, s, d), and scalar psums over ``pipe`` and
    ``data``; nothing else, and nothing activation-sized but the hand-offs."""
    runtime = progs.cpu_ranks()
    tree = numpy_tree(tl.param_shapes(TCFG), seed=0)
    _, mesh = _meshes(runtime, pipe=2, data=2)
    b, s, M, S = 4, 16, 2, 2
    state = tt.init_train_state(TCFG, tt.make_optimizer(LR), mesh=mesh, params=tree,
                                rules=tpipe.pipeline_rules())
    try:
        rows = mesh_training.rank_rows(mesh, _batch(b, s, 0))
        got = mesh.run(progs.traced_pipeline_loss, state.key, gather=True, rank_args=rows)
    finally:
        state.release()
    mb = b // (2 * M)
    act_bytes = mb * s * TCFG.d_model * 4
    for _, trace in got:
        hand_offs = [t for t in trace if t[0] == "ppermute"]
        assert hand_offs == [("ppermute", "pipe", act_bytes)] * (M + S - 1)
        others = [t for t in trace if t[0] != "ppermute"]
        assert sorted(others) == sorted([("psum", "pipe", 4), ("psum", "data", 4)] * 2), others
    assert len({loss for loss, _ in got}) == 1


def test_pipeline_tp_forward_matches_the_jax_pipeline():
    """Megatron tensor parallelism inside each stage (``pipe=2,
    tensor=2``)."""
    got, want = _forward_both(progs.cpu_ranks(), pipe=2, data=1, tensor=2, b=4, seed=3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_pipeline_tp_loss_and_train_step():
    """The reference's ``data x pipe x tensor`` (2 x 2 x 2) at ``pipe=2,
    tensor=2``: the pipelined TP loss equals the plain loss and the step
    equals JAX's."""
    ref_loss, js, jm, got, tm = _step_both(progs.cpu_ranks(), 2, 1, 2, b=8, seed=4)
    assert abs(tm["loss"] - ref_loss) <= 2e-4 * abs(ref_loss) + 2e-5
    _metrics_close(tm, jm)
    _states_close(js, got)


def test_pipeline_tp_rejects_indivisible_heads():
    cfg = tl.llama_tiny(dtype="float32", n_layers=4, n_heads=3, n_kv_heads=3, head_dim=16, d_model=48,
                        max_seq_len=64)
    with pytest.raises(ValueError, match="not divisible by tensor"):
        tpipe.check_pipeline(cfg, dict(data=1, pipe=2, tensor=2), 4, None)
    with pytest.raises(ValueError, match="not divisible by pipe"):
        tpipe.check_pipeline(tl.llama_tiny(n_layers=3), dict(pipe=2), 4, None)
    with pytest.raises(ValueError, match="multiple of data"):
        tpipe.check_pipeline(TCFG, dict(data=2, pipe=2), 6, 2)
    with pytest.raises(NotImplementedError, match="dense"):
        tpipe.check_pipeline(tl.llama_moe_tiny(n_layers=4), dict(pipe=2), 4, None)
