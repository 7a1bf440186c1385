"""The Llama forward over a mesh (``models.llama.forward(mesh=...)``) on
CPU ranks, against the reference's mesh forward on the virtual CPU
devices and the port's single-device forward, within the reference's
``rtol=2e-4, atol=2e-5`` (``tests/test_llama.py``): tensor and data
parallel at ``data=2, tensor=2``; the 70B head geometry (64 q : 8 kv) over
``tensor=4`` with a cold prefill and one decode step on the sharded
cache; the MoE over ``expert=4``; ``dense_layer(tp_axis=...)``; the
vocabulary-sharded head gathered.  Same f32 weights from a seed on both
sides; the four CPU ranks of ``torch_mesh_programs.cpu_ranks`` (20 s group
timeout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.parallel.mesh import MeshSpec as JMeshSpec
from generativeaiexamples_tpu.parallel.mesh import make_mesh as jmake_mesh
from generativeaiexamples_tpu.parallel.mesh import shard_pytree as jshard
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(dtype="float32")
G70 = dict(dtype="float32", n_heads=64, n_kv_heads=8, head_dim=8, d_model=128, d_ff=256, vocab_size=512,
           n_layers=2, max_seq_len=64)


@pytest.fixture(scope="module")
def runtime():
    return progs.cpu_ranks()


def _mesh(runtime, **spec):
    return runtime.new_mesh(MeshSpec(**spec).resolve(4))


def _jax_forward(jcfg, params, tokens, spec):
    mesh = jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:4])
    sharded = jshard(params, jllama.partition_specs(jcfg), mesh)
    pos = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
    h, _ = jax.jit(lambda p, t: jllama.forward(p, jcfg, t, pos, mesh=mesh))(sharded, jnp.asarray(tokens))
    return np.asarray(h)


def _port_forward(tcfg, tree, tokens):
    params = params_from_numpy(tree, tcfg, "cpu")
    t = torch.from_numpy(tokens).long()
    pos = torch.arange(t.shape[1], dtype=torch.int32).expand(t.shape)
    with torch.inference_mode():
        return tllama.forward(params, tcfg, t, pos)[0].numpy()


def test_tensor_and_data_parallel_forward(runtime):
    jcfg, tcfg = jllama.llama_tiny(**CFG), tllama.llama_tiny(**CFG)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 6)).astype(np.int32)
    mesh = _mesh(runtime, data=2, tensor=2)
    mesh.run(progs.load, "dense", tree, tcfg)
    got = mesh.run(progs.forward, "dense", tcfg, tokens, gather=True)
    ref = _jax_forward(jcfg, params, tokens, dict(data=2, tensor=2))
    single = _port_forward(tcfg, tree, tokens)
    for rank_out in got:  # the hidden states are whole on every rank
        np.testing.assert_allclose(rank_out, ref, **TOL)
        np.testing.assert_allclose(rank_out, single, **TOL)
    # The vocabulary-sharded head, gathered: every rank's logits are the
    # single-device logits.
    lg = mesh.run(progs.logits, "dense", tcfg, tokens, gather=True)
    want = tllama.logits(params_from_numpy(tree, tcfg, "cpu"), torch.from_numpy(single)).numpy()
    for rank_lg in lg:
        np.testing.assert_allclose(rank_lg, want, **TOL)


def test_70b_head_geometry_prefill_and_decode_on_sharded_cache(runtime):
    """llama3-70b's GQA ratio over tensor=4 (two kv heads a rank): a cold
    prefill into the sharded float cache and one decode step equal the
    unsharded forward (the reference's test of its own mesh)."""
    jcfg, tcfg = jllama.llama_tiny(**G70), tllama.llama_tiny(**G70)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    mesh = _mesh(runtime, tensor=4)
    mesh.run(progs.load, "g70", tree, tcfg)
    prompt = np.array([[5, 6, 7, 8]], np.int32)
    got = mesh.run(progs.prefill_decode, "g70", tcfg, prompt, 9, 16, gather=True)
    ref, _ = jllama.forward(params, jcfg, jnp.asarray(prompt), jnp.arange(4)[None, :])
    ref_step, _ = jllama.forward(params, jcfg, jnp.array([[5, 6, 7, 8, 9]]), jnp.arange(5)[None, :])
    for h, step in got:
        np.testing.assert_allclose(h, np.asarray(ref), **TOL)
        np.testing.assert_allclose(step[0, 0], np.asarray(ref_step[0, 4]), **TOL)


def test_expert_parallel_moe_forward(runtime):
    jcfg, tcfg = jllama.llama_moe_tiny(dtype="float32", max_seq_len=64), tllama.llama_moe_tiny(dtype="float32",
                                                                                                max_seq_len=64)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    tokens = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    mesh = _mesh(runtime, expert=4, tensor=1)
    mesh.run(progs.load, "moe", tree, tcfg)
    got = mesh.run(progs.forward, "moe", tcfg, tokens, gather=True)
    ref = _jax_forward(jcfg, params, tokens, dict(expert=4, tensor=1))
    single = _port_forward(tcfg, tree, tokens)
    for rank_out in got:
        np.testing.assert_allclose(rank_out, ref, **TOL)
        np.testing.assert_allclose(rank_out, single, **TOL)


def test_dense_layer_tp_axis(runtime):
    jcfg, tcfg = jllama.llama_tiny(**CFG), tllama.llama_tiny(**CFG)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    mesh = _mesh(runtime, data=2, tensor=2)
    mesh.run(progs.load, "layer", tree, tcfg)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    got = mesh.run(progs.dense_layer_tp, "layer", tcfg, x, gather=True)
    lp = {k: v[0] for k, v in params_from_numpy(tree, tcfg, "cpu")["layers"].items()}
    pos = torch.arange(5, dtype=torch.int32).expand(2, 5)
    with torch.inference_mode():
        want = tllama.dense_layer(torch.from_numpy(x), lp, tcfg, pos).numpy()
    jlp = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    ref = np.asarray(jllama.dense_layer(jnp.asarray(x), jlp, jcfg, jnp.asarray(pos.numpy())))
    for rank_out in got:
        np.testing.assert_allclose(rank_out, want, **TOL)
        np.testing.assert_allclose(rank_out, ref, **TOL)
    with pytest.raises(ValueError, match="mesh context"):
        tllama.dense_layer(torch.from_numpy(x), lp, tcfg, pos, tp_axis="tensor")
