"""Ring and Ulysses attention of the port (``parallel.ring_attention``) on
CPU ranks, against the reference's single-device ``gqa_attention`` (as
the reference's own test holds its ring), the reference's sharded ring
and Ulysses on the virtual CPU mesh (4 devices, with kv_lengths) and the
port's ``gqa_attention``, within the reference's ``atol=1e-5``
(``tests/test_ring_attention.py``): at 2 and 4 ranks, with and without
``kv_lengths``, fully masked rows exactly zero, Ulysses' head-count error,
and ``ops.attention.attention``'s mesh branch.  The four CPU ranks of
``torch_mesh_programs.cpu_ranks`` serve the file (meshes of 2 and 4 ranks
over them), with a 20 s group timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from generativeaiexamples_tpu.ops.attention import gqa_attention as jgqa
from generativeaiexamples_tpu.parallel import ring_attention as jra
from generativeaiexamples_tpu.parallel.mesh import MeshSpec as JMeshSpec
from generativeaiexamples_tpu.parallel.mesh import make_mesh as jmake_mesh
from generativeaiexamples_tpu_torch.ops.attention import gqa_attention
from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec
from generativeaiexamples_tpu_torch.parallel.runtime import MeshError


@pytest.fixture(scope="module")
def meshes():
    cpu_ranks = progs.cpu_ranks()
    # Two ranks: a mesh with seq=2 over a data=2 axis (each data block a
    # ring of two); four ranks: one ring of four.
    return {2: cpu_ranks.new_mesh(MeshSpec(data=2, seq=2, tensor=1).resolve(4)),
            4: cpu_ranks.new_mesh(MeshSpec(seq=4, tensor=1).resolve(4))}


def _inputs(b=2, s=64, n_q=8, n_kv=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, n_q, d), (b, s, n_kv, d), (b, s, n_kv, d)))


def _reference(q, k, v, kv_len, strategy, n):
    mesh = jmake_mesh(JMeshSpec(seq=n, tensor=1), devices=jax.devices()[:n])
    pos = jnp.broadcast_to(jnp.arange(q.shape[1], dtype=jnp.int32), q.shape[:2])
    kl = None if kv_len is None else jnp.asarray(kv_len)
    return np.asarray(jra.sequence_parallel_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, kl,
                                                      mesh=mesh, strategy=strategy))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("kv_len", [None, [40, 17]], ids=["full", "lengths"])
def test_matches_reference_and_single_device(meshes, n, strategy, kv_len):
    q, k, v = _inputs(seed=n)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    got = meshes[n].run(progs.seq_attention, q, k, v, kl, strategy, gather=True)
    pos = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[0], -1)
    single = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), pos,
                           None if kl is None else torch.from_numpy(kl)).numpy()
    jpos = jnp.broadcast_to(jnp.arange(q.shape[1], dtype=jnp.int32), q.shape[:2])
    want = np.asarray(jgqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos,
                           None if kl is None else jnp.asarray(kl)))
    # The reference's own sharded ring, once (its shard_map compiles
    # dominate the file's time).
    ref = _reference(q, k, v, kl, strategy, n) if (n, kv_len, strategy) == (4, [40, 17], "ring") else want
    for rank_out in got:  # every rank holds the whole result
        np.testing.assert_allclose(rank_out, want, atol=1e-5)
        np.testing.assert_allclose(rank_out, ref, atol=1e-5)
        np.testing.assert_allclose(rank_out, single, atol=1e-5)


def test_fully_masked_rows_zero(meshes):
    q, k, v = _inputs()
    got = meshes[4].run(progs.seq_attention, q, k, v, np.zeros(2, np.int32), "ring")
    assert float(np.abs(got).max()) == 0.0


def test_ulysses_head_count_error_equals_reference(meshes):
    q, k, v = _inputs(n_q=6, n_kv=3)
    with pytest.raises(ValueError) as want:
        _reference(q, k, v, None, "ulysses", 4)
    with pytest.raises(MeshError) as got:
        meshes[4].run(progs.seq_attention, q, k, v, None, "ulysses")
    assert str(want.value) in str(got.value)


def test_attention_dispatch_goes_ring_over_a_seq_axis(meshes):
    q, k, v = _inputs(s=32, seed=5)
    pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32), (2, 32))
    stats0 = meshes[4].run(progs.comm_stats)["by_op"].get("ppermute", 0)
    got = meshes[4].run(progs.attention_dispatch, q, k, v)
    np.testing.assert_allclose(got, np.asarray(jgqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos)),
                               atol=1e-5)
    # The ring ran: three rotations of K, V and positions.
    assert meshes[4].run(progs.comm_stats)["by_op"]["ppermute"] - stats0 == 9
