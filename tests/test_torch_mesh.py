"""The port's mesh (``parallel.mesh``, ``parallel.comm``,
``parallel.runtime``) against the reference's, on CPU ranks.

``MeshSpec.resolve`` and its errors, ``replica_device_slices`` and
``logical_to_partition`` equal the reference's; each rank's slice of
every param leaf (float and ``QuantizedMatrix``) equals the shard
``jax.device_put(x, NamedSharding(mesh, spec))`` puts on the device at
the same mesh position (the 8 virtual CPU devices of ``conftest.py``);
the collectives; a rank's failure and a killed follower raise and do not
hang; ``close()`` leaves no process behind; the engine server's
``--tensor-parallel`` plans.  One group of four CPU ranks (gloo, ``file://``
rendezvous; ``torch_mesh_programs.cpu_ranks``) serves the mesh files of a
test process, with a 20 s group timeout.
"""

import time

import jax
import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.parallel import mesh as jmesh
from generativeaiexamples_tpu_torch.engine.server import mesh_plans, parse_args
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.parallel import mesh as tmesh
from generativeaiexamples_tpu_torch.parallel.runtime import MeshError, Runtime

TIMEOUT_S = 20.0


@pytest.fixture(scope="module")
def runtime():
    return progs.cpu_ranks()


@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(data=2), 8), (dict(data=2, tensor=2), 4), (dict(seq=4, tensor=1), 4),
    (dict(data=2, expert=2, tensor=-1), 8), (dict(tensor=-1, data=-1), 8), (dict(data=3), 8),
    (dict(data=2, tensor=2), 8), (dict(data=0), 4),
])
def test_mesh_spec_resolve_equals_reference(spec, n):
    def outcome(cls):
        try:
            return cls(**spec).resolve(n)
        except (ValueError, ZeroDivisionError) as e:
            return type(e).__name__, str(e)

    assert outcome(tmesh.MeshSpec) == outcome(jmesh.MeshSpec)


@pytest.mark.parametrize("n,devices", [(1, 8), (2, 8), (4, 8), (8, 8), (3, 8), (0, 8), (2, 2)])
def test_replica_device_slices_equal_reference(n, devices):
    def outcome(fn):
        try:
            return fn(n, list(range(devices)))
        except ValueError as e:
            return str(e)

    assert outcome(tmesh.replica_device_slices) == outcome(jmesh.replica_device_slices)


def test_rules_and_partition_equal_reference():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.default_rules() == jmesh.default_rules()
    assert tmesh.fsdp_rules() == jmesh.fsdp_rules()
    for axes in (("vocab", "embed"), ("layers", "heads", None), ("batch", "seqlen", "mlp"), ()):
        for rules in (None, jmesh.fsdp_rules()):
            assert tmesh.logical_to_partition(axes, rules) == tuple(jmesh.logical_to_partition(axes, rules))
    for cfgs in ((jllama.llama_tiny(), tllama.llama_tiny()), (jllama.llama_moe_tiny(), tllama.llama_moe_tiny()),
                 (jllama.starcoder2_tiny(), tllama.starcoder2_tiny())):
        jspecs = jax.tree.map(tuple, jllama.partition_specs(cfgs[0]),
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert tllama.partition_specs(cfgs[1]) == jspecs
        assert tllama.kv_cache_specs(tllama.llama_tiny(kv_dtype="int8")) == tuple(
            tuple(s) for s in jllama.kv_cache_specs(jllama.llama_tiny(kv_dtype="int8")))


def _jax_shards(tree, specs, spec):
    """{device id: shard of every leaf} under the JAX NamedSharding."""
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec), devices=jax.devices()[:4])
    sharded = jmesh.shard_pytree(tree, specs, mesh)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        for shard in leaf.addressable_shards:
            out.setdefault(shard.device.id, {})[jax.tree_util.keystr(path)] = np.asarray(shard.data)
    return out


def _quant_specs(params, specs):
    """The reference's ``prepare_params`` scale specs for QuantizedMatrix."""
    from generativeaiexamples_tpu.ops.quant import QuantizedMatrix
    from jax.sharding import PartitionSpec as P

    def one(p, s):
        if not isinstance(p, QuantizedMatrix):
            return s
        parts = tuple(s) + (None,) * (p.q.ndim - len(tuple(s)))
        return QuantizedMatrix(q=s, scale=P(*(None if d == 1 else a for d, a in zip(p.scale.shape,
                                                                                 parts[-p.scale.ndim:]))))

    return jax.tree.map(one, params, specs, is_leaf=lambda x: isinstance(x, QuantizedMatrix))


@pytest.mark.parametrize("spec,quantized", [(dict(data=2, tensor=2), True), (dict(tensor=4), False),
                                            (dict(expert=4, tensor=1), True)], ids=["dp2tp2-int8", "tp4-float",
                                                                                    "ep4-int8"])
def test_rank_slices_equal_named_sharding_shards(runtime, spec, quantized):
    moe = "expert" in spec
    jcfg = (jllama.llama_moe_tiny if moe else jllama.llama_tiny)(dtype="float32")
    tcfg = (tllama.llama_moe_tiny if moe else tllama.llama_tiny)(dtype="float32")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    if quantized:
        params = jdecode.prepare_params(jcfg, params, None, quantize=True)
    shards = _jax_shards(params, _quant_specs(params, jllama.partition_specs(jcfg)), spec)
    tree = jax.tree.map(np.asarray, params)
    sizes = tmesh.MeshSpec(**spec).resolve(4)
    mesh = runtime.new_mesh(sizes)
    got = mesh.run(progs.shard_tree, tree, tcfg, gather=True)
    if not quantized:  # shard_pytree: the same slices, leaf by leaf, without a rank
        for rank in range(4):
            mine = tmesh.shard_pytree(tree, tllama.partition_specs(tcfg), sizes, tmesh.rank_coords(sizes, rank))
            for path, leaf in jax.tree_util.tree_flatten_with_path(mine)[0]:
                np.testing.assert_array_equal(leaf, shards[jax.devices()[rank].id][jax.tree_util.keystr(path)])
    for rank, rank_tree in enumerate(got):
        flat = jax.tree_util.tree_flatten_with_path(rank_tree)[0]
        want = shards[jax.devices()[rank].id]
        names = {}
        for path, leaf in flat:
            key = jax.tree_util.keystr(path)
            # (q, scale) tuples stand for QuantizedMatrix(q, scale).
            key = key.replace("[0]", ".q").replace("[1]", ".scale") if key.endswith(("[0]", "[1]")) else key
            names[key] = leaf
        assert len(names) == len(want)
        for key, leaf in names.items():
            ref = want[key]
            if key.endswith("['lm_head'].q"):  # held in the compute dtype: int8 -> f32 is exact
                ref = ref.astype(np.float32)
            np.testing.assert_array_equal(leaf, ref, err_msg=f"rank {rank} {key}")


def test_collectives(runtime):
    mesh = runtime.new_mesh(tmesh.MeshSpec(data=2, tensor=2).resolve(4))
    infos = mesh.run(progs.info, gather=True)
    assert [i[0] for i in infos] == [0, 1, 2, 3]
    assert [i[1]["data"] for i in infos] == [0, 0, 1, 1] and [i[1]["tensor"] for i in infos] == [0, 1, 0, 1]
    assert len({i[2] for i in infos}) == 4  # four processes
    stats0 = mesh.run(progs.comm_stats)
    # A psum of ones over each tensor pair, ranks (0, 1) and (2, 3).
    assert mesh.run(progs.psum_ones, gather=True) == [2.0, 2.0, 2.0, 2.0]
    assert mesh.run(progs.comm_stats)["collectives"] == stats0["collectives"] + 1
    assert mesh.run(progs.comm_stats)["staged_bytes"] == 0  # CPU ranks stage nothing


def test_failures_and_close():
    """A failure on every rank alike leaves the ranks in step; a failure
    on one breaks the mesh; ``close()`` leaves no process behind."""
    import multiprocessing

    rt = Runtime(["cpu"] * 2, timeout_s=TIMEOUT_S)
    procs = list(rt._procs)
    try:
        mesh = rt.new_mesh(tmesh.MeshSpec(tensor=2).resolve(2))
        with pytest.raises(MeshError, match="planted failure"):
            mesh.run(progs.fail)
        assert rt.alive  # every rank failed alike, before any collective
        assert len(mesh.run(progs.info, gather=True)) == 2
        with pytest.raises(MeshError, match="planted failure"):
            mesh.run(progs.fail, 1)
        assert not rt.alive  # rank 1 failed alone: the ranks are out of step
        with pytest.raises(MeshError, match="broken"):
            mesh.run(progs.info)
    finally:
        mesh.close()
    assert not any(p.is_alive() for p in procs)
    assert not [c for c in multiprocessing.active_children() if c in procs]
    with pytest.raises(MeshError, match="closed"):
        mesh.run(progs.info)


def test_killed_follower_raises_within_timeout():
    rt = Runtime(["cpu"] * 2, timeout_s=5.0)
    mesh = rt.new_mesh(tmesh.MeshSpec(tensor=2).resolve(2))
    procs = list(rt._procs)
    assert mesh.run(progs.psum_ones) == 2.0
    procs[0].kill()
    procs[0].join(timeout=10)
    t0 = time.perf_counter()
    with pytest.raises(MeshError):
        mesh.run(progs.psum_ones)
    assert time.perf_counter() - t0 < 5.0 + 5.0
    with pytest.raises(MeshError):
        mesh.run(progs.info)
    rt.close()
    assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("argv,n,pool,want", [
    ([], 4, False, [("tensor", 4, "data", 1)]),
    (["--tensor-parallel", "2"], 4, False, [("tensor", 2, "data", 2)]),
    (["--tensor-parallel", "1"], 4, False, [None]),
    ([], 1, False, [None]),
    (["--tensor-parallel", "3"], 4, False, SystemExit),
    (["--replicas", "2"], 4, True, [("tensor", 2, "data", 1)] * 2),
    (["--replicas", "2", "--tensor-parallel", "1"], 4, True, [("tensor", 1, "data", 2)] * 2),
    (["--replicas", "4"], 4, True, [None] * 4),
    (["--replicas", "3"], 4, True, [None] * 3),
    (["--replicas", "2", "--tensor-parallel", "8"], 8, True, [("tensor", 4, "data", 1)] * 2),
    (["--replicas", "2", "--tensor-parallel", "3"], 8, True, SystemExit),
])
def test_tensor_parallel_plans_follow_reference_rules(argv, n, pool, want):
    devices = [torch.device("cuda", i) for i in range(n)]
    args = parse_args(argv)
    if want is SystemExit:
        with pytest.raises(SystemExit):
            mesh_plans(args, devices, pool)
        return
    got = mesh_plans(args, devices, pool)
    assert [None if p is None else ("tensor", p[0].tensor, "data", p[0].data) for p in got] == want
    slices = [p[1] for p in got if p is not None]
    assert all(len(set(map(str, s))) == len(s) for s in slices)
    assert len({str(d) for s in slices for d in s}) == sum(len(s) for s in slices)


def test_tensor_parallel_env_default(monkeypatch):
    monkeypatch.setenv("GAIE_TENSOR_PARALLEL", "2")
    assert parse_args([]).tensor_parallel == 2
    assert mesh_plans(parse_args(["--device", "cpu"]), [torch.device("cpu")] * 2, False)[0][0].tensor == 2


@pytest.mark.parametrize("spec", [dict(data=2, tensor=2), dict(tensor=4)], ids=["two-rank-lines", "four-rank-line"])
def test_shared_memory_line_matches_gloo(runtime, spec):
    """The shared-memory line (what ranks sharing a card use) against gloo
    on the same CPU ranks: every collective's bytes equal; sums equal bit
    for bit on two-rank lines (a + b either way) and within f32 rounding
    on a four-rank line (gloo sums in another order); 36 MB of f32 and
    of bf16 cross two 32 MB rounds.  The rank program attaches the line
    to the CPU ranks' gloo group for one call."""
    axis = "tensor"
    sizes = tmesh.MeshSpec(**spec).resolve(4)
    mesh = runtime.new_mesh(sizes)
    gloo = mesh.run(progs.collectives_of, axis, gather=True)
    shared = mesh.run(progs.collectives_of, axis, True, gather=True)
    n = sizes[axis]
    for a, b in zip(gloo, shared):
        for key, want in a.items():
            if n > 2 and key.startswith(("psum", "reduce_scatter")) and not key.startswith("big"):
                np.testing.assert_allclose(b[key], want, rtol=1e-6, atol=1e-6, err_msg=key)
            else:
                assert np.array_equal(b[key], want), key
    assert shared[0]["big_psum"].tolist() == shared[0]["big_psum_bf16"].tolist() == [n * (n + 1) / 2] * 2
