"""The port's checkpoint format (``engine.weights.save_checkpoint``, the
replacement for the reference's orbax checkpoints) across mesh shapes on
four CPU ranks: a train state (bf16 params and both Adam moments after a
step) saved on one mesh loads bit for bit onto meshes of other shapes and
onto one device, and the reverse; each rank reads only its slices; and the
reference's TP-8 server test (``tests/test_scheduler.py``), ported at
``tensor=4`` (the shared runtime has four ranks; 64 : 8 heads, two KV heads
a rank), serves a chat completion from a sharded checkpoint.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from generativeaiexamples_tpu_torch.engine import mesh_serving
from generativeaiexamples_tpu_torch.engine import training as tt
from generativeaiexamples_tpu_torch.engine import weights as tw
from generativeaiexamples_tpu_torch.utils.trees import flatten
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec

CFG = tl.llama_tiny(dtype="bfloat16", n_layers=2, max_seq_len=64)


@pytest.fixture(scope="module")
def runtime():
    return progs.cpu_ranks()


def _mesh(runtime, **spec):
    return runtime.new_mesh(MeshSpec(**{"tensor": 1, **spec}).resolve(4))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32),
            "targets": rng.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32),
            "mask": np.ones((4, 16), np.float32)}


def _equal(a, b) -> None:
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for tree in ("params", "mu", "nu"):
        ta = a.params if tree == "params" else getattr(a.opt_state, tree)
        tb = b.params if tree == "params" else getattr(b.opt_state, tree)
        for (pa, x), (pb, y) in zip(flatten(ta), flatten(tb)):
            assert pa == pb and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), (tree, pa)


@pytest.fixture(scope="module")
def saved(runtime, tmp_path_factory):
    """A state stepped once on ``(data=2, tensor=2)`` (its ``tensor=2``
    shards, replicated over data), gathered, and saved by its ranks."""
    mesh = _mesh(runtime, data=2, tensor=2)
    opt = tt.make_optimizer(1e-3)
    state = tt.init_train_state(CFG, opt, torch.Generator().manual_seed(3), mesh=mesh)
    state, _ = tt.make_train_step(CFG, opt, mesh=mesh)(state, _batch())
    path = str(tmp_path_factory.mktemp("ckpt") / "tensor2")
    tt.save_train_state(state, path)
    whole = state.gather()
    state.release()
    return path, whole, opt


@pytest.mark.parametrize("spec", [dict(fsdp=2, data=2), dict(data=2, tensor=2), dict(fsdp=2, tensor=2)],
                         ids=["fsdp2-data2", "data2-tensor2", "fsdp2-tensor2"])
def test_a_mesh_checkpoint_loads_bit_for_bit_onto_other_meshes(runtime, saved, spec):
    path, whole, opt = saved
    mesh = _mesh(runtime, **spec)
    state = tt.init_train_state(CFG, opt, torch.Generator().manual_seed(9), mesh=mesh)
    try:
        mesh.run(progs.checkpoint_stats, True, gather=True)
        state = tt.load_train_state(state, path)
        read = [s["read_bytes"] for s in mesh.run(progs.checkpoint_stats, gather=True)]
        held = mesh.run(progs.state_bytes, state.key, gather=True)
        got = state.gather()
    finally:
        state.release()
    _equal(got, whole)
    # Each rank read its slices and nothing more: the bytes it holds.
    total = sum(x.numel() * x.element_size() for _, x in flatten({"p": whole.params, "m": whole.opt_state.mu,
                                                                    "n": whole.opt_state.nu}))
    assert read == held and all(r < total for r in read), (read, held, total)


def test_a_mesh_checkpoint_loads_onto_one_device_and_back(runtime, saved, tmp_path):
    path, whole, opt = saved
    one = tt.load_train_state(tt.init_train_state(CFG, opt, device="cpu"), path)
    _equal(one, whole)
    # The reverse: one device saves, a mesh of another shape loads.
    tt.save_train_state(one, str(tmp_path / "one"))
    mesh = _mesh(runtime, fsdp=4)
    state = tt.init_train_state(CFG, opt, mesh=mesh)
    try:
        got = tt.load_train_state(state, str(tmp_path / "one")).gather()
    finally:
        state.release()
    _equal(got, whole)
    # The format refuses a state of another shape.
    with pytest.raises(ValueError):
        tt.load_train_state(tt.init_train_state(tl.llama_tiny(dtype="bfloat16", n_layers=1), opt, device="cpu"),
                            path)


def test_tp4_server_serves_from_a_sharded_checkpoint(runtime, tmp_path):
    """The reference's ``test_70b_ratio_tp8_server_end_to_end`` at
    ``tensor=4``: a ratio-scaled Llama-3-70B (64 : 8 heads) saved in the
    port's format, each rank loading its slices (``RankParams("sharded")``),
    one chat completion over HTTP, and the same completion as the one
    device serving the same tree."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = tl.llama3_70b(dtype="float32", d_model=128, n_layers=2, n_heads=64, n_kv_heads=8, head_dim=8, d_ff=256,
                        vocab_size=512, max_seq_len=64)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tw.save_checkpoint({"params": params}, str(tmp_path / "ckpt"))
    mesh = _mesh(runtime, tensor=4)
    kw = dict(max_batch=2, max_len=64, decode_chunk_size=4)
    texts = {}
    for name, sched in (("mesh", Scheduler(cfg, mesh_serving.RankParams("sharded", path=str(tmp_path / "ckpt")),
                                           mesh=mesh, **kw)),
                        ("one", Scheduler(cfg, params, device="cpu", **kw))):
        if name == "mesh":
            shard = mesh.run(progs.state_keys, gather=True)
            assert all(shard)
        sched.start()
        server = create_engine_app(sched, ByteTokenizer(), model_name="llama3-70b")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            body = {"model": "llama3-70b", "messages": [{"role": "user", "content": "hello"}], "max_tokens": 8,
                    "temperature": 0.0}
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions",
                                         json.dumps(body).encode(), {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                out = json.loads(resp.read())
        finally:
            server.shutdown()
            server.server_close()
            sched.stop()
            thread.join(timeout=10)
            if name == "mesh":
                sched.release_mesh()
        assert out["choices"][0]["finish_reason"] in ("stop", "length")
        texts[name] = out["choices"][0]["message"]["content"]
    assert texts["mesh"] == texts["one"]


def test_load_checkpoint_sharded_reads_each_rank_its_serving_slice(runtime, tmp_path):
    """``load_checkpoint_sharded`` (the port of ``load_orbax_sharded``):
    each rank of a ``data=2, tensor=2`` mesh keeps the slice of a saved
    tree that ``shard_params`` cuts under the serving rules."""
    cfg = tl.llama_tiny(dtype="float32", n_layers=2, max_seq_len=64)
    params = tl.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    tw.save_checkpoint({"params": params}, str(tmp_path / "ckpt"))
    mesh = _mesh(runtime, data=2, tensor=2)
    key = tw.load_checkpoint_sharded(cfg, str(tmp_path / "ckpt"), mesh)
    assert mesh.run(progs.sharded_equals_shard_params, key, params, cfg, gather=True) == [True] * 4
