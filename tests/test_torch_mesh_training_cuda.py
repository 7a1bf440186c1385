"""Training over a mesh of two ranks on one card: a ``tensor=2`` step
against one rank's step on the same draw, and K4 launched on each rank.

A small bf16 model at K4's head_dim 64 (4 / 2 heads, d 256, 2 layers).
Tolerances (bf16): the loss within 2e-3 relative and the grad norm within
1e-2 (the ranks' f32 partial sums run in another order, on bf16 values);
the updated params: at most 2% of a leaf's elements more than 0.1 x lr
from one rank's (an update that took the other sign, where a gradient
is near zero: a bf16 step is its gradient's sign at lr 1e-2).

These skip without a card.  On a card, from the repository root:

    python -m pytest --noconftest tests/test_torch_mesh_training_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LR = 1e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _reset(ctx):
    from generativeaiexamples_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()


def _k4(ctx):
    from generativeaiexamples_tpu_torch.ops import _cuda

    return _cuda.LAUNCHES["flash_attention"]


def test_tensor2_step_on_one_card_matches_one_rank(dev):
    from generativeaiexamples_tpu_torch.engine import training
    from generativeaiexamples_tpu_torch.utils.trees import flatten
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    cfg = llama.llama_tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                           n_layers=2, max_seq_len=512)
    opt = training.make_optimizer(LR)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32),
             "mask": np.ones((2, 256), np.float32)}
    one = training.init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(5), device=dev)
    one, m1 = training.make_train_step(cfg, opt)(one, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    mesh = make_mesh(MeshSpec(tensor=2), [dev, dev], timeout_s=60.0)
    try:
        state = training.init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(5), mesh=mesh)
        mesh.run(_reset)
        state, m2 = training.make_train_step(cfg, opt, mesh=mesh)(state, batch)
        launches = mesh.run(_k4, gather=True)
        got = state.gather(("params",)).params
        state.release()
    finally:
        mesh.close()
    print("loss", float(m1["loss"]), m2["loss"], "grad_norm", float(m1["grad_norm"]), m2["grad_norm"], "K4", launches)
    assert abs(m2["loss"] - float(m1["loss"])) <= 2e-3 * abs(float(m1["loss"]))
    assert abs(m2["grad_norm"] - float(m1["grad_norm"])) <= 1e-2 * abs(float(m1["grad_norm"]))
    # The forward and the remat recompute: two launches a layer on each rank.
    assert launches == [2 * cfg.n_layers] * 2
    for (path, a), (_, b) in zip(flatten(got), flatten(one.params)):
        moved = float(((a.float() - b.float().cpu()).abs() > 0.1 * LR).float().mean())
        assert moved <= 0.02, (path, moved)
