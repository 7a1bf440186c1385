"""Training on the card: K4's autograd wrapper (``ops/flash_attention.py::
FlashAttentionFunction``) against the plain attention's autograd, and the
bf16 product's gradient (``ops/quant.py::_BF16F32Product``) against f32
autograd on the same bf16 values; a tiny training step whose attention
projections get non-zero gradients through K4, and the remat recompute
launching K4 again.

K4 runs only on a card, so these tests skip without one (the decision is
made inside the fixture).  On a machine with one:

    python -m pytest --noconftest tests/test_torch_training_cuda.py -q

Tolerances: K4's forward within ``FLASH_TOL`` (atol 1e-2, rtol 2e-2: the
kernel's bf16 roundings); dq / dk / dv within 2e-2 of their largest value
(the backward recomputes the plain attention, so only the cotangent's
path through bf16 differs); the bf16 product's gradients within 1e-2 of
their largest value (bf16 cotangent and outputs)."""

import pytest
import torch

from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

FLASH_TOL = dict(atol=1e-2, rtol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no interpret mode")
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("hd,nq,nkv,s", [(128, 32, 8, 256), (64, 8, 2, 200), (128, 8, 8, 130)])
def test_flash_function_gradients_match_the_plain_autograd(dev, hd, nq, nkv, s):
    gen = torch.Generator(device=dev).manual_seed(hd + s)
    b = 2
    q, k, v = (torch.randn(b, s, n, hd, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
               for n in (nq, nkv, nkv))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    lengths = torch.tensor([s, s - 7], dtype=torch.int32, device=dev)
    g = torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16)
    _cuda.reset_launch_counts()
    out = fa.flash_gqa_attention(q, k, v, pos, lengths)
    assert out.grad_fn is not None and _cuda.LAUNCHES["flash_attention"] == 1
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, **FLASH_TOL)
    for name, a, w in zip("qkv", got, want):
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        assert _rel(a, w) <= 2e-2, (name, _rel(a, w))
    # Without grad the kernel launches directly, with no graph.
    with torch.inference_mode():
        served = fa.flash_gqa_attention(q.detach(), k.detach(), v.detach(), pos, lengths)
    assert served.grad_fn is None and torch.equal(served, out.detach())


def test_bf16_product_gradient(dev):
    from generativeaiexamples_tpu_torch.ops.quant import f32_product

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(3, 70, 256, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
    w = (torch.randn(256, 384, device=dev, generator=gen) * 0.05).to(torch.bfloat16).requires_grad_()
    g = torch.randn(3, 70, 384, device=dev, generator=gen)
    out = f32_product(x, w)
    assert out.dtype == torch.float32
    gx, gw = torch.autograd.grad(out, (x, w), g)
    assert gx.dtype == gw.dtype == torch.bfloat16
    xf, wf = x.detach().double().requires_grad_(), w.detach().double().requires_grad_()
    wx, ww = torch.autograd.grad(torch.matmul(xf, wf), (xf, wf), g.to(torch.bfloat16).double())
    assert _rel(gx, wx) <= 1e-2 and _rel(gw, ww) <= 1e-2
    with torch.no_grad():
        assert torch.equal(out.detach(), f32_product(x.detach(), w.detach()))


def test_tiny_step_trains_the_projections_through_k4(dev):
    from generativeaiexamples_tpu_torch.engine import training
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.llama_tiny(n_heads=4, n_kv_heads=2, head_dim=128, d_model=256, n_layers=2)
    opt = training.make_optimizer(1e-3)
    state = training.init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, dtype=torch.int32)
             for k in ("tokens", "targets")}
    batch["mask"] = torch.ones(2, 128)
    b = {k: v.to(dev) for k, v in batch.items()}
    _cuda.reset_launch_counts()
    loss, grads = training.value_and_grad(
        lambda p: training.loss_fn(p, cfg, b["tokens"], b["targets"], b["mask"]), state.params)
    # Each layer launches K4 in the forward and again in the remat recompute.
    assert _cuda.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    for name in ("wq", "wk", "wv", "wo"):
        assert torch.isfinite(grads["layers"][name]).all() and grads["layers"][name].abs().max() > 0, name
    state, metrics = training.make_train_step(cfg, opt)(state, batch)
    assert torch.isfinite(metrics["grad_norm"]) and abs(float(metrics["loss"]) - float(loss)) <= 1e-3
