"""Speculative decoding's pieces on the card: K4 at head_dim 64 (the
Llama-3.2-1B draft's) against its plain version, and one greedy
speculation round (prompt lookup, gamma 3) of a small model on the card
against the same round on the CPU.

A CUDA kernel has no CPU mode, so these tests skip without a card (the
decision is made inside the fixture).  On a machine with one:

    python -m pytest --noconftest tests/test_torch_spec_cuda.py -q
"""

import dataclasses

import pytest
import torch

from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

FLASH_TOL = dict(atol=1e-2, rtol=2e-2)
REFERENCE_TOL = dict(atol=5e-2, rtol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_q,n_kv,s", [(32, 8, 256), (8, 8, 100), (16, 2, 77)])
def test_flash_attention_head_dim_64(dev, n_q, n_kv, s):
    """Group sizes 1, 4 and 8 at head_dim 64, s not a multiple of a tile,
    padded rows and a row with nothing visible: within tolerance, exact
    zeros where nothing is visible, counted at head_dim 64."""
    g = torch.Generator(device=dev).manual_seed(21)
    b, hd = 4, 64
    q = torch.randn(b, s, n_q, hd, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, n_kv, hd, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, n_kv, hd, device=dev, generator=g).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    pos[1, s - 37:] = -1
    lengths = torch.tensor([s, s - 37, 0, s // 2], dtype=torch.int32, device=dev)
    before = _cuda.FLASH_HD_LAUNCHES[64]
    out = fa.flash_gqa_attention(q, k, v, pos, lengths)
    assert _cuda.FLASH_HD_LAUNCHES[64] == before + 1
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    torch.testing.assert_close(out, ref, **FLASH_TOL)
    assert not out[1, s - 37:].any() and not out[2].any()


def test_flash_attention_refuses_other_head_dims(dev):
    q = torch.zeros(1, 16, 4, 96, dtype=torch.bfloat16, device=dev)
    pos = torch.arange(16, dtype=torch.int32, device=dev)[None]
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_gqa_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous(), pos)


def _to(x, d):
    if isinstance(x, dict):
        return {k: _to(v, d) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), d) for f in dataclasses.fields(x)})
    return x.to(d) if isinstance(x, torch.Tensor) else x


def test_greedy_spec_round_on_card_matches_cpu(dev):
    """A small bf16 model (head_dim 128, the kernels' geometry): the verify
    forward over the round's proposals gives logits on the card within
    REFERENCE_TOL of the CPU's from the same cache, and one prompt-lookup
    round emits the CPU round's tokens up to a first difference, where the
    CPU logits of the two tokens must lie within 2 * atol (a near tie)."""
    from generativeaiexamples_tpu_torch.engine.decode import _append_buffer, w8a8_params
    from generativeaiexamples_tpu_torch.engine.spec_decode import _ngram_drafts, make_ngram_spec_chunk_fn
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=8, n_kv_heads=2, head_dim=128,
                            d_ff=1024, max_seq_len=256, rope_theta=10000.0, kv_dtype="int8")
    gen = torch.Generator().manual_seed(4)
    params = {"cpu": w8a8_params(cfg, None, device="cpu", generator=gen)}
    params[dev] = _to(params["cpu"], dev)
    b, s, max_len, gamma = 4, 40, 128, 3
    # Repeating prompts, so prompt lookup proposes real continuations.
    prompts = torch.randint(0, cfg.vocab_size, (b, 10), generator=gen).repeat(1, 5)[:, : s + 1]
    lens = torch.tensor([s, 33, 27, 38], dtype=torch.int32)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    cache = llama.init_kv_cache(cfg, b, max_len, device="cpu")
    llama.forward(params["cpu"], cfg, prompts[:, :s], pos, cache, lens, cold_prefill=True)
    tok = prompts[torch.arange(b), lens.long()].to(torch.int32)
    hist = torch.zeros((b, max_len), dtype=torch.int32)
    for r in range(b):
        hist[r, : int(lens[r]) + 1] = prompts[r, : int(lens[r]) + 1]
    drafts = _ngram_drafts(hist, tok, lens, max_len, gamma, 2)
    inputs = torch.cat([tok[:, None], drafts], dim=1).long()
    vpos = lens[:, None] + torch.arange(gamma + 1, dtype=torch.int32)[None]
    fn = make_ngram_spec_chunk_fn(cfg, max_len, ngram=2)
    logits, outs, emits = {}, {}, {}
    for d in ("cpu", dev):
        hidden, _, _ = llama.forward(params[d], cfg, inputs.to(d), vpos.to(d), tuple(c.clone().to(d) for c in cache),
                                     lens.to(d), kv_bucket=64, append_cache=(_append_buffer(cfg, b, gamma + 1, d), 0))
        logits[d] = llama.logits(params[d], hidden).float().cpu()
        zeros = torch.zeros((b,), device=d)
        _, _, out, n_emit = fn(params[d], tuple(c.clone().to(d) for c in cache), hist.clone().to(d), tok.to(d),
                               lens.to(d),
                               torch.Generator(device=d).manual_seed(0), zeros, zeros + 1,
                               torch.zeros((b,), dtype=torch.int32, device=d), 1, gamma, 64, False)
        outs[d], emits[d] = out[0].cpu(), n_emit[0].cpu()
    torch.testing.assert_close(logits[dev], logits["cpu"], **REFERENCE_TOL)
    for r in range(b):
        n = int(min(emits["cpu"][r], emits[dev][r]))
        diff = [j for j in range(n) if outs["cpu"][r, j] != outs[dev][r, j]]
        if not diff:
            assert emits["cpu"][r] == emits[dev][r], r
            continue
        j, a, c = diff[0], int(outs["cpu"][r, diff[0]]), int(outs[dev][r, diff[0]])
        gap = abs(float(logits["cpu"][r, j, a] - logits["cpu"][r, j, c]))
        assert gap <= 2 * REFERENCE_TOL["atol"], (r, j, gap)
