"""The port's vision models (``models/vision.py``) and ``llama.forward
(embeds=...)`` against the JAX package's, on numpy-seeded images and the
JAX trees carried over (``engine.weights.vlm_params_from_numpy``), and
the HF ViT loader against the reference's on a seeded checkpoint.

Tolerances: patchify exact; f32 ViT features, prefixes and hidden states
within 1e-5 relative to their largest value (measured ~1e-7); bf16 ViT
features within 2e-2 relative (bf16 products rounded after sums in
another order, 2 layers); greedy VLM ids equal (f32 configs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from generativeaiexamples_tpu.engine import weights as jweights
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models import vision as JV
from generativeaiexamples_tpu_torch.engine import weights as tweights
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models import vision as TV


def _close(got, want, rel=1e-5):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def vlm_f32():
    return (JV.vlm_tiny(vit=JV.vit_tiny(dtype="float32"), lm=jllama.llama_tiny(dtype="float32")),
            TV.vlm_tiny(vit=TV.vit_tiny(dtype="float32"), lm=tllama.llama_tiny(dtype="float32")))


@pytest.fixture(scope="module")
def vlm():
    jc, tc = vlm_f32()
    jp = JV.init_vlm_params(jc, jax.random.PRNGKey(0))
    return jc, jp, tc, tweights.vlm_params_from_numpy(_np(jp), tc, "cpu")


def _images(b, size=32, seed=0):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(np.float32)


def test_patchify_is_exact():
    cfg = TV.vit_tiny()
    images = _images(2)
    want = np.asarray(JV.patchify(JV.vit_tiny(), jnp.asarray(images)))
    assert np.array_equal(TV.patchify(cfg, torch.from_numpy(images)).numpy(), want)
    # (patch row, patch column, channel) order: patch 1 is the top row's second patch.
    assert np.array_equal(want[0, 1, :3], images[0, 0, cfg.patch_size])


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_vit_encode(dtype, rel):
    jc, tc = JV.vit_tiny(dtype=dtype), TV.vit_tiny(dtype=dtype)
    jp = JV.init_vit_params(jc, jax.random.PRNGKey(1))
    tp = tweights.vit_params_from_numpy(_np(jp), tc, "cpu")
    images = _images(3, seed=1)
    want = JV.vit_encode(jp, jc, jnp.asarray(images))
    got = TV.vit_encode(tp, tc, torch.from_numpy(images))
    assert got.dtype == tc.compute_dtype
    _close(got, want.astype(jnp.float32), rel)


def test_prefix_and_generate(vlm):
    jc, jp, tc, tp = vlm
    images = _images(2, seed=2)
    _close(TV.vlm_prefix(tp, tc, torch.from_numpy(images)), JV.vlm_prefix(jp, jc, jnp.asarray(images)))
    prompt = np.asarray([[1, 68, 101, 115, 99], [1, 84, 97, 98, 108]], np.int32)
    want = JV.vlm_generate(jp, jc, jnp.asarray(images), jnp.asarray(prompt), max_new_tokens=12, eos_id=None)
    got = TV.vlm_generate(tp, tc, torch.from_numpy(images), torch.from_numpy(prompt), max_new_tokens=12)
    assert got == want
    eos = want[0][5]
    assert TV.vlm_generate(tp, tc, torch.from_numpy(images), torch.from_numpy(prompt), max_new_tokens=12,
                           eos_id=eos) == JV.vlm_generate(jp, jc, jnp.asarray(images), jnp.asarray(prompt),
                                                          max_new_tokens=12, eos_id=eos)


def test_prefill_runs_the_warm_flash_block(vlm, monkeypatch):
    """The prefill is a multi-token block over a fresh float cache longer
    than it, from position 0: ``ops.attention`` sends it to the flash
    kernel (its plain version here); decode steps do not."""
    from generativeaiexamples_tpu_torch.ops import flash_attention

    jc, jp, tc, tp = vlm
    seen = []
    real = flash_attention.flash_gqa_attention

    def spy(q, k, v, positions, kv_lengths=None):
        seen.append((q.shape[1], k.shape[1], int(positions[0, 0])))
        return real(q, k, v, positions, kv_lengths)

    monkeypatch.setattr(flash_attention, "flash_gqa_attention", spy)
    prompt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    TV.vlm_generate(tp, tc, torch.from_numpy(_images(1)), prompt, max_new_tokens=4)
    s = tc.n_prefix + 3
    assert seen == [(s, s + 4, 0)] * tc.lm.n_layers


@pytest.mark.parametrize("preset", ["llama_tiny", "gemma_tiny"])
def test_forward_with_embeds(preset):
    """``embeds`` replaces the lookup in the cacheless, cold, warm-chunk
    and decode modes; Gemma scales it by sqrt(d_model)."""
    jc = getattr(jllama, preset)(dtype="float32")
    tc = getattr(tllama, preset)(dtype="float32")
    jp = jllama.init_params(jc, jax.random.PRNGKey(3))
    tp = tweights.params_from_numpy(_np(jp), tc, "cpu")
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(2, 6, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    want, _ = jllama.forward(jp, jc, jnp.zeros((2, 6), jnp.int32), jnp.asarray(pos), embeds=jnp.asarray(emb))
    got, _ = tllama.forward(tp, tc, torch.zeros((2, 6), dtype=torch.int32), torch.from_numpy(pos),
                            embeds=torch.from_numpy(emb))
    _close(got, want)
    # Warm chunk into a float cache, then one decode step with embeds.
    jcache = jllama.init_kv_cache(jc, 2, 16)
    tcache = tllama.init_kv_cache(tc, 2, 16, device="cpu")
    lengths = np.full((2,), 6, np.int32)
    want, jcache = jllama.forward(jp, jc, jnp.zeros((2, 6), jnp.int32), jnp.asarray(pos), jcache,
                                  jnp.asarray(lengths), embeds=jnp.asarray(emb))
    got, tcache = tllama.forward(tp, tc, torch.zeros((2, 6), dtype=torch.int32), torch.from_numpy(pos), tcache,
                                 torch.from_numpy(lengths), embeds=torch.from_numpy(emb))
    _close(got, want)
    step = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
    want, _ = jllama.forward(jp, jc, jnp.zeros((2, 1), jnp.int32), jnp.full((2, 1), 6, jnp.int32), jcache,
                             jnp.full((2,), 7, jnp.int32), embeds=jnp.asarray(step))
    got, _ = tllama.forward(tp, tc, torch.zeros((2, 1), dtype=torch.int32), torch.full((2, 1), 6, dtype=torch.int32),
                            tcache, torch.full((2,), 7, dtype=torch.int32), embeds=torch.from_numpy(step))
    _close(got, want)
    # Cold prefill on the int8 cache.
    jc8, tc8 = dataclasses.replace(jc, kv_dtype="int8"), dataclasses.replace(tc, kv_dtype="int8")
    want, _ = jllama.forward(jp, jc8, jnp.zeros((2, 6), jnp.int32), jnp.asarray(pos), jllama.init_kv_cache(jc8, 2, 16),
                             jnp.asarray(lengths), embeds=jnp.asarray(emb), cold_prefill=True)
    got, _ = tllama.forward(tp, tc8, torch.zeros((2, 6), dtype=torch.int32), torch.from_numpy(pos),
                            tllama.init_kv_cache(tc8, 2, 16, device="cpu"), torch.from_numpy(lengths),
                            embeds=torch.from_numpy(emb), cold_prefill=True)
    _close(got, want)


def test_hf_vit_loader(tmp_path):
    cfg = TV.vit_tiny(dtype="float32")
    cs.write_vit_checkpoint(torch, np, tmp_path, cfg, seed=5)
    tcfg, jcfg = tweights.vit_config_from_hf(str(tmp_path)), jweights.vit_config_from_hf(str(tmp_path))
    assert (tcfg.image_size, tcfg.patch_size, tcfg.d_model, tcfg.n_layers, tcfg.n_heads, tcfg.d_ff, tcfg.norm_eps) == (
        jcfg.image_size, jcfg.patch_size, jcfg.d_model, jcfg.n_layers, jcfg.n_heads, jcfg.d_ff, jcfg.norm_eps)
    tcfg = TV.vit_tiny(dtype="float32")
    jcfg = JV.vit_tiny(dtype="float32")
    got = tweights.load_hf_vit(tcfg, str(tmp_path), device="cpu")
    want = _np(jweights.load_hf_vit(jcfg, str(tmp_path)))
    for name in want:
        if name == "layers":
            for n in want[name]:
                np.testing.assert_array_equal(got[name][n].numpy(), want[name][n], err_msg=n)
        else:
            np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    images = _images(2, seed=6)
    _close(TV.vit_encode(got, tcfg, torch.from_numpy(images)),
           JV.vit_encode(jweights.load_hf_vit(jcfg, str(tmp_path)), jcfg, jnp.asarray(images)))
