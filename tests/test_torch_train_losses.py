"""The port's training losses of the model services against the JAX
package's, on the CPU: ``models/vision.py::vlm_caption_loss`` (the VLM
tiny, f32) and ``models/speech.py::tts_loss`` (FastSpeech tiny), each loss
and every gradient against ``jax.value_and_grad`` on the same numpy-seeded
params and inputs; and the speech forwards' training
twins (``asr_train_forward``, ``w2v2_train_forward``) differentiated
against ``jax.grad`` while their serving wrappers stay under
``inference_mode``.

Tolerances (f32): losses within 1e-5 relative (measured ~1e-7); every
gradient leaf within 1e-4 of its largest value (measured up to ~2e-6:
f32 sums in other orders through 2-4 layers, and the products' f32
gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models import speech as JS
from generativeaiexamples_tpu.models import vision as JV
from generativeaiexamples_tpu_torch.engine import training as tt
from generativeaiexamples_tpu_torch.engine import weights as tw
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models import speech as TS
from generativeaiexamples_tpu_torch.models import vision as TV
from test_torch_training import one_intra_op_thread  # noqa: F401 (autouse)

GRAD_REL = 1e-4
# Leaves whose gradient is zero in exact arithmetic (wav2vec2's key bias:
# the softmax ignores it) hold rounding noise only (measured ~5e-14).
GRAD_FLOOR = 1e-10


def _seeded(shapes, rng, gains=()):
    """A numpy tree of 0.02-std normal leaves in ``shapes``' structure (the
    named gains around 1)."""
    if isinstance(shapes, dict):
        return {k: (_seeded(v, rng, gains) if isinstance(v, (dict, list)) else
                    (rng.normal(size=v) * 0.02 + (1.0 if k in gains else 0.0)).astype(np.float32))
                for k, v in shapes.items()}
    return [_seeded(v, rng, gains) for v in shapes]


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _grads_close(jgrads, tgrads):
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        got = tgrads
        for k in path:
            got = got[k.key if hasattr(k, "key") else k.idx]
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_REL * scale + GRAD_FLOOR, (jax.tree_util.keystr(path), err, scale)


def test_vlm_caption_loss_and_gradients_match_jax():
    jc = JV.vlm_tiny(vit=JV.vit_tiny(dtype="float32"), lm=jllama.llama_tiny(dtype="float32", n_layers=2))
    tc = TV.vlm_tiny(vit=TV.vit_tiny(dtype="float32"), lm=tllama.llama_tiny(dtype="float32", n_layers=2))
    rng = np.random.default_rng(0)
    tree = {"vit": _seeded(TV.vit_param_shapes(tc.vit), rng, gains=("ln1_g", "ln2_g", "final_ln_g")),
            "projector": _seeded({"p": (tc.vit.d_model, tc.lm.d_model)}, rng)["p"],
            "lm": _seeded(tllama.param_shapes(tc.lm), rng, gains=tllama.NORM_GAINS)}
    jp, tp = _jnp(tree), tw.vlm_params_from_numpy(tree, tc, "cpu")
    images = rng.random((2, 32, 32, 3)).astype(np.float32)
    text = rng.integers(1, 256, (2, 6)).astype(np.int32)
    inp = np.concatenate([np.full((2, 1), 1, np.int32), text[:, :-1]], axis=1)
    mask = np.ones((2, 6), np.float32)
    mask[1, 4:] = 0.0
    jloss, jgrads = jax.jit(jax.value_and_grad(JV.vlm_caption_loss), static_argnums=1)(
        jp, jc, jnp.asarray(images), jnp.asarray(inp), jnp.asarray(text), jnp.asarray(mask))
    args = [torch.from_numpy(a) for a in (images, inp, text, mask)]
    tloss, tgrads = tt.value_and_grad(lambda p: TV.vlm_caption_loss(p, tc, *args), tp)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(jgrads, tgrads)
    # The ViT and the projector are trained through the prefix.
    assert tgrads["vit"]["patch_proj"].abs().max() > 0 and tgrads["projector"].abs().max() > 0


def test_tts_loss_and_gradients_match_jax():
    jc, tc = JS.tts_tiny(), TS.tts_tiny()
    rng = np.random.default_rng(1)
    tree = _seeded(TS.tts_param_shapes(tc), rng, gains=("attn_norm", "mlp_norm"))
    jp, tp = _jnp(tree), tw.speech_params_from_numpy(tree, TS.tts_param_shapes(tc), "cpu")
    ids = np.zeros((2, 10), np.int32)
    ids[0, :10] = rng.integers(1, TS.N_VOCAB, 10)
    ids[1, :7] = rng.integers(1, TS.N_VOCAB, 7)
    durs = (rng.integers(2, 6, (2, 10)) * (ids != 0)).astype(np.float32)
    mel = rng.normal(size=(2, jc.max_frames, jc.n_mels)).astype(np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(JS.tts_loss), static_argnums=1)(
        jp, jc, jnp.asarray(ids), jnp.asarray(mel), jnp.asarray(durs))
    tloss, tgrads = tt.value_and_grad(lambda p: TS.tts_loss(p, tc, ids, mel, durs), tp)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(jgrads, tgrads)


@pytest.mark.parametrize("model", ("asr", "w2v2"))
def test_speech_train_forwards_differentiate_as_jax(model):
    """The training twin carries the gradient JAX's autodiff gives; the
    serving forward of the same name still runs under ``inference_mode``."""
    rng = np.random.default_rng(2)
    if model == "asr":
        jc, tc = JS.asr_tiny(), TS.asr_tiny()
        shapes, gains = TS.asr_param_shapes(tc), TS._ASR_NORMS
        x = rng.normal(size=(1, 32, jc.n_mels)).astype(np.float32)
        jfwd, tfwd, serve = JS.asr_forward, TS.asr_train_forward, TS.asr_forward
    else:
        jc, tc = JS.wav2vec2_tiny(), TS.wav2vec2_tiny()
        shapes, gains = TS.w2v2_param_shapes(tc), ("gn_g", "fp_norm_g", "enc_norm_g", "ln1_g", "ln2_g")
        x = rng.normal(size=(1, 800)).astype(np.float32)
        jfwd, tfwd, serve = JS.w2v2_forward, TS.w2v2_train_forward, TS.w2v2_forward
    tree = _seeded(shapes, rng, gains)
    jp, tp = _jnp(tree), tw.speech_params_from_numpy(tree, shapes, "cpu")
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jfwd(p, jc, jnp.asarray(x)) ** 2)))(jp)
    tloss, tgrads = tt.value_and_grad(lambda p: (tfwd(p, tc, x) ** 2).mean(), tp)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(jgrads, tgrads)
    out = serve(tp, tc, x)
    assert out.is_inference() and not out.requires_grad
