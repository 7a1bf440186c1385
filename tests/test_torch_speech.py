"""The port's speech models (``models/speech.py``) against the JAX
package's, on the same numpy-seeded inputs and the JAX trees carried over
(``engine.weights.speech_params_from_numpy``): tiny conformer-CTC,
FastSpeech and wav2vec2 configs on the CPU.

Tolerances (f32): log-mel within 1e-5 of its largest value, ASR / TTS /
wav2vec2 outputs within 1e-5 relative to their largest value (measured:
1e-7 to 3e-7), durations and frame counts exact, greedy CTC transcripts
equal.  Griffin-Lim is a chaotic iteration from zero phase: the
reference itself moves by up to its output's size after 30 iterations when
its input moves by one ulp, so its waveform is held within 1e-5 (of the
peak) at 5 iterations, and at 30 within 8x the reference's own spread
under a one-ulp change of the input (measured 2.2-3.3x)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from generativeaiexamples_tpu.engine import weights as jweights
from generativeaiexamples_tpu.models import speech as J
from generativeaiexamples_tpu_torch.engine import weights as tweights
from generativeaiexamples_tpu_torch.models import speech as T

REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _carry(tree, shapes):
    return tweights.speech_params_from_numpy(jax.tree.map(np.asarray, tree), shapes, "cpu")


def _speech_wave(seed: int, seconds: float, silence: float = 0.0) -> np.ndarray:
    return cs.speech_wave(np, seed, seconds, silence)


@pytest.fixture(scope="module")
def asr():
    cfg = J.asr_tiny()
    jp = J.asr_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, T.asr_tiny(), _carry(jp, T.asr_param_shapes(T.asr_tiny()))


@pytest.fixture(scope="module")
def tts():
    cfg = J.tts_tiny()
    jp = J.tts_init_params(cfg, jax.random.PRNGKey(1))
    return cfg, jp, T.tts_tiny(), _carry(jp, T.tts_param_shapes(T.tts_tiny()))


@pytest.fixture(scope="module")
def w2v2():
    cfg = J.wav2vec2_tiny()
    jp = J.w2v2_init_params(cfg, jax.random.PRNGKey(2))
    return cfg, jp, T.wav2vec2_tiny(), _carry(jp, T.w2v2_param_shapes(T.wav2vec2_tiny()))


def test_vocabulary_and_filterbank():
    for text in ("Hello, World!", "it's 42 o'clock", ""):
        assert T.text_to_ids(text) == J.text_to_ids(text)
        assert T.ids_to_text(J.text_to_ids(text)) == J.ids_to_text(J.text_to_ids(text))
    assert T.ids_to_text([0, 5, 99, 28]) == J.ids_to_text([0, 5, 99, 28])
    for args in ((80, 400, 16_000), (16, 400, 16_000), (40, 512, 8_000)):
        assert np.array_equal(T.mel_filterbank(*args), J.mel_filterbank(*args))
    audio = np.ones(5000, np.float32)
    assert np.array_equal(T.pad_to_bucket(audio), J.pad_to_bucket(audio))
    assert T.N_VOCAB == J.N_VOCAB and T.W2V2_VOCAB == J.W2V2_VOCAB


@pytest.mark.parametrize("n", [8000, 300, 16_000])
def test_log_mel(n):
    pcm = (np.random.default_rng(n).normal(size=n) * 0.1).astype(np.float32)
    want = np.asarray(J.log_mel(jnp.asarray(pcm), 400, 160, 16))
    _close(T.log_mel(torch.from_numpy(pcm), 400, 160, 16), want)


def test_asr_forward_and_transcribe(asr):
    cfg, jp, tc, tp = asr
    mels = np.random.default_rng(0).normal(size=(2, 66, cfg.n_mels)).astype(np.float32)
    _close(T.asr_forward(tp, tc, mels), J.asr_forward(jp, cfg, jnp.asarray(mels)))
    pcm = _speech_wave(0, 0.5)
    assert T.transcribe(tp, tc, pcm) == J.transcribe(jp, cfg, pcm)
    _close(T.asr_logits(tp, tc, pcm), J.asr_forward(jp, cfg, J.log_mel(jnp.asarray(pcm), 400, 160, 16)[None])[0])
    logits = np.random.default_rng(1).normal(size=(40, T.N_VOCAB))
    assert T.ctc_greedy_decode(logits) == J.ctc_greedy_decode(logits)


def test_tts_forward_and_length_regulation(tts):
    cfg, jp, tc, tp = tts
    ids = np.asarray([J.text_to_ids("hello world") + [0, 0], J.text_to_ids("speech on a card")[:13]])
    want = J.tts_forward(jp, cfg, jnp.asarray(ids))
    got = T.tts_forward(tp, tc, ids)
    _close(got[0], want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2])
    durations = np.asarray([[3, 1, 0, 2], [1, 1, 1, 1]], np.float32)
    enc = np.random.default_rng(2).normal(size=(2, 4, 8)).astype(np.float32)
    assert np.array_equal(T.length_regulate(torch.from_numpy(enc), torch.from_numpy(durations), 10).numpy(),
                          np.asarray(J.length_regulate(jnp.asarray(enc), jnp.asarray(durations), 10)))
    forced = T.tts_forward(tp, tc, ids, durations=np.full(ids.shape, 2.0, np.float32))
    want_forced = J.tts_forward(jp, cfg, jnp.asarray(ids), jnp.full(ids.shape, 2.0))
    _close(forced[0], want_forced[0])
    assert np.array_equal(forced[1].numpy(), np.asarray(want_forced[1]))


def test_griffin_lim_and_synthesize(tts):
    cfg, jp, tc, tp = tts
    mag = np.abs(np.random.default_rng(3).normal(size=(40, 201))).astype(np.float32)
    edge = slice(240, -240)
    want5 = np.asarray(J.griffin_lim(jnp.asarray(mag), 400, 160, 5))
    _close(T.griffin_lim(torch.from_numpy(mag), 400, 160, 5)[edge], want5[edge])
    want = np.asarray(J.griffin_lim(jnp.asarray(mag), 400, 160))
    nudged = np.asarray(J.griffin_lim(jnp.asarray(np.nextafter(mag, np.float32(np.inf))), 400, 160))
    got = T.griffin_lim(torch.from_numpy(mag), 400, 160).numpy()
    spread = float(np.abs(nudged - want)[edge].max())
    assert float(np.abs(got - want)[edge].max()) <= 8 * spread
    # synthesize: the same frames, trim and peak scaling as the reference.
    for text in ("hello world", "", "!!!"):
        w_t, w_j = T.synthesize(tp, tc, text), J.synthesize(jp, cfg, text)
        assert w_t.shape == w_j.shape and w_t.dtype == np.float32
        assert np.abs(w_t).max() <= 0.7 + 1e-6
    assert np.array_equal(T.synthesize(tp, tc, ""), J.synthesize(jp, cfg, ""))


def test_wav2vec2_forward_and_transcribe(w2v2):
    cfg, jp, tc, tp = w2v2
    wave = np.random.default_rng(4).normal(size=(2, 4001)).astype(np.float32)
    _close(T.w2v2_forward(tp, tc, wave), J.w2v2_forward(jp, cfg, jnp.asarray(wave)))
    pcm = _speech_wave(1, 0.4)
    for pad in (False, True):
        assert T.w2v2_transcribe(tp, tc, pcm, pad=pad) == J.w2v2_transcribe(jp, cfg, pcm, pad=pad)
    logits = np.random.default_rng(5).normal(size=(30, 32))
    vocab = ["<pad>", "|", "A", "B"] + ["C"] * 28
    assert T.w2v2_decode(logits) == J.w2v2_decode(logits)
    assert T.w2v2_decode(logits, vocab) == J.w2v2_decode(logits, vocab)


def _events(session, chunks):
    out = [session.feed(c) for c in chunks]
    return out, session.finish(), session.transcript


def test_streaming_transcriber_events(asr, w2v2):
    cfg, jp, tc, tp = asr
    audio = np.concatenate([_speech_wave(2, 0.8, silence=1.4), _speech_wave(3, 0.6)])
    chunks = np.array_split(audio, 14)
    want = _events(J.StreamingTranscriber(jp, cfg), chunks)
    got = _events(T.StreamingTranscriber(tp, tc), chunks)
    assert got == want
    assert any(ev["is_final"] for evs in want[0] for ev in evs) and want[1]
    wc, wjp, wtc, wtp = w2v2
    assert (_events(T.StreamingTranscriber.wav2vec2(wtp, wtc), chunks)
            == _events(J.StreamingTranscriber.wav2vec2(wjp, wc), chunks))
    with pytest.raises(ValueError):
        T.StreamingTranscriber()
    silent = T.StreamingTranscriber(tp, tc)
    assert silent.feed(np.zeros(20_000, np.float32)) == [] and silent.finish() == []


def test_load_hf_wav2vec2_matches_reference(tmp_path):
    cfg = T.wav2vec2_tiny()
    cs.write_w2v2_checkpoint(torch, np, tmp_path, cfg, seed=7)
    tcfg = tweights.w2v2_config_from_hf(str(tmp_path))
    jcfg = jweights.w2v2_config_from_hf(str(tmp_path))
    assert (tcfg.d_model, tcfg.n_layers, tcfg.conv_dim, tcfg.pos_conv_kernel) == (
        jcfg.d_model, jcfg.n_layers, jcfg.conv_dim, jcfg.pos_conv_kernel)
    got = tweights.load_hf_wav2vec2(tcfg, str(tmp_path), device="cpu")
    want = jax.tree.map(np.asarray, jweights.load_hf_wav2vec2(jcfg, str(tmp_path)))
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], err_msg=str(path))
    wave = np.random.default_rng(6).normal(size=(1, 3000)).astype(np.float32)
    _close(T.w2v2_forward(got, tcfg, wave), J.w2v2_forward(jweights.load_hf_wav2vec2(jcfg, str(tmp_path)), jcfg,
                                                          jnp.asarray(wave)))
    assert json.load(open(tmp_path / "vocab.json"))["|"] == 4
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text(json.dumps({"model_type": "hubert"}))
    with pytest.raises(ValueError, match="not wav2vec2"):
        tweights.w2v2_config_from_hf(str(bad))
    (bad / "config.json").write_text(json.dumps({"do_stable_layer_norm": True}))
    with pytest.raises(ValueError, match="layer-norm"):
        tweights.w2v2_config_from_hf(str(bad))
    with pytest.raises(ValueError, match="geometry"):
        tweights.load_hf_wav2vec2(T.wav2vec2_tiny(n_layers=3), str(tmp_path), device="cpu")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tweights.load_hf_wav2vec2(T.wav2vec2_tiny(), "/nonexistent")
