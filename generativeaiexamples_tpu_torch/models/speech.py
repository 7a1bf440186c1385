"""Speech models in PyTorch (port of ``models/speech.py``): conformer-CTC
ASR, FastSpeech-style TTS with a Griffin-Lim vocoder, and wav2vec2-CTC.

* **Features** — log-mel: framing as a gather, a Hann window, ``rfft``,
  the mel filterbank as one product.
* **ASR** — 4x frame-stack subsampling, conformer blocks (half FFN,
  bidirectional attention, depthwise-conv module, half FFN), a CTC head;
  greedy CTC decoding; :class:`StreamingTranscriber` re-decodes an open
  utterance with energy endpointing.
* **TTS** — char encoder, duration predictor, length regulation, mel
  decoder, then Griffin-Lim (30 fixed iterations; the overlap-add is an
  ``index_add_`` over frames that do not overlap, in a fixed order);
  :func:`tts_loss`, the FastSpeech training objective.
* **wav2vec2** — the HF ``Wav2Vec2ForCTC`` group-norm variant: conv
  feature extractor, grouped positional convolution, post-LN encoder.

The serving forwards run under ``inference_mode``; each has a
``*_train_forward`` twin that carries gradients.  The models are f32.
Every product and convolution goes through ``ops.f32`` (IEEE f32 or
better on the card, never TF32, scoped to the call), so the process's
TF32 switches neither apply nor change.  Params
are plain dicts of tensors with the reference's leaf names and shapes
(``engine.weights.speech_params_from_numpy`` carries its trees across);
the functions run on the params' device and take numpy or tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops import f32

Params = Any

# Character vocabulary: CTC blank + space + letters + apostrophe.
CTC_BLANK = 0
VOCAB = [" "] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["'"]
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(VOCAB)}  # 0 reserved for blank
N_VOCAB = len(VOCAB) + 1

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def text_to_ids(text: str) -> list[int]:
    return [CHAR_TO_ID[c] for c in text.lower() if c in CHAR_TO_ID]


def ids_to_text(ids) -> str:
    return "".join(VOCAB[i - 1] for i in ids if 1 <= i <= len(VOCAB))


def _device_of(params: Params) -> torch.device:
    leaf = params
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return leaf.device


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# -- log-mel features -----------------------------------------------------------


def mel_filterbank(n_mels: int, n_fft: int, fs: int) -> np.ndarray:
    """Triangular mel filterbank (host-side, init time)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(0), hz_to_mel(fs / 2), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / fs).astype(int)
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            if c > lo:
                fb[k, m - 1] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[k, m - 1] = (hi - k) / (hi - c)
        if fb[:, m - 1].sum() == 0:
            # Degenerate (zero-width) triangle at low frequencies: give the
            # channel its center bin so no mel channel is dead.
            fb[min(c, n_fft // 2), m - 1] = 1.0
    return fb


def _hanning(n: int, device) -> torch.Tensor:
    """The symmetric Hann window (``np.hanning``) in f32."""
    return torch.as_tensor(np.hanning(n).astype(np.float32), device=device)


def _frame_index(n_frames: int, n_fft: int, hop: int, length: int, device) -> torch.Tensor:
    idx = torch.arange(n_frames, device=device)[:, None] * hop + torch.arange(n_fft, device=device)[None, :]
    return idx.clamp(0, length - 1)


def log_mel(pcm: torch.Tensor, n_fft: int, hop: int, n_mels: int) -> torch.Tensor:
    """f32 waveform (t,) -> (frames, n_mels) log-mel features."""
    n_frames = max((pcm.shape[0] - n_fft) // hop + 1, 1)
    frames = pcm[_frame_index(n_frames, n_fft, hop, pcm.shape[0], pcm.device)]
    spec = torch.fft.rfft(frames * _hanning(n_fft, pcm.device), dim=-1).abs() ** 2
    fb = torch.as_tensor(mel_filterbank(n_mels, n_fft, 16_000), device=pcm.device)
    return torch.log(f32.matmul(spec, fb) + 1e-6)


# -- shared pieces -------------------------------------------------------------


def _init_tree(shapes, generator: torch.Generator, device, dtype, ones=(), zeros=()):
    """0.02-std normal leaves drawn in f32 from ``generator`` (in the
    tree's order), then the named gains set to 1 and biases to 0."""

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        w = (torch.randn(node, generator=generator, dtype=torch.float32, device=device) * 0.02).to(dtype)
        if name in ones:
            return torch.ones_like(w)
        if name in zeros:
            return torch.zeros_like(w)
        return w

    return walk(shapes)


def _ln(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g


def _lnb(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return _ln(x, g, eps) + b


def _mha(q, k, v, n_heads: int, head_dim: int, scale: bool = True) -> torch.Tensor:
    """Bidirectional multi-head attention over (b, n, d) projections:
    softmax(q k^T / sqrt(head_dim)) v, (b, n, heads * head_dim).
    ``scale=False`` takes q already scaled (wav2vec2)."""
    b, n, _ = q.shape
    q, k, v = (t.reshape(b, n, n_heads, head_dim) for t in (q, k, v))
    scores = f32.einsum("bqhd,bkhd->bhqk", q, k)
    if scale:
        scores = scores / math.sqrt(head_dim)
    return f32.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v).reshape(b, n, n_heads * head_dim)


# -- conformer ASR ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    n_mels: int = 80
    d_model: int = 256
    n_layers: int = 12
    n_heads: int = 4
    d_ff: int = 1024
    conv_kernel: int = 15
    vocab_size: int = N_VOCAB
    max_frames: int = 2048
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def conformer_s(**overrides) -> ASRConfig:
    """Conformer-S geometry."""
    return dataclasses.replace(ASRConfig(), **overrides)


def asr_tiny(**overrides) -> ASRConfig:
    return dataclasses.replace(
        ASRConfig(n_mels=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, conv_kernel=7, max_frames=256), **overrides
    )


_ASR_NORMS = ("ffn1_norm", "attn_norm", "conv_norm", "ffn2_norm", "final_norm", "out_norm")


def asr_param_shapes(cfg: ASRConfig) -> dict:
    L, D, F_, K = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.conv_kernel
    HD = cfg.n_heads * cfg.head_dim
    return {
        "sub_w1": (cfg.n_mels * 4, D),
        "sub_b1": (D,),
        "pos_embed": (cfg.max_frames, D),
        "layers": {
            "ffn1_norm": (L, D), "ffn1_up": (L, D, F_), "ffn1_down": (L, F_, D), "attn_norm": (L, D),
            "wq": (L, D, HD), "wk": (L, D, HD), "wv": (L, D, HD), "wo": (L, HD, D), "conv_norm": (L, D),
            "conv_in": (L, D, 2 * D), "conv_dw": (L, K, D), "conv_out": (L, D, D), "ffn2_norm": (L, D),
            "ffn2_up": (L, D, F_), "ffn2_down": (L, F_, D), "final_norm": (L, D),
        },
        "out_norm": (D,),
        "ctc_head": (D, cfg.vocab_size),
    }


def asr_init_params(cfg: ASRConfig, generator: torch.Generator, device) -> Params:
    return _init_tree(asr_param_shapes(cfg), generator, device, cfg.compute_dtype, ones=_ASR_NORMS)


@torch.inference_mode()
def asr_forward(params: Params, cfg: ASRConfig, mels) -> torch.Tensor:
    """(b, t, n_mels) log-mel -> (b, t // 4, vocab) CTC logits (serving:
    under ``inference_mode``; :func:`asr_train_forward` carries gradients)."""
    return asr_train_forward(params, cfg, mels)


def asr_train_forward(params: Params, cfg: ASRConfig, mels) -> torch.Tensor:
    """:func:`asr_forward` with autograd as the caller's mode leaves it."""
    mels = _as_f32(mels, _device_of(params)).to(cfg.compute_dtype)
    b, t, _ = mels.shape
    t4 = (t // 4) * 4
    stacked = mels[:, :t4].reshape(b, t4 // 4, cfg.n_mels * 4)
    x = F.silu(f32.matmul(stacked, params["sub_w1"]) + params["sub_b1"])
    n = x.shape[1]
    x = x + params["pos_embed"][:n][None]
    eps, K, D = cfg.norm_eps, cfg.conv_kernel, cfg.d_model
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        h = _ln(x, lp["ffn1_norm"], eps)
        x = x + 0.5 * f32.matmul(F.silu(f32.matmul(h, lp["ffn1_up"])), lp["ffn1_down"])
        h = _ln(x, lp["attn_norm"], eps)
        q, k, v = (f32.matmul(h, lp[w]) for w in ("wq", "wk", "wv"))
        x = x + f32.matmul(_mha(q, k, v, cfg.n_heads, cfg.head_dim), lp["wo"])
        # Convolution module: pointwise GLU -> depthwise conv -> pointwise.
        h = _ln(x, lp["conv_norm"], eps)
        gates = f32.matmul(h, lp["conv_in"])
        h = gates[..., :D] * torch.sigmoid(gates[..., D:])
        hp = F.pad(h, (0, 0, K // 2, K // 2))
        # Depthwise conv as a shift-and-scale sum, in the reference's order.
        dw = hp[:, 0:n] * lp["conv_dw"][0][None, None, :]
        for j in range(1, K):
            dw = dw + hp[:, j : j + n] * lp["conv_dw"][j][None, None, :]
        x = x + f32.matmul(F.silu(dw), lp["conv_out"])
        h = _ln(x, lp["ffn2_norm"], eps)
        x = x + 0.5 * f32.matmul(F.silu(f32.matmul(h, lp["ffn2_up"])), lp["ffn2_down"])
        x = _ln(x, lp["final_norm"], eps)
    x = _ln(x, params["out_norm"], eps)
    return f32.matmul(x, params["ctc_head"])


def ctc_greedy_decode(logits) -> str:
    """Collapse repeats then drop blanks (standard CTC best-path)."""
    ids = np.asarray(logits.cpu() if isinstance(logits, torch.Tensor) else logits).argmax(-1)
    out = []
    prev = -1
    for i in ids:
        if i != prev and i != CTC_BLANK:
            out.append(int(i))
        prev = i
    return ids_to_text(out)


def pad_to_bucket(audio: np.ndarray, base: int = 4096) -> np.ndarray:
    """Zero-pad a waveform to the next power-of-two sample bucket (the one
    rule the streaming session and the service share)."""
    n = base
    while n < len(audio):
        n *= 2
    padded = np.zeros(n, np.float32)
    padded[: len(audio)] = audio
    return padded


def asr_logits(params: Params, cfg: ASRConfig, pcm) -> torch.Tensor:
    """f32 waveform @16 kHz -> (t // 4, vocab) CTC logits."""
    with torch.inference_mode():
        feats = log_mel(_as_f32(pcm, _device_of(params)), 400, 160, cfg.n_mels)
        return asr_forward(params, cfg, feats[None])[0]


def transcribe(params: Params, cfg: ASRConfig, pcm) -> str:
    """f32 waveform @16 kHz -> text (greedy CTC)."""
    return ctc_greedy_decode(asr_logits(params, cfg, pcm))


class StreamingTranscriber:
    """Incremental ASR session: PCM chunks in, partial / final transcripts
    out (the reference's, line for line).

    While an utterance is open, each update re-decodes its buffer (padded
    to a power-of-two sample bucket) and emits an interim result
    (``is_final=False``); energy endpointing (trailing silence, or a length
    cap) closes it with a final result and resets the buffer.  The
    acoustic model is ``decode_fn`` (waveform -> text), by default the
    conformer's :func:`transcribe`; :meth:`wav2vec2` builds one around a
    wav2vec2-CTC model.
    """

    def __init__(
        self,
        params: Params = None,
        cfg: Optional[ASRConfig] = None,
        *,
        sample_rate: int = 16_000,
        update_seconds: float = 0.5,
        silence_seconds: float = 0.6,
        energy_threshold: float = 5e-3,
        max_utterance_seconds: float = 12.0,
        decode_fn: Optional[Callable[[np.ndarray], str]] = None,
        pad_input: bool = True,
    ) -> None:
        if decode_fn is None and (params is None or cfg is None):
            raise ValueError("need either decode_fn or (params, cfg)")
        self.decode_fn = decode_fn or (lambda audio: transcribe(params, cfg, audio))
        # False = decode_fn owns bucketing (wav2vec2 pads after its
        # utterance normalization; see w2v2_transcribe).
        self.pad_input = pad_input
        self.params = params
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.update_samples = max(int(update_seconds * sample_rate), 1600)
        self.silence_samples = int(silence_seconds * sample_rate)
        self.energy_threshold = energy_threshold
        self.max_samples = int(max_utterance_seconds * sample_rate)
        self._audio = np.zeros(0, np.float32)
        self._since_decode = 0
        self._finals: list[str] = []
        self._partial = ""

    @property
    def transcript(self) -> str:
        """Finalized segments plus the open partial."""
        parts = [t for t in self._finals if t]
        if self._partial:
            parts.append(self._partial)
        return " ".join(parts)

    @classmethod
    def wav2vec2(cls, params: Params, cfg: "Wav2Vec2Config", vocab=None, **kwargs) -> "StreamingTranscriber":
        """A session over a wav2vec2-CTC model; ``vocab`` overrides the
        decode table (custom-vocab fine-tunes)."""
        return cls(decode_fn=lambda audio: w2v2_transcribe(params, cfg, audio, vocab, pad=True), pad_input=False,
                   **kwargs)

    def _decode(self, audio: np.ndarray) -> str:
        if not len(audio):
            return ""
        return self.decode_fn(pad_to_bucket(audio) if self.pad_input else audio)

    def _endpoint(self) -> bool:
        """True when the open utterance should close: it contains speech
        and its tail has gone quiet, or it hit the length cap."""
        if len(self._audio) >= self.max_samples:
            return True
        if len(self._audio) < 2 * self.silence_samples:
            return False
        tail = self._audio[-self.silence_samples :]
        head = self._audio[: -self.silence_samples]
        tail_rms = float(np.sqrt(np.mean(tail**2)))
        head_peak = float(np.sqrt((head**2).max())) if len(head) else 0.0
        return tail_rms < self.energy_threshold and head_peak >= self.energy_threshold

    def feed(self, pcm: np.ndarray) -> list[dict]:
        """Append a PCM chunk (f32 in [-1, 1] at ``sample_rate``); returns
        the events it triggered: ``{"is_final": bool, "text": str}``."""
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        self._audio = np.concatenate([self._audio, pcm])
        self._since_decode += len(pcm)
        events: list[dict] = []
        if self._since_decode < self.update_samples:
            return events
        self._since_decode = 0
        peak = float(np.sqrt((self._audio**2).max())) if len(self._audio) else 0.0
        if peak < self.energy_threshold:
            # Silence so far: no interim results, and the buffer keeps only
            # the endpointing tail.
            self._audio = self._audio[-self.silence_samples :]
            self._partial = ""
            return events
        if self._endpoint():
            text = self._decode(self._audio)
            self._finals.append(text)
            self._partial = ""
            self._audio = np.zeros(0, np.float32)
            events.append({"is_final": True, "text": text})
        else:
            self._partial = self._decode(self._audio)
            events.append({"is_final": False, "text": self._partial})
        return events

    def finish(self) -> list[dict]:
        """End of stream: finalize whatever is still buffered (silence-only
        residue produces no event)."""
        events: list[dict] = []
        peak = float(np.sqrt((self._audio**2).max())) if len(self._audio) else 0.0
        if len(self._audio) and peak >= self.energy_threshold:
            text = self._decode(self._audio)
            self._finals.append(text)
            self._partial = ""
            self._audio = np.zeros(0, np.float32)
            events.append({"is_final": True, "text": text})
        return events


# -- FastSpeech-style TTS -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    vocab_size: int = N_VOCAB
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    n_mels: int = 80
    max_text: int = 512
    max_frames: int = 2048
    fs: int = 16_000
    n_fft: int = 400
    hop: int = 160
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def fastspeech_s(**overrides) -> TTSConfig:
    return dataclasses.replace(TTSConfig(), **overrides)


def tts_tiny(**overrides) -> TTSConfig:
    return dataclasses.replace(
        TTSConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, n_mels=16, max_text=64, max_frames=256), **overrides
    )


def _transformer_shapes(L, D, HD, F_) -> dict:
    return {"attn_norm": (L, D), "wq": (L, D, HD), "wk": (L, D, HD), "wv": (L, D, HD), "wo": (L, HD, D),
            "mlp_norm": (L, D), "w_up": (L, D, F_), "w_down": (L, F_, D)}


def tts_param_shapes(cfg: TTSConfig) -> dict:
    D, HD, L = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_layers
    return {
        "char_embed": (cfg.vocab_size, D),
        "enc_pos": (cfg.max_text, D),
        "encoder": _transformer_shapes(L, D, HD, cfg.d_ff),
        "dur_w1": (D, D),
        "dur_w2": (D, 1),
        "dec_pos": (cfg.max_frames, D),
        "decoder": _transformer_shapes(L, D, HD, cfg.d_ff),
        "mel_head": (D, cfg.n_mels),
        "mel_head_b": (cfg.n_mels,),
    }


def tts_init_params(cfg: TTSConfig, generator: torch.Generator, device) -> Params:
    return _init_tree(tts_param_shapes(cfg), generator, device, cfg.compute_dtype, ones=("attn_norm", "mlp_norm"))


def _transformer(x: torch.Tensor, layers: dict, cfg, n_heads: int, head_dim: int) -> torch.Tensor:
    for i in range(layers["wq"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        h = _ln(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = (f32.matmul(h, lp[w]) for w in ("wq", "wk", "wv"))
        x = x + f32.matmul(_mha(q, k, v, n_heads, head_dim), lp["wo"])
        h = _ln(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + f32.matmul(F.silu(f32.matmul(h, lp["w_up"])), lp["w_down"])
    return x


def length_regulate(enc: torch.Tensor, durations: torch.Tensor, max_frames: int) -> torch.Tensor:
    """Repeat each text position by its duration: output frame f takes the
    position whose cumulative-duration interval holds f (a gather of a
    static ``max_frames`` length)."""
    ends = torch.cumsum(durations, dim=-1)  # (b, n)
    frame_idx = torch.arange(max_frames, device=enc.device)[None, :, None]
    src = (frame_idx >= ends[:, None, :]).sum(-1).clamp(0, enc.shape[1] - 1)  # (b, F)
    return torch.take_along_dim(enc, src[..., None], dim=1)


@torch.inference_mode()
def tts_forward(params: Params, cfg: TTSConfig, text_ids, durations=None):
    """(b, n) char ids -> ((b, max_frames, n_mels) mel, (b,) frame counts,
    (b, n) predicted durations).  ``durations`` (b, n) teacher-forces the
    length regulation; without it the predictor's durations, rounded to
    whole frames, drive it.  Serving, under ``inference_mode``;
    :func:`tts_train_forward` carries gradients."""
    return tts_train_forward(params, cfg, text_ids, durations)


def tts_train_forward(params: Params, cfg: TTSConfig, text_ids, durations=None):
    """:func:`tts_forward` with autograd as the caller's mode leaves it."""
    dev = _device_of(params)
    text_ids = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
    n = text_ids.shape[1]
    x = params["char_embed"][text_ids] + params["enc_pos"][:n][None]
    enc = _transformer(x, params["encoder"], cfg, cfg.n_heads, cfg.head_dim)
    live = (text_ids != 0).to(enc.dtype)
    dur_pred = (F.softplus(f32.matmul(F.silu(f32.matmul(enc, params["dur_w1"])), params["dur_w2"]))[..., 0]
                + 1.0) * live  # >= 1 frame per char, padding chars none
    dur = torch.round(dur_pred) * live if durations is None else _as_f32(durations, dev) * live
    frames = length_regulate(enc, dur, cfg.max_frames) + params["dec_pos"][: cfg.max_frames][None]
    dec = _transformer(frames, params["decoder"], cfg, cfg.n_heads, cfg.head_dim)
    n_frames = torch.round(dur.sum(-1)).to(torch.int32).clamp(1, cfg.max_frames)
    mel = f32.matmul(dec, params["mel_head"]) + params["mel_head_b"]
    return mel, n_frames, dur_pred


def tts_loss(params: Params, cfg: TTSConfig, text_ids, mel_target, durations) -> torch.Tensor:
    """FastSpeech training objective: teacher-forced mel MSE over the valid
    frames plus 0.1 x the duration MSE over the real characters
    (durations in frames per character; ``mel_target`` (b, max_frames,
    n_mels))."""
    mel, _, dur_pred = tts_train_forward(params, cfg, text_ids, durations)
    dev = mel.device
    durations = _as_f32(durations, dev)
    text_ids = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
    frame_idx = torch.arange(cfg.max_frames, device=dev)[None, :]
    mask = (frame_idx < durations.sum(-1, keepdim=True))[..., None]
    n_valid = torch.clamp(mask.sum(), min=1)
    mel_l = (((mel - _as_f32(mel_target, dev)) ** 2) * mask).sum() / (n_valid * cfg.n_mels)
    char_mask = text_ids != 0
    dur_l = (((dur_pred - durations) * char_mask) ** 2).sum() / torch.clamp(char_mask.sum(), min=1)
    return mel_l + 0.1 * dur_l


def overlap_add(frames: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """Sum (n_frames, n_fft) frames placed ``hop`` apart into ``length``
    samples: one ``index_add_`` per set of frames that do not overlap
    (frames ``g, g + G, ...`` for ``G = ceil(n_fft / hop)``), so each sample
    takes its terms in one fixed order on every device (atomics never
    race)."""
    n_frames, n_fft = frames.shape
    out = torch.zeros(length, dtype=frames.dtype, device=frames.device)
    groups = -(-n_fft // hop)
    cols = torch.arange(n_fft, device=frames.device)
    for g in range(min(groups, n_frames)):
        rows = torch.arange(g, n_frames, groups, device=frames.device)
        out.index_add_(0, (rows[:, None] * hop + cols[None, :]).reshape(-1), frames[rows].reshape(-1))
    return out


def griffin_lim(mag: torch.Tensor, n_fft: int, hop: int, n_iter: int = 30) -> torch.Tensor:
    """Phase recovery from a linear magnitude spectrogram (frames, bins):
    ``n_iter`` fixed iterations of ISTFT then STFT."""
    window = _hanning(n_fft, mag.device)
    n_frames = mag.shape[0]
    length = hop * (n_frames - 1) + n_fft
    norm = overlap_add((window**2).expand(n_frames, n_fft), hop, length).clamp_min(1e-8)
    idx = _frame_index(n_frames, n_fft, hop, length, mag.device)

    def istft(spec):
        return overlap_add(torch.fft.irfft(spec, n=n_fft, dim=-1) * window, hop, length) / norm

    phase = torch.zeros_like(mag)
    for _ in range(n_iter):
        wave = istft(torch.polar(mag, phase))
        phase = torch.angle(torch.fft.rfft(wave[idx] * window, dim=-1))
    return istft(torch.polar(mag, phase))


def synthesize(params: Params, cfg: TTSConfig, text: str, *, mel_to_linear: Optional[np.ndarray] = None) -> np.ndarray:
    """Text -> f32 waveform at ``cfg.fs``: mel -> linear magnitude ->
    Griffin-Lim, the ISTFT edges trimmed, the peak scaled to 0.7."""
    ids = text_to_ids(text)[: cfg.max_text]
    if not ids:
        return np.zeros(cfg.hop, np.float32)
    with torch.inference_mode():
        mel, n_frames, _ = tts_forward(params, cfg, [ids])
        n = int(n_frames[0])
        if mel_to_linear is None:
            fb = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.fs)
            mel_to_linear = np.linalg.pinv(fb.T).astype(np.float32)
        # log_mel is log power; Griffin-Lim wants the magnitude.
        m2l = torch.as_tensor(np.ascontiguousarray(mel_to_linear.T), device=mel.device)
        linear = torch.sqrt(torch.clamp(f32.matmul(torch.exp(mel[0, :n]), m2l), min=0.0))
        wave = griffin_lim(linear, cfg.n_fft, cfg.hop)
        # Trim the ISTFT edges, where the window sum is near zero and the
        # division spikes far above the signal.
        edge = cfg.n_fft - cfg.hop
        if wave.shape[0] > 2 * edge:
            wave = wave[edge:-edge]
        peak = wave.abs().max()
        return (wave / torch.clamp(peak, min=1e-6) * 0.7).cpu().numpy().astype(np.float32)


# -- wav2vec2-CTC ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 32  # wav2vec2-base-960h char vocab
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def wav2vec2_base(**overrides) -> Wav2Vec2Config:
    """facebook/wav2vec2-base-960h geometry (group-norm feature extractor,
    post-LN encoder)."""
    return dataclasses.replace(Wav2Vec2Config(), **overrides)


def wav2vec2_tiny(**overrides) -> Wav2Vec2Config:
    """Tiny geometry for CPU tests (2 conv + 2 encoder layers)."""
    return dataclasses.replace(
        Wav2Vec2Config(d_model=32, n_layers=2, n_heads=2, d_ff=64, conv_dim=(32, 32), conv_kernel=(10, 3),
                       conv_stride=(5, 2), pos_conv_kernel=16, pos_conv_groups=2),
        **overrides,
    )


# wav2vec2-base-960h tokenizer vocab (vocab.json order): blank is <pad>=0,
# "|" is the word separator.
W2V2_VOCAB = [
    "<pad>", "<s>", "</s>", "<unk>", "|",
    "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U",
    "M", "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X",
    "J", "Q", "Z",
]


def w2v2_param_shapes(cfg: Wav2Vec2Config) -> dict:
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    HD = cfg.n_heads * cfg.head_dim
    convs = []
    c_in = 1
    for i, (c_out, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        leaf = {"w": (k, c_in, c_out)}
        if i == 0:  # group norm (groups == channels) on the first layer
            leaf["gn_g"] = (c_out,)
            leaf["gn_b"] = (c_out,)
        convs.append(leaf)
        c_in = c_out
    return {
        "conv_layers": convs,
        "fp_norm_g": (c_in,),
        "fp_norm_b": (c_in,),
        "fp_w": (c_in, D),
        "fp_b": (D,),
        "pos_conv_w": (cfg.pos_conv_kernel, D // cfg.pos_conv_groups, D),
        "pos_conv_b": (D,),
        "enc_norm_g": (D,),
        "enc_norm_b": (D,),
        "layers": {
            "wq": (L, D, HD), "bq": (L, HD), "wk": (L, D, HD), "bk": (L, HD), "wv": (L, D, HD), "bv": (L, HD),
            "wo": (L, HD, D), "bo": (L, D), "ln1_g": (L, D), "ln1_b": (L, D), "ff_in_w": (L, D, F_),
            "ff_in_b": (L, F_), "ff_out_w": (L, F_, D), "ff_out_b": (L, D), "ln2_g": (L, D), "ln2_b": (L, D),
        },
        "lm_head_w": (D, cfg.vocab_size),
        "lm_head_b": (cfg.vocab_size,),
    }


def w2v2_init_params(cfg: Wav2Vec2Config, generator: torch.Generator, device) -> Params:
    return _init_tree(w2v2_param_shapes(cfg), generator, device, cfg.compute_dtype,
                      ones=("gn_g", "fp_norm_g", "enc_norm_g", "ln1_g", "ln2_g"),
                      zeros=("gn_b", "fp_norm_b", "enc_norm_b", "ln1_b", "ln2_b"))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf)


@torch.inference_mode()
def w2v2_forward(params: Params, cfg: Wav2Vec2Config, wave) -> torch.Tensor:
    """(b, t) normalized waveform @16 kHz -> (b, frames, vocab) CTC logits,
    ``transformers.Wav2Vec2ForCTC`` (group-norm variant) op for op; the
    caller normalizes the utterance (:func:`w2v2_transcribe`).  Serving,
    under ``inference_mode``; :func:`w2v2_train_forward` carries
    gradients."""
    return w2v2_train_forward(params, cfg, wave)


def w2v2_train_forward(params: Params, cfg: Wav2Vec2Config, wave) -> torch.Tensor:
    """:func:`w2v2_forward` with autograd as the caller's mode leaves it."""
    x = _as_f32(wave, _device_of(params)).to(cfg.compute_dtype)[:, None, :]  # (b, 1, t)
    eps = cfg.norm_eps
    for conv, stride in zip(params["conv_layers"], cfg.conv_stride):
        x = f32.conv1d(x, conv["w"].permute(2, 1, 0), stride=stride)
        if "gn_g" in conv:
            # GroupNorm with groups == channels: per-channel stats over time.
            mu = x.mean(dim=2, keepdim=True)
            var = ((x - mu) ** 2).mean(dim=2, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + eps)
            x = x * conv["gn_g"][:, None] + conv["gn_b"][:, None]
        x = _gelu(x)
    x = _lnb(x.transpose(1, 2), params["fp_norm_g"], params["fp_norm_b"], eps)
    x = f32.matmul(x, params["fp_w"]) + params["fp_b"]
    # Positional conv embedding: grouped, padded by k // 2 each side, the
    # trailing frame dropped for even kernels (Wav2Vec2SamePadLayer).
    pos = f32.conv1d(x.transpose(1, 2), params["pos_conv_w"].permute(2, 1, 0), params["pos_conv_b"],
                     padding=cfg.pos_conv_kernel // 2, groups=cfg.pos_conv_groups).transpose(1, 2)
    if cfg.pos_conv_kernel % 2 == 0:
        pos = pos[:, :-1]
    x = _lnb(x + _gelu(pos), params["enc_norm_g"], params["enc_norm_b"], eps)
    scale = cfg.head_dim**-0.5
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        q = (f32.matmul(x, lp["wq"]) + lp["bq"]) * scale
        k, v = (f32.matmul(x, lp[w]) + lp[b] for w, b in (("wk", "bk"), ("wv", "bv")))
        ctx = _mha(q, k, v, cfg.n_heads, cfg.head_dim, scale=False)
        x = _lnb(x + f32.matmul(ctx, lp["wo"]) + lp["bo"], lp["ln1_g"], lp["ln1_b"], eps)
        ff = f32.matmul(_gelu(f32.matmul(x, lp["ff_in_w"]) + lp["ff_in_b"]), lp["ff_out_w"]) + lp["ff_out_b"]
        x = _lnb(x + ff, lp["ln2_g"], lp["ln2_b"], eps)
    return f32.matmul(x, params["lm_head_w"]) + params["lm_head_b"]


def w2v2_decode(logits, vocab=None) -> str:
    """Greedy CTC best-path with the wav2vec2 character vocabulary."""
    vocab = vocab or W2V2_VOCAB
    ids = np.asarray(logits.cpu() if isinstance(logits, torch.Tensor) else logits).argmax(-1)
    out = []
    prev = -1
    for i in ids:
        if i != prev and i != 0:  # 0 = <pad> doubles as the CTC blank
            tok = vocab[int(i)] if int(i) < len(vocab) else ""
            if tok == "|":
                out.append(" ")
            elif not (tok.startswith("<") and tok.endswith(">")):
                out.append(tok)
        prev = i
    return "".join(out).strip()


def w2v2_normalize(pcm, *, pad: bool = False) -> np.ndarray:
    """The HF processor's zero-mean / unit-variance utterance
    normalization, then (``pad``) the power-of-two sample bucket."""
    wave = np.asarray(pcm, np.float32)
    wave = (wave - wave.mean()) / np.sqrt(wave.var() + 1e-7)
    return pad_to_bucket(wave) if pad else wave


def w2v2_transcribe(params: Params, cfg: Wav2Vec2Config, pcm, vocab=None, *, pad: bool = False) -> str:
    """f32 waveform @16 kHz -> text: the utterance normalized on its own
    stats, then (``pad``) bucketed, then greedy CTC."""
    return w2v2_decode(w2v2_forward(params, cfg, w2v2_normalize(pcm, pad=pad)[None])[0], vocab)
