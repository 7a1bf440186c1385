"""DSP for the FM SDR pipeline in PyTorch, on an explicit device (port of
``streaming/dsp.py``).

The reference's chain (low-pass FIR, quadrature FM demodulation, an
anti-aliased rational resampler, float -> int16 PCM) with its arithmetic:

* **FIR** — an FIR ``lfilter`` with taps ``b`` is ``convolve([tail, x],
  b)`` cut to the block: one ``conv1d`` over the block and the carried
  tail, through ``ops.f32`` (on the card f64 products rounded once to f32,
  never TF32; no process-wide flag is read or set).  Complex blocks are
  filtered as their real and imaginary parts.
* **Demodulation** — the angle of each sample times the conjugate of the
  one before it, over pi.
* **Resampling** — the anti-alias FIR, then a linear-interpolated gather
  at ``arange(n_out) * (down / up)``, the position and its integer cut in
  f32 as the reference computes them (a cut that moves moves whole
  samples).
* **PCM** — clip to [-1, 1], times 32767, truncated toward zero.

Streaming state (the FIR tails, the demodulator's last sample) stays on
the device between blocks; :class:`FMReceiverChain` copies to the host
once a block, its PCM.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.ops import f32


def firwin_lowpass(num_taps: int, cutoff: float, fs: float) -> np.ndarray:
    """Windowed-sinc (Hamming) low-pass FIR design, host-side (the
    reference's, bit for bit)."""
    if not 0 < cutoff < fs / 2:
        raise ValueError(f"cutoff {cutoff} outside (0, fs/2)")
    n = np.arange(num_taps)
    m = n - (num_taps - 1) / 2
    fc = cutoff / (fs / 2)  # normalized to Nyquist
    h = np.sinc(fc * m) * fc
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def _fir_block(x: torch.Tensor, taps: torch.Tensor, tail: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter one real block with its carried tail: ``y[n] = sum_k taps[k]
    * ext[n + len(tail) - k]`` over ``ext = [tail, x]``, so block boundaries
    are seamless; returns ``(y, new_tail)``."""
    ext = torch.cat([tail, x])
    # conv1d correlates: flipping the taps makes it the convolution.
    y = f32.conv1d(ext[None, None], taps.flip(0)[None, None])[0, 0]
    return y, ext[ext.shape[0] - tail.shape[0]:]


class LowPassFilter:
    """Streaming FIR low-pass (complex or real blocks) on ``device``."""

    def __init__(self, cutoff: float, fs: float, num_taps: int = 101, device=None) -> None:
        self.device = resolve_device(device)
        self.taps = torch.as_tensor(firwin_lowpass(num_taps, cutoff, fs), device=self.device)
        self._tail: Optional[torch.Tensor] = None

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        if self._tail is None or self._tail.dtype != block.dtype:
            self._tail = torch.zeros(self.taps.shape[0] - 1, dtype=block.dtype, device=block.device)
        if block.is_complex():
            yr, tr = _fir_block(block.real, self.taps, self._tail.real)
            yi, ti = _fir_block(block.imag, self.taps, self._tail.imag)
            self._tail = torch.complex(tr, ti)
            return torch.complex(yr, yi)
        y, self._tail = _fir_block(block, self.taps, self._tail)
        return y


def fm_demodulate(iq: torch.Tensor, last: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadrature FM demod of a complex64 block: ``angle(x[n] * conj(x[n -
    1])) / pi`` with ``last`` the previous block's final sample.  Returns
    (f32 audio, the new last sample)."""
    ext = torch.cat([last.reshape(1), iq])
    phase = torch.angle(ext[1:] * torch.conj(ext[:-1]))
    # A tensor divisor: CUDA turns a division by a Python scalar into a
    # product by its reciprocal.
    return phase / torch.full((), math.pi, dtype=phase.dtype, device=phase.device), iq[-1]


class FMDemodulator:
    def __init__(self, device=None) -> None:
        self._last = torch.zeros((), dtype=torch.complex64, device=resolve_device(device))

    def __call__(self, iq: torch.Tensor) -> torch.Tensor:
        audio, self._last = fm_demodulate(iq.to(torch.complex64), self._last)
        return audio


def _resample_block(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Rational resample of a filtered block: a linear-interpolated gather
    on the up/down grid (``n * up // down`` samples)."""
    n = x.shape[0]
    n_out = (n * up) // down
    pos = torch.arange(n_out, dtype=torch.float32, device=x.device) * (down / up)
    i0 = pos.to(torch.int32).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(0, n - 1)
    frac = pos - i0
    return x[i0] * (1 - frac) + x[i1] * frac


class Resampler:
    """Anti-aliased rational resampler fs_in -> fs_out."""

    def __init__(self, fs_in: int, fs_out: int, num_taps: int = 101, device=None) -> None:
        g = math.gcd(fs_in, fs_out)
        self.up, self.down = fs_out // g, fs_in // g
        self.fs_in, self.fs_out = fs_in, fs_out
        self._aa = (LowPassFilter(cutoff=0.45 * fs_out, fs=fs_in, num_taps=num_taps, device=device)
                    if fs_out < fs_in else None)

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        if self._aa is not None:
            block = self._aa(block)
        return _resample_block(block, self.up, self.down)


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> int16 PCM: clip, times 32767, truncate toward zero."""
    return (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)


@dataclasses.dataclass
class FMReceiverConfig:
    """End-to-end chain geometry (the reference app's defaults: broadcast
    FM at 250 kHz baseband down to 16 kHz ASR audio).  ``baseband_cutoff_hz``
    is the pre-demod channel filter; the audio band is set by the
    resampler's anti-alias filter."""

    fs_baseband: int = 250_000
    baseband_cutoff_hz: float = 100_000.0
    fs_audio: int = 16_000
    num_taps: int = 101


class FMReceiverChain:
    """lowpass -> demodulate -> resample -> pcm, one call per I/Q block, on
    ``device`` (the card by default)."""

    def __init__(self, cfg: FMReceiverConfig = FMReceiverConfig(), device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lowpass = LowPassFilter(cutoff=cfg.baseband_cutoff_hz, fs=cfg.fs_baseband, num_taps=cfg.num_taps,
                                     device=self.device)
        self.demod = FMDemodulator(self.device)
        self.resample = Resampler(cfg.fs_baseband, cfg.fs_audio, cfg.num_taps, device=self.device)

    def __call__(self, iq_block) -> np.ndarray:
        """I/Q complex block (numpy or a tensor) -> int16 PCM at fs_audio."""
        x = torch.as_tensor(np.asarray(iq_block, np.complex64) if not isinstance(iq_block, torch.Tensor)
                            else iq_block, device=self.device).to(torch.complex64)
        pcm = to_pcm16(self.resample(self.demod(self.lowpass(x))))
        return pcm.cpu().numpy()
