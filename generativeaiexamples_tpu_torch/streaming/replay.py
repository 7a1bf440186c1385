"""File-replay harness: feed recorded audio/I-Q over UDP (port of
``streaming/replay.py``; numpy and sockets only).

Parity target: ``fm-asr-streaming-rag/file-replay/wav_replay.py`` — the
reference's "fake radio": read a WAV (or raw I/Q) file, FM-modulate if
needed, and pace UDP packets at real-time (or a speed multiple) so the
whole SDR -> ASR -> RAG path runs without hardware.
"""

from __future__ import annotations

import socket
import time
import wave
from typing import Optional

import numpy as np

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def fm_modulate(
    audio: np.ndarray, fs_audio: int, fs_baseband: int, deviation_hz: float = 75e3
) -> np.ndarray:
    """Broadcast-FM modulate mono audio to complex baseband I/Q.

    Inverse of ``streaming.dsp.fm_demodulate`` — used by tests and replay
    to synthesize the radio signal the receiver chain expects.
    """
    up = fs_baseband // fs_audio
    if fs_baseband % fs_audio:
        raise ValueError("fs_baseband must be an integer multiple of fs_audio")
    upsampled = np.repeat(audio.astype(np.float64), up)
    phase = 2 * np.pi * deviation_hz * np.cumsum(upsampled) / fs_baseband
    return np.exp(1j * phase).astype(np.complex64)


def read_wav_mono(path: str) -> tuple[int, np.ndarray]:
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype=np.int16)
        if w.getnchannels() > 1:
            pcm = pcm.reshape(-1, w.getnchannels()).mean(axis=1).astype(np.int16)
    return rate, pcm.astype(np.float32) / 32768.0


def replay_iq(
    iq: np.ndarray,
    host: str,
    port: int,
    fs_baseband: int,
    *,
    packet_samples: int = 4096,
    speed: float = 1.0,
    max_seconds: Optional[float] = None,
) -> int:
    """Send interleaved-float32 I/Q UDP packets, paced at ``speed``x
    real time (``speed=0`` disables pacing). Returns packets sent."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    packet_period = packet_samples / fs_baseband / speed if speed else 0.0
    sent = 0
    t_next = time.monotonic()
    limit = len(iq) if max_seconds is None else min(
        len(iq), int(max_seconds * fs_baseband)
    )
    for start in range(0, limit, packet_samples):
        block = iq[start : start + packet_samples]
        flat = np.empty(2 * len(block), np.float32)
        flat[0::2] = block.real
        flat[1::2] = block.imag
        sock.sendto(flat.tobytes(), (host, port))
        sent += 1
        if packet_period:
            t_next += packet_period
            delay = t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)
    sock.close()
    logger.info("replayed %d packets (%d samples)", sent, limit)
    return sent


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="WAV -> FM I/Q UDP replay")
    parser.add_argument("wav", help="input WAV file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5005)
    parser.add_argument("--fs-baseband", type=int, default=250_000)
    parser.add_argument("--speed", type=float, default=1.0, help="0 = no pacing")
    parser.add_argument("--max-seconds", type=float, default=None)
    args = parser.parse_args()

    rate, audio = read_wav_mono(args.wav)
    iq = fm_modulate(audio, rate, args.fs_baseband)
    replay_iq(
        iq,
        args.host,
        args.port,
        args.fs_baseband,
        speed=args.speed,
        max_seconds=args.max_seconds,
    )


if __name__ == "__main__":
    main()
