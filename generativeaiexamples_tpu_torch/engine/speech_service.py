"""Speech service: OpenAI-style ASR / TTS endpoints on the port's speech
models (port of ``engine/speech_service.py``, on ``http.server``: the
card machine has no aiohttp).

* ``POST /v1/audio/transcriptions`` (multipart WAV, field ``file``) ->
  ``{"text": ...}``
* ``GET /v1/audio/transcriptions/stream`` — streaming recognition over a
  WebSocket (RFC 6455, written here: the handshake, masked client frames,
  text, binary, ping and close; a fragmented message is refused with close
  code 1003).  The client sends an optional ``{"type": "config",
  "sample_rate": N}`` then binary PCM16 frames; the server pushes
  ``{"type": "partial"|"final", "text": ...}`` as the recognizer produces
  them, and after ``{"type": "end"}`` the finals of ``finish`` and
  ``{"type": "done", "transcript": ...}``.
* ``POST /v1/audio/speech`` ``{"input", "voice"}`` -> WAV bytes (input cut
  at 400 characters)
* ``POST /v1/audio/speech/stream`` — streaming synthesis: 300-character
  segments, each one's PCM16 as a length-prefixed frame (u32 LE byte count
  + payload) as soon as it is synthesized; the rate in ``X-Sample-Rate``.
* ``GET /v1/audio/voices``, ``GET /health``

Device work runs on one thread (:meth:`SpeechEngine.run`); random weights
come from a seeded ``torch.Generator`` on the device unless a trained
conformer or a wav2vec2-CTC checkpoint (``GAIE_W2V2_DIR``) is given.
"""

from __future__ import annotations

import base64
import concurrent.futures
import email.parser
import email.policy
import hashlib
import io
import json
import os
import socket
import struct
import urllib.parse
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.models import speech

logger = get_logger(__name__)

TTS_SEGMENT_CHARS = 300  # below the 400-character request cap
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
WS_MAX_MESSAGE = 64 * 1024 * 1024


def segment_text(text: str, limit: int = TTS_SEGMENT_CHARS) -> list[str]:
    """Split text on sentence / space boundaries into <= limit-char segments
    (a copy of the reference's ``frontend/speech.py::segment_text``)."""
    segments: list[str] = []
    rest = text.strip()
    while rest:
        if len(rest) <= limit:
            segments.append(rest)
            break
        cut = rest.rfind(". ", 0, limit)
        if cut < limit // 2:
            cut = rest.rfind(" ", 0, limit)
        if cut <= 0:
            cut = limit
        segments.append(rest[: cut + 1].strip())
        rest = rest[cut + 1 :].strip()
    return [s for s in segments if s]


class SpeechEngine:
    """ASR + TTS params on ``device`` (the card unless ``"cpu"``), with
    device work serialized onto one thread.

    The ASR backend is the conformer (``asr_params``, else random) or a
    wav2vec2-CTC: ``w2v2=(cfg, params)``, or an HF ``Wav2Vec2ForCTC``
    checkpoint directory (``w2v2_dir`` / ``GAIE_W2V2_DIR``, with its
    ``vocab.json`` as the decode table).  Explicit ``asr_params`` win over
    the environment.  A wav2vec2 backend serves both the offline endpoint
    and the stream.
    """

    def __init__(
        self,
        asr_cfg: Optional[speech.ASRConfig] = None,
        tts_cfg: Optional[speech.TTSConfig] = None,
        seed: int = 0,
        *,
        w2v2: Optional[tuple] = None,
        w2v2_dir: Optional[str] = None,
        asr_params=None,
        tts_params=None,
        device=None,
    ) -> None:
        import torch

        from generativeaiexamples_tpu_torch.core.device import resolve_device

        self.device = resolve_device(device)
        self.asr_cfg = asr_cfg or speech.conformer_s()
        self.tts_cfg = tts_cfg or speech.fastspeech_s()
        self.w2v2_vocab = None  # custom CTC decode table (vocab.json)
        w2v2_dir = w2v2_dir or os.environ.get("GAIE_W2V2_DIR")
        if w2v2 is None and w2v2_dir and asr_params is None:
            from generativeaiexamples_tpu_torch.engine.weights import load_hf_wav2vec2, w2v2_config_from_hf

            cfg = w2v2_config_from_hf(w2v2_dir)
            w2v2 = (cfg, load_hf_wav2vec2(cfg, w2v2_dir, device=self.device))
            logger.info("ASR backend: wav2vec2-CTC from %s", w2v2_dir)
            vocab_path = os.path.join(w2v2_dir, "vocab.json")
            if os.path.isfile(vocab_path):
                with open(vocab_path, encoding="utf-8") as fh:
                    tok_to_id = json.load(fh)
                self.w2v2_vocab = [""] * cfg.vocab_size
                for tok, i in tok_to_id.items():
                    if 0 <= int(i) < cfg.vocab_size:
                        self.w2v2_vocab[int(i)] = tok
        self.w2v2 = w2v2

        def generator(offset: int):
            return torch.Generator(device=self.device).manual_seed(seed + offset)

        if asr_params is not None:
            self.asr_params = asr_params  # a trained conformer
        elif w2v2 is None:
            self.asr_params = speech.asr_init_params(self.asr_cfg, generator(0), self.device)
        else:
            self.asr_params = None  # the wav2vec2 serves both endpoints
        self.tts_params = (
            tts_params if tts_params is not None else speech.tts_init_params(self.tts_cfg, generator(1), self.device)
        )
        self._mel_to_linear = np.linalg.pinv(
            speech.mel_filterbank(self.tts_cfg.n_mels, self.tts_cfg.n_fft, self.tts_cfg.fs).T
        ).astype(np.float32)
        self.voices = ["default"]
        self._worker = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="speech-device")

    @property
    def asr_backend(self) -> str:
        return "wav2vec2-ctc" if self.w2v2 is not None else "conformer-ctc"

    def run(self, fn, *args):
        """``fn(*args)`` on the engine's device thread."""
        return self._worker.submit(fn, *args).result()

    def close(self) -> None:
        self._worker.shutdown(wait=True)

    def transcribe(self, pcm: np.ndarray) -> str:
        if self.w2v2 is not None:
            cfg, params = self.w2v2
            # Bucketed after the utterance's own normalization.
            return speech.w2v2_transcribe(params, cfg, pcm, self.w2v2_vocab, pad=True)
        return speech.transcribe(self.asr_params, self.asr_cfg, pcm)

    def streaming_transcriber(self, **kwargs) -> speech.StreamingTranscriber:
        """A fresh incremental-recognition session (one per stream)."""
        if self.w2v2 is not None:
            cfg, params = self.w2v2
            return speech.StreamingTranscriber.wav2vec2(params, cfg, vocab=self.w2v2_vocab, **kwargs)
        return speech.StreamingTranscriber(self.asr_params, self.asr_cfg, **kwargs)

    def synthesize(self, text: str) -> tuple[int, np.ndarray]:
        wave_f = speech.synthesize(self.tts_params, self.tts_cfg, text, mel_to_linear=self._mel_to_linear)
        return self.tts_cfg.fs, (wave_f * 32767).astype(np.int16)


def _resample_to_16k(audio: np.ndarray, rate: int) -> np.ndarray:
    if rate == 16_000 or not len(audio):
        return audio
    pos = np.linspace(0, len(audio) - 1, int(len(audio) * 16_000 / rate))
    return np.interp(pos, np.arange(len(audio)), audio).astype(np.float32)


def _read_wav(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() > 1:
            pcm = pcm.reshape(-1, w.getnchannels()).mean(-1).astype(np.int16)
    return _resample_to_16k(pcm.astype(np.float32) / 32768.0, rate)


def _write_wav(rate: int, pcm: np.ndarray) -> bytes:
    out = io.BytesIO()
    with wave.open(out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return out.getvalue()


def _file_field(content_type: str, body: bytes) -> bytes:
    """The last ``file`` field of a multipart/form-data body (b"" if none)."""
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body
    )
    data = b""
    if msg.is_multipart():
        for part in msg.iter_parts():
            if part.get_param("name", header="content-disposition") == "file":
                data = part.get_payload(decode=True) or b""
    return data


# -- WebSocket (RFC 6455), server side ---------------------------------------------

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


class WebSocketClosed(Exception):
    """The peer closed (``code``) or broke the protocol."""

    def __init__(self, code: int = 1000, reason: str = "") -> None:
        super().__init__(f"websocket closed: {code} {reason}")
        self.code = code
        self.reason = reason


def ws_accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + WS_GUID).encode("ascii")).digest()).decode("ascii")


def ws_frame(opcode: int, payload: bytes, mask: Optional[bytes] = None, fin: bool = True) -> bytes:
    """One frame (``mask``: a client's 4-byte masking key)."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([bit | n])
    elif n < 1 << 16:
        head += bytes([bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([bit | 127]) + struct.pack(">Q", n)
    return head + (mask + _xor(payload, mask) if mask else payload)


def _xor(payload: bytes, mask: bytes) -> bytes:
    data = np.frombuffer(payload, np.uint8)
    return (data ^ np.resize(np.frombuffer(mask, np.uint8), len(data))).tobytes()


def ws_read_frame(rfile, *, require_mask: bool) -> tuple[bool, int, bytes]:
    """(fin, opcode, unmasked payload) of the next frame on ``rfile``."""

    def read(n: int) -> bytes:
        data = rfile.read(n)
        if len(data) != n:
            raise WebSocketClosed(1006, "connection lost")
        return data

    b0, b1 = read(2)
    if b0 & 0x70:
        raise WebSocketClosed(1002, "reserved bits set")
    fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
    if n == 126:
        n = struct.unpack(">H", read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", read(8))[0]
    if masked != require_mask:
        raise WebSocketClosed(1002, "client frames must be masked" if require_mask else "server frames are unmasked")
    if opcode >= 0x8 and (n > 125 or not fin):
        raise WebSocketClosed(1002, "bad control frame")
    if n > WS_MAX_MESSAGE:
        raise WebSocketClosed(1009, "message too big")
    mask = read(4) if masked else None
    payload = read(n)
    return fin, opcode, (_xor(payload, mask) if mask else payload)


class _WebSocket:
    """The server end of an upgraded connection."""

    CLOSE_WAIT_S = 5.0  # how long close() waits for the peer's close frame

    def __init__(self, sock, rfile, wfile) -> None:
        self.sock = sock
        self.rfile = rfile
        self.wfile = wfile
        self.closed = False

    def send(self, opcode: int, payload: bytes) -> None:
        self.wfile.write(ws_frame(opcode, payload))
        self.wfile.flush()

    def send_json(self, obj) -> None:
        self.send(OP_TEXT, json.dumps(obj).encode())

    def receive(self) -> tuple[int, bytes]:
        """The next text or binary message (pings answered on the way)."""
        while True:
            fin, opcode, payload = ws_read_frame(self.rfile, require_mask=True)
            if opcode == OP_PING:
                self.send(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                code = struct.unpack(">H", payload[:2])[0] if len(payload) >= 2 else 1005
                raise WebSocketClosed(code, payload[2:].decode("utf-8", "replace"))
            if not fin or opcode == OP_CONT:
                raise WebSocketClosed(1003, "fragmented messages are not supported")
            if opcode not in (OP_TEXT, OP_BINARY):
                raise WebSocketClosed(1002, f"unknown opcode {opcode}")
            return opcode, payload

    def close(self, code: int = 1000, reason: str = "", peer_closed: bool = False) -> None:
        """Send a close frame (none on a lost connection, 1006) and, unless
        the peer closed first, wait briefly for its close frame."""
        if self.closed or code == 1006:
            self.closed = True
            return
        self.closed = True
        try:
            self.send(OP_CLOSE, struct.pack(">H", code) + reason.encode()[:120])
            if not peer_closed:
                self.sock.settimeout(self.CLOSE_WAIT_S)
                for _ in range(8):
                    if ws_read_frame(self.rfile, require_mask=True)[1] == OP_CLOSE:
                        break
        except (OSError, WebSocketClosed, ValueError):
            pass


# -- HTTP handlers ------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server: "SpeechServer"

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, payload: dict, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", "0") or 0))

    def _text_input(self) -> Optional[str]:
        """``input`` of a JSON body, or None after a 400."""
        try:
            body = json.loads(self._body() or b"null")
        except ValueError:
            body = None
        if not isinstance(body, dict):
            self._json({"message": "request body must be a JSON object"}, 400)
            return None
        text = str(body.get("input", ""))
        if not text.strip():
            self._json({"message": "empty input"}, 400)
            return None
        return text

    def do_GET(self) -> None:  # noqa: N802
        route = urllib.parse.urlsplit(self.path).path
        engine = self.server.engine
        if route == "/v1/audio/voices":
            self._json({"voices": [{"name": v, "language": "en-US"} for v in engine.voices]})
        elif route == "/health":
            self._json({"message": "Service is up.", "asr_backend": engine.asr_backend})
        elif route == "/v1/audio/transcriptions/stream":
            self._stream_transcriptions()
        else:
            self._json({"message": f"no route {route}"}, 404)

    def do_POST(self) -> None:  # noqa: N802
        route = urllib.parse.urlsplit(self.path).path
        handler = {"/v1/audio/transcriptions": self._transcriptions, "/v1/audio/speech": self._speech,
                   "/v1/audio/speech/stream": self._speech_stream}.get(route)
        if handler is None:
            self._body()
            self._json({"message": f"no route {route}"}, 404)
            return
        handler()

    def _transcriptions(self) -> None:
        audio = _file_field(self.headers.get("Content-Type", ""), self._body())
        if not audio:
            self._json({"text": "", "message": "no file"}, 400)
            return
        try:
            pcm = _read_wav(audio)
        except Exception:
            self._json({"text": "", "message": "undecodable audio (expect WAV/PCM16)"}, 400)
            return
        self._json({"text": self.server.engine.run(self.server.engine.transcribe, pcm)})

    def _speech(self) -> None:
        text = self._text_input()
        if text is None:
            return
        rate, pcm = self.server.engine.run(self.server.engine.synthesize, text[:400])
        body = _write_wav(rate, pcm)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _speech_stream(self) -> None:
        engine = self.server.engine
        text = self._text_input()
        if text is None:
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("X-Sample-Rate", str(engine.tts_cfg.fs))
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for segment in segment_text(text):
                _, pcm = engine.run(engine.synthesize, segment)
                payload = pcm.tobytes()
                self.wfile.write(len(payload).to_bytes(4, "little") + payload)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            logger.info("streaming TTS client disconnected")

    def _upgrade(self) -> Optional[_WebSocket]:
        """The RFC 6455 handshake, or None after a 400."""
        key = self.headers.get("Sec-WebSocket-Key", "")
        if ("websocket" not in self.headers.get("Upgrade", "").lower()
                or "upgrade" not in self.headers.get("Connection", "").lower()
                or self.headers.get("Sec-WebSocket-Version") != "13" or not key):
            self._json({"message": "expected a WebSocket upgrade (RFC 6455, version 13)"}, 400)
            return None
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", ws_accept_key(key))
        self.end_headers()
        self.wfile.flush()
        self.close_connection = True
        return _WebSocket(self.connection, self.rfile, self.wfile)

    def _stream_transcriptions(self) -> None:
        """Streaming recognition (see the module docstring)."""
        ws = self._upgrade()
        if ws is None:
            return
        engine = self.server.engine
        session = engine.streaming_transcriber()
        rate = 16_000
        carry = b""  # a dangling byte of an int16 split across frames
        close_code, reason, peer_closed = 1000, "", False

        def send_events(events) -> None:
            for ev in events:
                ws.send_json({"type": "final" if ev["is_final"] else "partial", "text": ev["text"]})

        try:
            while True:
                opcode, payload = ws.receive()
                if opcode == OP_TEXT:
                    try:
                        data = json.loads(payload)
                    except ValueError:
                        continue
                    if not isinstance(data, dict):
                        continue
                    if data.get("type") == "config":
                        rate = int(data.get("sample_rate", 16_000)) or 16_000
                    elif data.get("type") == "end":
                        send_events(engine.run(session.finish))
                        ws.send_json({"type": "done", "transcript": session.transcript})
                        break
                    continue
                data = carry + payload
                cut = len(data) & ~1
                raw, carry = data[:cut], data[cut:]
                if not raw:
                    continue
                pcm = _resample_to_16k(np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0, rate)
                send_events(engine.run(session.feed, pcm))
        except WebSocketClosed as exc:
            # The client closed (answered with 1000), or broke the
            # protocol (answered with the fault's code), or vanished.
            peer_closed = exc.code not in (1002, 1003, 1006, 1009)
            close_code, reason = (1000, "") if peer_closed else (exc.code, exc.reason)
            logger.info("streaming ASR: %s", exc)
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            close_code = 1006
            logger.info("streaming ASR client disconnected mid-stream")
        finally:
            ws.close(close_code, reason, peer_closed)


class SpeechServer(ThreadingHTTPServer):
    """The speech service over one :class:`SpeechEngine`."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, address, engine: SpeechEngine) -> None:
        super().__init__(address, _Handler)
        self.engine = engine


def create_speech_app(engine: Optional[SpeechEngine] = None, host: str = "127.0.0.1", port: int = 0,
                      device=None) -> SpeechServer:
    """Bind the speech service (``serve_forever`` serves; port 0 picks a
    free port).  Without ``engine``, a default one on ``device``."""
    return SpeechServer((host, port), engine or SpeechEngine(device=device))


def main(argv: Optional[list] = None) -> None:
    """``python -m generativeaiexamples_tpu_torch.engine.speech_service``."""
    import argparse

    from generativeaiexamples_tpu_torch.core.logging import configure_logging

    parser = argparse.ArgumentParser(description="speech service (ASR + TTS) on the port's models")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8020)
    parser.add_argument("--tiny", action="store_true", help="tiny configs (smoke)")
    parser.add_argument("--w2v2-dir", default=None,
                        help="HF Wav2Vec2ForCTC checkpoint dir: serve trained ASR (offline + streaming) instead of "
                             "the random-init conformer")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="count", default=None)
    args = parser.parse_args(argv)
    configure_logging(args.verbose)
    cfgs = (speech.asr_tiny(), speech.tts_tiny()) if args.tiny else (None, None)
    engine = SpeechEngine(*cfgs, w2v2_dir=args.w2v2_dir, device=args.device)
    server = create_speech_app(engine, args.host, args.port)
    logger.info("speech service on %s:%d (%s, ASR %s)", args.host, server.server_address[1], engine.device,
                engine.asr_backend)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
