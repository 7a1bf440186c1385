"""The port's speech service (``engine/speech_service.py``, ``http.server``
with a hand-written WebSocket) against the reference's aiohttp app, both on
127.0.0.1 over the same tiny f32 params (the JAX trees carried over), fed
the same requests: statuses and JSON bodies, transcripts, the WebSocket's
events through one raw-socket client (``chip_smoke.WSClient``), streaming
TTS frames, and the wav2vec2 backend from ``GAIE_W2V2_DIR``.

TTS audio: Griffin-Lim from zero phase is chaotic on these spectra (a
one-ulp change of the reference's own input moves its output by 0.3% RMS
after one iteration and ~2% after 30; ``tests/test_torch_speech.py`` holds
the port's iteration against that spread), so the port's samples are held
within 10% relative RMS of the reference's (measured 2.3-6.0%), the WAV
header and lengths exactly, and its WAV equal sample for sample to the
port's own ``synthesize``.  The port refuses
fragmented WebSocket messages (close 1003), which aiohttp reassembles."""

import asyncio
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from generativeaiexamples_tpu.engine import speech_service as jss
from generativeaiexamples_tpu.models import speech as J
from generativeaiexamples_tpu_torch.engine import speech_service as tss
from generativeaiexamples_tpu_torch.engine.weights import speech_params_from_numpy
from generativeaiexamples_tpu_torch.models import speech as T

REL_RMS = 0.1


class _Reference:
    """The reference's aiohttp app on its own event-loop thread."""

    def __init__(self, engine) -> None:
        from aiohttp import web

        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(jss.create_speech_app(engine))
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        self.port = site._server.sockets[0].getsockname()[1]
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


class _Port:
    def __init__(self, engine) -> None:
        self.engine = engine
        self.server = tss.create_speech_app(engine)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)
        self.engine.close()


def _request(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _json_post(port, path, obj):
    return _request(port, "POST", path, json.dumps(obj).encode(), {"Content-Type": "application/json"})


def _multipart(data: bytes, field: str = "file"):
    boundary = "speechTestBoundary"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; filename="a.wav"\r\n'
            f"Content-Type: audio/wav\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _wav(pcm16: np.ndarray, rate: int = 16_000) -> bytes:
    return tss._write_wav(rate, pcm16)


def _samples(wav_bytes: bytes) -> tuple:
    with wave.open(io.BytesIO(wav_bytes), "rb") as w:
        return (w.getnchannels(), w.getsampwidth(), w.getframerate()), np.frombuffer(w.readframes(w.getnframes()),
                                                                                       np.int16)


def _near(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert np.sqrt(np.mean((got - want) ** 2)) <= REL_RMS * np.sqrt(np.mean(want**2))


def _carry(tree, shapes):
    return speech_params_from_numpy(jax.tree.map(np.asarray, tree), shapes, "cpu")


@pytest.fixture(scope="module")
def params():
    asr = J.asr_init_params(J.asr_tiny(), jax.random.PRNGKey(0))
    tts = J.tts_init_params(J.tts_tiny(), jax.random.PRNGKey(1))
    return asr, tts, _carry(asr, T.asr_param_shapes(T.asr_tiny())), _carry(tts, T.tts_param_shapes(T.tts_tiny()))


@pytest.fixture
def servers(params, monkeypatch):
    monkeypatch.delenv("GAIE_W2V2_DIR", raising=False)
    jasr, jtts, tasr, ttts = params
    ref = _Reference(jss.SpeechEngine(J.asr_tiny(), J.tts_tiny(), asr_params=jasr, tts_params=jtts))
    port = _Port(tss.SpeechEngine(T.asr_tiny(), T.tts_tiny(), asr_params=tasr, tts_params=ttts, device="cpu"))
    yield ref, port
    port.close()
    ref.close()


def test_tts_then_asr_and_errors(servers):
    ref, port = servers
    text = "hello card world"
    (js, jh, jb), (ts, th, tb) = (_json_post(s.port, "/v1/audio/speech", {"input": text}) for s in (ref, port))
    assert js == ts == 200 and jh["Content-Type"].startswith("audio/wav") and th["Content-Type"] == "audio/wav"
    (jfmt, jpcm), (tfmt, tpcm) = _samples(jb), _samples(tb)
    assert jfmt == tfmt == (1, 2, 16_000)
    _near(tpcm, jpcm)
    assert np.array_equal(tpcm, port.engine.synthesize(text)[1])
    # The same WAV through both transcribers; the port's equals a direct call.
    for wav_bytes in (jb, _wav((cs.speech_wave(np, 0, 0.7) * 32767).astype(np.int16)),
                      _wav((cs.speech_wave(np, 1, 0.5) * 32767).astype(np.int16), rate=22_050)):
        body, headers = _multipart(wav_bytes)
        (js, _, jb2), (ts, _, tb2) = (_request(s.port, "POST", "/v1/audio/transcriptions", body, headers)
                                      for s in (ref, port))
        assert js == ts == 200 and json.loads(tb2) == json.loads(jb2)
        assert json.loads(tb2)["text"] == port.engine.transcribe(tss._read_wav(wav_bytes))
    for path, body, headers in (
        ("/v1/audio/speech", json.dumps({"input": "  "}).encode(), {"Content-Type": "application/json"}),
        ("/v1/audio/speech/stream", json.dumps({"input": ""}).encode(), {"Content-Type": "application/json"}),
        ("/v1/audio/transcriptions", *_multipart(b"", field="other")),
        ("/v1/audio/transcriptions", *_multipart(b"not a wav file")),
    ):
        (js, _, jb2), (ts, _, tb2) = (_request(s.port, "POST", path, body, headers) for s in (ref, port))
        assert js == ts == 400 and json.loads(tb2) == json.loads(jb2), path
    for path in ("/v1/audio/voices", "/health"):
        (js, _, jb2), (ts, _, tb2) = (_request(s.port, "GET", path) for s in (ref, port))
        assert js == ts == 200 and json.loads(tb2) == json.loads(jb2)


def test_streaming_tts_frames(servers):
    ref, port = servers
    text = ("alpha bravo charlie delta echo. " * 20).strip()
    out = []
    for s in (ref, port):
        status, headers, raw = _json_post(s.port, "/v1/audio/speech/stream", {"input": text})
        assert status == 200 and headers["X-Sample-Rate"] == "16000"
        frames, pos = [], 0
        while pos + 4 <= len(raw):
            n = int.from_bytes(raw[pos : pos + 4], "little")
            frames.append(np.frombuffer(raw[pos + 4 : pos + 4 + n], np.int16))
            pos += 4 + n
        assert pos == len(raw)
        out.append(frames)
    assert len(out[1]) == len(out[0]) == len(tss.segment_text(text)) >= 2
    for got, want, segment in zip(out[1], out[0], tss.segment_text(text)):
        _near(got, want)
        assert np.array_equal(got, port.engine.synthesize(segment)[1])


def test_websocket_stream_events(servers):
    ref, port = servers
    audio = np.concatenate([cs.speech_wave(np, 2, 0.8, silence=1.4), cs.speech_wave(np, 3, 0.6)])
    pcm16 = (audio * 32767).astype(np.int16).tobytes()
    events = []
    for s in (ref, port):
        ws = cs.WSClient("127.0.0.1", s.port, "/v1/audio/transcriptions/stream")
        # An odd frame size splits samples across frames.
        events.append(cs.stream_pcm(ws, pcm16, 4001))
        ws.close()
    assert events[1] == events[0]
    kinds = [e["type"] for e in events[1]]
    assert "partial" in kinds and "final" in kinds and kinds[-1] == "done"
    # The port's events equal a direct session fed the same samples.
    session = T.StreamingTranscriber(port.engine.asr_params, port.engine.asr_cfg)
    direct, carry = [], b""
    for i in range(0, len(pcm16), 4001):
        data = carry + pcm16[i : i + 4001]
        cut = len(data) & ~1
        data, carry = data[:cut], data[cut:]
        direct += session.feed(np.frombuffer(data, np.int16).astype(np.float32) / 32768.0)
    direct += session.finish()
    assert [{"type": "final" if e["is_final"] else "partial", "text": e["text"]} for e in direct] == events[1][:-1]
    assert events[1][-1] == {"type": "done", "transcript": session.transcript}
    # A config at 8 kHz resamples before the recognizer, on both.
    got = []
    for s in (ref, port):
        ws = cs.WSClient("127.0.0.1", s.port, "/v1/audio/transcriptions/stream")
        got.append(cs.stream_pcm(ws, pcm16[: 2 * 12000], 3000, rate=8000))
        ws.close()
    assert got[1] == got[0]


def test_websocket_protocol(servers):
    _, port = servers
    ws = cs.WSClient("127.0.0.1", port.port, "/v1/audio/transcriptions/stream")
    ws.send(0x9, b"are you there")
    assert ws.recv() == (0xA, b"are you there")
    ws.send_json({"type": "config", "sample_rate": 16000})
    ws.send(0x1, b"not json")
    ws.send(0x2, b"\x01\x02\x03", fin=False)  # the start of a fragmented message
    opcode, payload = ws.recv()
    assert opcode == 0x8 and int.from_bytes(payload[:2], "big") == 1003
    ws.sock.close()
    # A client that closes first gets a close frame back and no result.
    ws = cs.WSClient("127.0.0.1", port.port, "/v1/audio/transcriptions/stream")
    ws.send(0x8, (1000).to_bytes(2, "big"))
    opcode, payload = ws.recv()
    assert opcode == 0x8 and int.from_bytes(payload[:2], "big") == 1000
    ws.sock.close()
    # An unmasked client frame is a protocol error (1002).
    ws = cs.WSClient("127.0.0.1", port.port, "/v1/audio/transcriptions/stream")
    ws.sock.sendall(tss.ws_frame(0x1, b'{"type": "end"}'))
    opcode, payload = ws.recv()
    assert opcode == 0x8 and int.from_bytes(payload[:2], "big") == 1002
    ws.sock.close()
    # A plain GET is not an upgrade.
    status, _, body = _request(port.port, "GET", "/v1/audio/transcriptions/stream")
    assert status == 400 and b"WebSocket" in body


def test_wav2vec2_backend_from_env(tmp_path, monkeypatch, params):
    cfg = T.wav2vec2_tiny()
    cs.write_w2v2_checkpoint(torch, np, tmp_path, cfg, seed=3)
    monkeypatch.setenv("GAIE_W2V2_DIR", str(tmp_path))
    _, jtts, _, ttts = params
    ref = _Reference(jss.SpeechEngine(J.asr_tiny(), J.tts_tiny(), tts_params=jtts))
    port = _Port(tss.SpeechEngine(T.asr_tiny(), T.tts_tiny(), tts_params=ttts, device="cpu"))
    try:
        assert port.engine.asr_backend == "wav2vec2-ctc" and port.engine.asr_params is None
        assert port.engine.w2v2_vocab[:5] == ["<pad>", "<s>", "</s>", "<unk>", "|"]
        pcm16 = (cs.speech_wave(np, 4, 0.6) * 32767).astype(np.int16)
        body, headers = _multipart(_wav(pcm16))
        (js, _, jb), (ts, _, tb) = (_request(s.port, "POST", "/v1/audio/transcriptions", body, headers)
                                    for s in (ref, port))
        assert js == ts == 200 and json.loads(tb) == json.loads(jb)
        (_, _, jh), (_, _, th) = (_request(s.port, "GET", "/health") for s in (ref, port))
        assert json.loads(th) == json.loads(jh) == {"message": "Service is up.", "asr_backend": "wav2vec2-ctc"}
        events = []
        for s in (ref, port):
            ws = cs.WSClient("127.0.0.1", s.port, "/v1/audio/transcriptions/stream")
            events.append(cs.stream_pcm(ws, pcm16.tobytes(), 8000))
            ws.close()
        assert events[1] == events[0]
        # Explicit conformer params win over the environment.
        assert tss.SpeechEngine(T.asr_tiny(), T.tts_tiny(), asr_params=params[2], tts_params=ttts,
                                device="cpu").asr_backend == "conformer-ctc"
    finally:
        port.close()
        ref.close()


def test_main_flags_and_the_default_device(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tss.SpeechEngine(T.asr_tiny(), T.tts_tiny())
    seen = {}

    class Stop(Exception):
        pass

    def fake_app(engine, host, port):
        seen.update(device=engine.device.type, host=host, port=port, asr=engine.asr_cfg.d_model)
        raise Stop

    monkeypatch.setattr(tss, "create_speech_app", fake_app)
    with pytest.raises(Stop):
        tss.main(["--tiny", "--device", "cpu", "--port", "0", "--host", "127.0.0.1"])
    assert seen == {"device": "cpu", "host": "127.0.0.1", "port": 0, "asr": T.asr_tiny().d_model}
