"""The port's streaming SDR -> ASR -> RAG pipeline (``streaming/``) against
the JAX package's, on the CPU: the DSP pieces on the same numpy-seeded
blocks, the accumulator, the timestamp database, the chains' routing, the
streaming server (the reference's aiohttp app beside the port's
``http.server`` app: statuses, JSON bodies and SSE bytes with the response
id masked), the ASR sink, and UDP end to end.

Tolerances: ``firwin_lowpass`` bit for bit (the same numpy code); the FIR,
demodulator and resampler within 1e-6 absolute of the reference's f32
outputs (sums of 101 f32 products in another order; measured ~1e-7), and
the FIR within 1e-4 of ``scipy.signal.lfilter`` as the reference's own
test holds it; ``to_pcm16`` bit for bit on the same floats; the receiver
chain's PCM within 1 LSB of the reference's (truncation toward zero moves
a sample by one where its float lies within an ulp of an integer);
transcripts equal (the same tiny conformer carried over)."""

import asyncio
import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from generativeaiexamples_tpu.streaming import dsp as JD
from generativeaiexamples_tpu_torch.streaming import dsp as TD
from test_torch_training import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    assert np.abs(got - want).max() <= atol, np.abs(got - want).max()


def _tone(freq: float, seconds: float, fs: int = 16_000, amp: float = 0.8) -> np.ndarray:
    t = np.arange(int(fs * seconds)) / fs
    return amp * np.sin(2 * np.pi * freq * t)


def _peak_hz(pcm16: np.ndarray, fs: int, skip: int) -> float:
    out = pcm16.astype(np.float32) / 32767.0
    spec = np.abs(np.fft.rfft(out[skip:]))
    return float(np.fft.rfftfreq(len(out) - skip, 1 / fs)[spec.argmax()])


class TestDSP:
    def test_firwin_is_the_reference_bit_for_bit(self):
        for args in ((101, 16_000, 250_000), (51, 50_000, 250_000), (101, 100_000, 250_000), (31, 7_200, 16_000)):
            got, want = TD.firwin_lowpass(*args), JD.firwin_lowpass(*args)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        with pytest.raises(ValueError):
            TD.firwin_lowpass(11, 9_000, 16_000)

    @pytest.mark.parametrize("kind", ("real", "complex"))
    def test_fir_blocks_match_the_reference_and_lfilter(self, kind):
        rng = np.random.default_rng(0)
        x = rng.normal(size=8192).astype(np.float32)
        if kind == "complex":
            x = (x + 1j * rng.normal(size=8192)).astype(np.complex64)
        taps = TD.firwin_lowpass(101, 16_000, 250_000)
        lp_t, lp_j = TD.LowPassFilter(16_000, 250_000, 101, device="cpu"), JD.LowPassFilter(16_000, 250_000, 101)
        got, want = [], []
        for i in range(0, 8192, 2048):
            got.append(lp_t(torch.from_numpy(x[i : i + 2048])))
            want.append(np.asarray(lp_j(jnp.asarray(x[i : i + 2048]))))
        got = torch.cat(got)
        _close(got, np.concatenate(want))
        np.testing.assert_allclose(got.numpy(), scipy.signal.lfilter(taps, [1.0], x), atol=1e-4)

    def test_demodulator_and_resampler_match_the_reference(self):
        rng = np.random.default_rng(1)
        iq = np.exp(1j * np.cumsum(rng.normal(size=4096) * 0.3)).astype(np.complex64)
        dm_t, dm_j = TD.FMDemodulator(device="cpu"), JD.FMDemodulator()
        for block in (iq[:1000], iq[1000:]):
            _close(dm_t(torch.from_numpy(block)), dm_j(jnp.asarray(block)))
        audio = rng.normal(size=62_500).astype(np.float32)
        rs_t, rs_j = TD.Resampler(250_000, 16_000, device="cpu"), JD.Resampler(250_000, 16_000)
        for block in (audio[:31_250], audio[31_250:]):
            _close(rs_t(torch.from_numpy(block)), rs_j(jnp.asarray(block)))
        # The integer cut of every output position is the reference's.
        for up, down, n in ((8, 125, 65_536), (1, 3, 1000), (2, 3, 999)):
            x = np.arange(n, dtype=np.float32)
            _close(TD._resample_block(torch.from_numpy(x), up, down), JD._resample_block(jnp.asarray(x), up, down), 0)

    def test_pcm16_is_the_reference_bit_for_bit(self):
        rng = np.random.default_rng(2)
        edges = np.asarray([-2.0, -1.0, -0.99999, -3.05e-5, -0.0, 0.0, 3.05e-5, 0.5, 0.99999, 1.0, 2.0], np.float32)
        floats = np.concatenate([edges, rng.uniform(-1.2, 1.2, 10_000).astype(np.float32),
                                 (np.arange(-200, 200) / 32767.0).astype(np.float32)])
        got, want = TD.to_pcm16(torch.from_numpy(floats)), np.asarray(JD.to_pcm16(jnp.asarray(floats)))
        assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)
        assert got[0] == -32767 and got[10] == 32767 and got[5] == 0

    def test_receiver_chain_within_one_lsb_and_recovers_the_tone(self):
        from generativeaiexamples_tpu_torch.streaming.replay import fm_modulate

        # The default 250 kHz baseband, modulated from 50 kHz audio (the
        # modulator upsamples by whole factors), received at 16 kHz.
        fs_audio, fs_bb = 16_000, 250_000
        iq = fm_modulate(_tone(1000, 1.0, fs=50_000), 50_000, fs_bb, deviation_hz=75e3)
        cfg_t, cfg_j = TD.FMReceiverConfig(), JD.FMReceiverConfig()
        rx_t, rx_j = TD.FMReceiverChain(cfg_t, device="cpu"), JD.FMReceiverChain(cfg_j)
        got, want = [], []
        for i in range(0, len(iq), 65_536):
            got.append(rx_t(iq[i : i + 65_536]))
            want.append(rx_j(iq[i : i + 65_536]))
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        assert abs(_peak_hz(got, fs_audio, 2000) - 1000) < 20

    def test_fm_modulate_and_wav_reader_are_the_reference(self, tmp_path):
        import wave

        from generativeaiexamples_tpu.streaming import replay as jr
        from generativeaiexamples_tpu_torch.streaming import replay as tr

        audio = _tone(440, 0.05)
        assert tr.fm_modulate(audio, 16_000, 256_000).tobytes() == jr.fm_modulate(audio, 16_000, 256_000).tobytes()
        with pytest.raises(ValueError):
            tr.fm_modulate(audio, 16_000, 250_001)
        path = str(tmp_path / "a.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(16_000)
            w.writeframes((np.stack([audio, -audio], 1) * 20000).astype(np.int16).tobytes())
        got, want = tr.read_wav_mono(path), jr.read_wav_mono(path)
        assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()


class TestAccumulatorAndDatabase:
    def _run(self, cls):
        chunks = []
        acc = cls(lambda text, src, t0, t1: chunks.append((text, src, t0, t1)), chunk_chars=100, overlap_chars=20)
        flushed = [acc.update("word " * 8, source="radio", now=float(i)) for i in range(10)]
        flushed.append(acc.update("  padded  ", source="tv", now=11.0))
        flushed.append(acc.update("", source="tv", now=12.0))
        pending = acc.pending("radio")
        flushed += [acc.flush("radio", now=13.0), acc.flush("tv", now=14.0), acc.flush("none", now=15.0)]
        return chunks, flushed, pending

    def test_accumulator_emits_the_reference_chunks(self):
        from generativeaiexamples_tpu.streaming.accumulator import TextAccumulator as J
        from generativeaiexamples_tpu_torch.streaming.accumulator import TextAccumulator as T

        assert self._run(T) == self._run(J)
        with pytest.raises(ValueError):
            T(lambda *a: None, chunk_chars=10, overlap_chars=10)

    def test_concurrent_multi_source_integrity(self):
        from generativeaiexamples_tpu_torch.streaming.accumulator import TextAccumulator

        chunks: dict = {}
        lock = threading.Lock()

        def sink(text, src, t0, t1):
            with lock:
                chunks.setdefault(src, []).append(text)

        acc = TextAccumulator(sink, chunk_chars=64, overlap_chars=8)
        writers = {"s1": 1, "s2": 1, "shared": 4}
        threads = [threading.Thread(target=lambda s=s, m=m: [acc.update(m * 16, source=s) for _ in range(100)])
                   for s, m in (("s1", "a"), ("s2", "b")) + (("shared", "c"),) * 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for source, mark in (("s1", "a"), ("s2", "b"), ("shared", "c")):
            acc.flush(source)
            assert all(set(c) <= {mark, " "} for c in chunks[source])
            total = sum(len(c) for c in chunks[source]) - (len(chunks[source]) - 1) * 8
            assert total >= writers[source] * 100 * 16

    def test_timestamp_database_answers_as_the_reference(self):
        from generativeaiexamples_tpu.streaming.timestamps import TimestampDatabase as J
        from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase as T

        def run(cls):
            db = cls()
            ids = [db.insert(text, "s", t0, t1) for text, t0, t1 in
                   (("old", 100, 110), ("mid", 500, 510), ("new", 990, 995), ("late", 996, 999))]
            out = (ids, db.recent(30, 1000.0), db.recent(30, 1000.0, limit=1), db.window(490, 520), db.window(0, 2000),
                   db.all_chunks(), db.count())
            db.close()
            return out

        assert run(T) == run(J)


class TestStreamingChains:
    def _pair(self, responses):
        from generativeaiexamples_tpu.chains.llm import ScriptedChatLLM as JLLM
        from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JEmb
        from generativeaiexamples_tpu.retrieval.memory import MemoryVectorStore as JStore
        from generativeaiexamples_tpu.streaming.chains import StreamingChains as JC
        from generativeaiexamples_tpu.streaming.timestamps import TimestampDatabase as JDB
        from generativeaiexamples_tpu_torch.chains.llm import ScriptedChatLLM as TLLM
        from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder as TEmb
        from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore as TStore
        from generativeaiexamples_tpu_torch.streaming.chains import StreamingChains as TC
        from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase as TDB

        return (JC(JLLM(list(responses)), JEmb(dimensions=32), JStore(dimensions=32), JDB()),
                TC(TLLM(list(responses)), TEmb(dimensions=32), TStore(dimensions=32), TDB()))

    @pytest.mark.parametrize("responses,question,now", [
        (["relevance", "the answer"], "what do TPUs use?", 100.0),
        (["recent", "they talked about weather"], "what was just said?", 100.0),
        (["past", '{"start": 400, "end": 600}', "mid content answer"], "what was said at minute 8?", 1000.0),
        (["past", "no json here", "fallback window"], "around noon?", 1000.0),
        (["summarize", "a summary"], "summarize please", 1000.0),
        (["banana", "fallback answer"], "q", 1.0),
    ])
    def test_routes_and_prompts_match_the_reference(self, responses, question, now):
        chains = self._pair(responses)
        outs = []
        for c in chains:
            c.store_chunk("TPUs use systolic arrays.", "radio", 10, 20)
            c.store_chunk("weather report sunny", "radio", 90, 95)
            c.store_chunk("mid content", "radio", 500, 510)
            outs.append(("".join(c.answer(question, now=now, max_tokens=8)), c.llm.calls, c.db.all_chunks(),
                         [h.chunk.text for h in c.store.search(c.embedder.embed_query("weather report sunny"), 2)]))
        assert outs[1] == outs[0]


class _Reference:
    """The reference's aiohttp streaming app on its own event-loop thread."""

    def __init__(self, chains) -> None:
        from aiohttp import web

        from generativeaiexamples_tpu.streaming.server import create_streaming_app

        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(create_streaming_app(chains))
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
    def __init__(self, chains) -> None:
        from generativeaiexamples_tpu_torch.streaming.server import create_streaming_app

        self.server = create_streaming_app(chains)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)


def _request(port, method, path, body=None):
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type", ""), exc.read()


_UUID = re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


@pytest.fixture(scope="module")
def servers():
    from generativeaiexamples_tpu.chains.llm import EchoChatLLM as JLLM
    from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JEmb
    from generativeaiexamples_tpu.retrieval.memory import MemoryVectorStore as JStore
    from generativeaiexamples_tpu.streaming.chains import StreamingChains as JC
    from generativeaiexamples_tpu.streaming.timestamps import TimestampDatabase as JDB
    from generativeaiexamples_tpu_torch.chains.llm import EchoChatLLM as TLLM
    from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder as TEmb
    from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore as TStore
    from generativeaiexamples_tpu_torch.streaming.chains import StreamingChains as TC
    from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase as TDB

    jchains = JC(JLLM(), JEmb(dimensions=32), JStore(dimensions=32), JDB())
    ref, port = _Reference(jchains), _Port(TC(TLLM(), TEmb(dimensions=32), TStore(dimensions=32), TDB()))
    yield ref, port, jchains
    ref.close()
    port.close()


class TestStreamingServer:
    STEPS = (
        ("POST", "/storeStreamingText", {"text": "breaking news about tpus"}),
        ("POST", "/storeStreamingText", {"text": "<b>more</b> news", "source": "tv"}),
        ("POST", "/storeStreamingText", {"text": "  "}),
        ("POST", "/flush", {"source": "stream"}),
        ("POST", "/flush", {"source": "tv"}),
        ("POST", "/flush", {"source": "stream"}),
        ("GET", "/health", None),
        ("POST", "/generate", {"messages": [{"role": "user", "content": "what about tpus?"}],
                               "use_knowledge_base": True, "max_tokens": 16}),
        ("POST", "/generate", {"messages": [{"role": "user", "content": "hello there"}], "use_knowledge_base": False,
                               "max_tokens": 2}),
    )

    def test_statuses_bodies_and_sse_bytes_match_the_reference(self, servers):
        ref, port, jchains = servers
        for method, path, body in self.STEPS:
            want = _request(ref.port, method, path, body)
            got = _request(port.port, method, path, body)
            assert got[0] == want[0], (path, got, want)
            assert got[1].split(";")[0] == want[1].split(";")[0], path
            if path == "/generate":
                assert _UUID.sub(b"<id>", got[2]) == _UUID.sub(b"<id>", want[2])
                chunks = [json.loads(line[6:]) for line in got[2].decode().splitlines() if line.startswith("data: ")]
                assert chunks[-1]["choices"][0]["finish_reason"] == "[DONE]" and len(chunks) > 1
            else:
                assert json.loads(got[2]) == json.loads(want[2]), path
        # Both stored the same chunks (timestamps are each server's clock).
        rows, want_rows = port.server.chains.db.all_chunks(), jchains.db.all_chunks()
        assert [(r["source"], r["text"]) for r in rows] == [(r["source"], r["text"]) for r in want_rows]
        assert len(rows) == 2 and all(r["t_first"] <= r["t_last"] for r in rows)
        assert len(port.server.chains.store) == len(jchains.store) == 2

    def test_port_only_errors(self, servers):
        _, port, _ = servers
        assert _request(port.port, "POST", "/generate", {"messages": "nope"})[0] == 422
        assert _request(port.port, "POST", "/storeStreamingText", b"{not json")[0] == 400
        assert _request(port.port, "GET", "/nowhere")[0] == 404


def test_asr_sink_transcribes_as_the_reference_and_posts_finals():
    """One utterance (one decode) against the reference's sink on the same
    tiny conformer; then a stream of two utterances, whose events equal the
    port's ``StreamingTranscriber`` fed the same blocks (held against the
    reference's in ``tests/test_torch_speech.py``), posted to the port's
    streaming server."""
    from generativeaiexamples_tpu.models import speech as JS
    from generativeaiexamples_tpu.streaming.asr import ASRSink as JSink
    from generativeaiexamples_tpu_torch.chains.llm import EchoChatLLM
    from generativeaiexamples_tpu_torch.engine import weights as tw
    from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder
    from generativeaiexamples_tpu_torch.models import speech as TS
    from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore
    from generativeaiexamples_tpu_torch.streaming.asr import ASRSink as TSink
    from generativeaiexamples_tpu_torch.streaming.chains import StreamingChains
    from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase
    from test_torch_train_losses import _seeded

    jc, tc = JS.asr_tiny(), TS.asr_tiny()
    rng = np.random.default_rng(3)
    tree = _seeded(TS.asr_param_shapes(tc), rng, gains=TS._ASR_NORMS)
    tp = tw.speech_params_from_numpy(tree, TS.asr_param_shapes(tc), "cpu")
    speechy = (rng.normal(size=8000) * 0.2 * 32767).astype(np.int16)
    js, ts = JSink(jax.tree.map(jnp.asarray, tree), jc), TSink(tp, tc)
    for sink in (js, ts):
        sink(speechy[:3000])
        sink.flush()
    assert ts.finals == js.finals and len(ts.finals) == 1

    # 0.5 s of noise, 1 s of silence (the endpoint closes the first
    # utterance), 0.25 s more (closed by the flush).
    pcm16 = np.concatenate([speechy, np.zeros(16_000, np.int16), speechy[:4000]])
    port = _Port(StreamingChains(EchoChatLLM(), HashEmbedder(dimensions=32), MemoryVectorStore(dimensions=32),
                                 TimestampDatabase()))
    try:
        partials = []
        sink = TSink(tp, tc, on_partial=partials.append, server_url=f"http://127.0.0.1:{port.port}/", source="radio")
        session = TS.StreamingTranscriber(tp, tc)
        events = []
        for i in range(0, len(pcm16), 4000):
            sink(pcm16[i : i + 4000])
            events += session.feed(pcm16[i : i + 4000].astype(np.float32) / 32768.0)
        sink.flush()
        events += session.finish()
        assert sink.finals == [e["text"] for e in events if e["is_final"]] and len(sink.finals) == 2
        assert partials == [e["text"] for e in events if not e["is_final"]] and partials
        posted = " ".join(t.strip() for t in sink.finals if t.strip()).strip()
        assert port.server.accumulator.pending("radio") == posted
        # The default model from a seed: the same weights from the same seed.
        a, b = TSink(asr_cfg=tc, seed=5, device="cpu"), TSink(asr_cfg=tc, seed=5, device="cpu")
        assert torch.equal(a.session.params["ctc_head"], b.session.params["ctc_head"])
    finally:
        port.close()


def test_udp_replay_through_the_pipeline():
    """UDP I/Q replay -> operator graph -> the port's FM receiver -> PCM."""
    from generativeaiexamples_tpu_torch.streaming.graph import Operator, Pipeline, UDPSource
    from generativeaiexamples_tpu_torch.streaming.replay import fm_modulate, replay_iq

    fs_audio, fs_bb = 16_000, 256_000
    iq = fm_modulate(_tone(800, 0.5), fs_audio, fs_bb, deviation_hz=75e3)
    rx = TD.FMReceiverChain(TD.FMReceiverConfig(fs_baseband=fs_bb, fs_audio=fs_audio), device="cpu")
    pcm_out = []
    pipeline = Pipeline([Operator("fm-rx", rx), Operator("sink", lambda pcm: pcm_out.append(np.asarray(pcm)))])
    pipeline.start()
    src = UDPSource(pipeline, host="127.0.0.1", port=0, block_samples=16384)
    src.start()
    try:
        sent = replay_iq(iq, "127.0.0.1", src.port, fs_bb, speed=30)
        assert sent == -(-len(iq) // 4096)
        deadline = time.time() + 30
        while len(pcm_out) < len(iq) // 16384 and time.time() < deadline:
            time.sleep(0.05)
    finally:
        src.stop()
        pipeline.stop()
    assert len(pcm_out) == len(iq) // 16384
    out = np.concatenate(pcm_out)
    assert abs(_peak_hz(out, fs_audio, 1000) - 800) < 30
