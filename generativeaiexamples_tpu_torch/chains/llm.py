"""Chat-LLM connectors (port of the JAX package's ``chains/llm.py``).

The primary backend is the in-process engine: :class:`GPUChatLLM` streams
from the port's continuous-batching ``Scheduler`` on the card (the
counterpart of the reference's ``TPUChatLLM``, which runs a
``LlamaGenerator``).  :class:`OpenAIChatLLM` covers external engines
(including the port's own serving front), and the echo and scripted
backends make every pipeline testable without a model.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import random
import time
import uuid
from typing import Any, Iterator, Protocol, Sequence

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.resilience.breaker import CircuitOpenError, get_breaker
from generativeaiexamples_tpu_torch.resilience.deadline import DeadlineExceeded, current_deadline
from generativeaiexamples_tpu_torch.resilience.faults import inject

logger = get_logger(__name__)

ChatTurn = tuple[str, str]


class GenerationError(RuntimeError):
    """Typed failure from an LLM backend: the stream died before
    completing.  Chains let it propagate so the server can emit a proper
    SSE error chunk instead of silently truncating the answer."""


def guarded_stream(llm: "ChatLLM", messages: Sequence[ChatTurn], **kwargs: Any) -> Iterator[str]:
    """Stream from ``llm`` under the shared ``llm`` circuit breaker.

    One gate for every backend: refused instantly (``CircuitOpenError`` →
    the server's retryable 503) while the breaker is open, outcomes
    recorded on completion/failure, the ``llm`` fault point traversed,
    and untyped backend errors wrapped in :class:`GenerationError`.
    """
    breaker = get_breaker("llm")
    breaker.check()
    try:
        inject("llm")
        yield from llm.stream(messages, **kwargs)
    except (DeadlineExceeded, CircuitOpenError):
        raise  # request/breaker state, not evidence against the backend
    except GenerationError:
        breaker.record_failure()
        raise
    except Exception as exc:
        breaker.record_failure()
        raise GenerationError(f"generation failed: {exc}") from exc
    breaker.record_success()


class ChatLLM(Protocol):
    def stream(
        self,
        messages: Sequence[ChatTurn],
        *,
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        stop: Sequence[str] = (),
        session_id: str = "",
    ) -> Iterator[str]:
        """Yield response text chunks for a chat conversation."""
        ...


def _apply_stop(chunks: Iterator[str], stop: Sequence[str]) -> Iterator[str]:
    """Cut the stream at the first stop-sequence occurrence (the returned
    text excludes the stop sequence, reference Prompt.stop semantics)."""
    if not stop:
        yield from chunks
        return
    buffer = ""
    max_stop = max(len(s) for s in stop)
    for chunk in chunks:
        buffer += chunk
        for s in stop:
            idx = buffer.find(s)
            if idx >= 0:
                if buffer[:idx]:
                    yield buffer[:idx]
                return
        # Emit all but a tail that could still start a stop sequence.
        safe = len(buffer) - (max_stop - 1)
        if safe > 0:
            yield buffer[:safe]
            buffer = buffer[safe:]
    if buffer:
        yield buffer


class GPUChatLLM:
    """In-process Llama generation on the port's ``Scheduler``.

    By default it builds what the engine server builds: the ``model_preset``
    model with random int8 weights (seed 0), int8 KV, the scheduler's
    ``SERVING_DEFAULTS``, on ``device`` (None is the card; ``"cpu"`` only
    when asked), but for one setting.  An injected ``scheduler`` (and
    ``tokenizer``) is used as given.  The scheduler's tick thread starts
    here and stops in :meth:`close`.

    The setting: a prompt is not cut into 256-token chunks.  The
    reference's in-process generator prefills each prompt whole
    (``LlamaGenerator.generate``), and so does this engine: a prompt with
    no shared prefix takes the flash kernel in one cold forward, one that
    shares a prefix with a parked segment prefills only its suffix.  The
    cost: a burst's cold batch (up to ``ADMIT_TOKEN_BUDGET`` prompt tokens)
    holds running streams for the tick that prefills it.

    A prompt longer than the scheduler admits is refused with
    :class:`GenerationError` (the reference's generator raises on a prompt
    over ``max_len``); the scheduler would keep only its tail, cutting off
    a RAG prompt's system turn and context.  A stream whose engine fails
    (a tick error, or the tick thread gone) raises
    :class:`GenerationError`; it never ends early in silence.
    """

    # Seconds a stream waits for its next token before it checks that the
    # tick thread is still alive.
    POLL_S = 1.0

    def __init__(self, scheduler=None, tokenizer=None, model_preset: str = "llama3-8b", device=None) -> None:
        if scheduler is None:
            from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS, Scheduler
            from generativeaiexamples_tpu_torch.models import llama

            cfg = dataclasses.replace(llama.PRESETS[model_preset](), kv_dtype="int8")
            kw = dict(SERVING_DEFAULTS, prefill_chunk_tokens=None,
                      max_len=min(SERVING_DEFAULTS["max_len"], cfg.max_seq_len))
            logger.warning("no checkpoint loading in the port yet: serving random int8 weights (seed 0)")
            scheduler = Scheduler(cfg, None, device=device, **kw)
        if tokenizer is None:
            from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(model_preset)
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self._closed = False
        scheduler.start()

    def close(self) -> None:
        """Stop the scheduler's tick thread (streams still open fail)."""
        self._closed = True
        self.scheduler.stop()

    def stream(
        self,
        messages: Sequence[ChatTurn],
        *,
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        stop: Sequence[str] = (),
        session_id: str = "",
    ) -> Iterator[str]:
        from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
        from generativeaiexamples_tpu_torch.engine.scheduler import Request
        from generativeaiexamples_tpu_torch.engine.tokenizer import decode_stream

        prompt_ids = self.tokenizer.apply_chat_template(list(messages))
        limit = self.scheduler.max_prompt_len
        if len(prompt_ids) > limit:
            raise GenerationError(f"prompt of {len(prompt_ids)} tokens is longer than the engine admits ({limit})")
        out_q: "queue.Queue[tuple[str, Any]]" = queue.Queue()
        req = Request(
            token_ids=list(prompt_ids),
            sampling=SamplingParams(temperature=temperature, top_p=top_p, max_tokens=max_tokens),
            on_token=lambda tid: out_q.put(("token", tid)),
            on_done=lambda reason: out_q.put(("done", reason)),
            eos_id=self.tokenizer.eos_id,
            id=f"chat-{uuid.uuid4().hex}",
            session_id=session_id,
        )

        def token_stream() -> Iterator[str]:
            # Incremental UTF-8 decoding: byte tokens may split multi-byte
            # characters, so a piece waits until its sequence completes.
            piece = decode_stream(self.tokenizer)
            finished = False
            self.scheduler.submit(req)
            try:
                while True:
                    try:
                        kind, value = out_q.get(timeout=self.POLL_S)
                    except queue.Empty:
                        if self._closed or not self.scheduler.healthy():
                            raise GenerationError("the engine's tick thread is not running") from None
                        continue
                    if kind == "done":
                        finished = True
                        if value == "error":
                            raise GenerationError("generation failed in the engine (see the scheduler's log)")
                        tail = piece(0, final=True)
                        if tail:
                            yield tail
                        return
                    text = piece(value)
                    if text:
                        yield text
            finally:
                if not finished:
                    self.scheduler.cancel(req.id)

        return _apply_stop(token_stream(), stop)


class OpenAIChatLLM:
    """Client for any OpenAI-compatible /v1/chat/completions endpoint —
    an external engine or another replica of the serving front.

    Resilience: split connect/read timeouts capped by the request
    deadline; pre-stream failures (connect errors, 5xx) are retried with
    jittered backoff, but once content has streamed the failure is
    surfaced as :class:`GenerationError` — replaying a half-delivered
    answer would duplicate output.
    """

    def __init__(
        self,
        base_url: str,
        model: str,
        api_key: str = "none",
        timeout: float = 120.0,
        connect_timeout: float = 5.0,
        retry=None,
    ) -> None:
        from generativeaiexamples_tpu_torch.resilience.retry import RetryPolicy

        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.read_timeout = float(timeout)
        self.connect_timeout = float(connect_timeout)
        self.retry = retry if retry is not None else RetryPolicy(name="openai-llm")

    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        from generativeaiexamples_tpu_torch.core.httpclient import HTTPStatusError

        if isinstance(exc, HTTPStatusError):
            return exc.status >= 500
        return isinstance(exc, Exception)

    def stream(
        self,
        messages: Sequence[ChatTurn],
        *,
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        stop: Sequence[str] = (),
        session_id: str = "",
    ) -> Iterator[str]:
        from generativeaiexamples_tpu_torch.core.httpclient import post_json
        from generativeaiexamples_tpu_torch.core.tracing import inject_trace_headers
        from generativeaiexamples_tpu_torch.resilience.metrics import record_retry

        payload = {
            "model": self.model,
            "messages": [{"role": r, "content": c} for r, c in messages],
            "temperature": temperature,
            "top_p": top_p,
            "max_tokens": max_tokens,
            "stream": True,
        }
        if stop:
            payload["stop"] = list(stop)
        if session_id:
            # Conversation key: the serving engine parks this session's KV
            # and prefills only the new suffix next turn (prefix cache).
            payload["user"] = session_id
        headers = {"Authorization": f"Bearer {self.api_key}"}
        # W3C trace propagation: the engine joins the chain server's
        # request trace.
        inject_trace_headers(headers)
        deadline = current_deadline()

        def attempt_once() -> Iterator[str]:
            connect, read = self.connect_timeout, self.read_timeout
            if deadline is not None and not deadline.is_unlimited:
                connect, read = deadline.cap_timeout(connect), deadline.cap_timeout(read)
            with post_json(
                f"{self.base_url}/chat/completions", payload, headers, connect_timeout=connect, read_timeout=read
            ) as resp:
                for raw in resp:
                    line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
                    if not line.startswith("data: "):
                        continue
                    data = line[len("data: ") :]
                    if data.strip() == "[DONE]":
                        break
                    try:
                        delta = json.loads(data)["choices"][0]["delta"]
                    except (KeyError, IndexError, json.JSONDecodeError):
                        continue
                    content = delta.get("content")
                    if content:
                        yield content

        def gen() -> Iterator[str]:
            attempt = 0
            while True:
                attempt += 1
                if deadline is not None:
                    deadline.check(f"openai-llm attempt {attempt}")
                yielded = False
                try:
                    for chunk in attempt_once():
                        yielded = True
                        yield chunk
                    return
                except DeadlineExceeded:
                    raise
                except Exception as exc:
                    retry_ok = not yielded and attempt < self.retry.max_attempts and self._retryable(exc)
                    if retry_ok:
                        pause = self.retry.backoff_s(attempt, random)
                        if deadline is None or pause < deadline.remaining_s():
                            record_retry()
                            logger.warning(
                                "openai-llm: attempt %d/%d failed (%s); retrying",
                                attempt, self.retry.max_attempts, type(exc).__name__,
                            )
                            time.sleep(pause)
                            continue
                    raise GenerationError(f"generation failed: {exc}") from exc

        return gen()


class ScriptedChatLLM:
    """Test double: plays back canned responses in order (agent loops need
    multi-call scripts the echo backend can't express)."""

    def __init__(self, responses: Sequence[str]) -> None:
        self._responses = list(responses)
        self.calls: list[list[ChatTurn]] = []

    def stream(self, messages: Sequence[ChatTurn], **_: Any) -> Iterator[str]:
        self.calls.append(list(messages))
        text = self._responses.pop(0) if self._responses else ""

        def gen() -> Iterator[str]:
            if text:
                yield text

        return gen()


class EchoChatLLM:
    """Deterministic hermetic backend: replies with a canned, prompt-derived
    answer so pipelines and SSE framing are testable without a model."""

    def __init__(self, prefix: str = "ECHO") -> None:
        self.prefix = prefix

    def stream(
        self,
        messages: Sequence[ChatTurn],
        *,
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        stop: Sequence[str] = (),
        session_id: str = "",
    ) -> Iterator[str]:
        system = next((c for r, c in messages if r == "system"), "")
        user = next((c for r, c in reversed(list(messages)) if r == "user"), "")
        reply = f"{self.prefix}[{user}]"
        if system:
            reply += f" ctx:{len(system)}ch"
        words = reply.split(" ")
        limited = words[: max_tokens if max_tokens > 0 else len(words)]

        def gen() -> Iterator[str]:
            for i, w in enumerate(limited):
                yield (w if i == 0 else " " + w)

        return _apply_stop(gen(), stop)
