"""Intent-routed answer chains over a live transcript (port of
``streaming/chains.py``).

Parity target: ``fm-asr-streaming-rag/chain-server/chains.py:67-186`` —
classify the user's question, then answer by the matching strategy:

* ``recent``    — "what was just said?": context = last-N-seconds chunks
                  from the timestamp database.
* ``past``      — "what was said around 14:05 / 20 minutes ago?": an
                  LLM-extracted time window -> database window query.
* ``relevance`` — topical question: vector retrieval over transcripts.
* ``summarize`` — rolling summary of the recent window.

All strategies end in the same context-stuffed chat completion; the LLM,
embedder, and stores come in via the constructor so the whole router runs
hermetically (scripted LLM / hash embedder) or on the card (``GPUChatLLM``,
``GPUEmbedder``, ``GPUVectorStore``).
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Iterator, Optional, Sequence

from generativeaiexamples_tpu_torch.chains.llm import ChatLLM
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk, VectorStore
from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase

logger = get_logger(__name__)

INTENTS = ("recent", "past", "relevance", "summarize")

INTENT_PROMPT = """\
Classify the user's question about a live radio transcript into exactly one
of these intents:
- recent: asks about what was said just now / in the last few minutes
- past: asks about a specific earlier time ("around 2pm", "20 minutes ago")
- relevance: a topical question answerable from any part of the transcript
- summarize: asks for a summary of recent content

Respond with only the intent word.
Question: {question}
"""

TIME_WINDOW_PROMPT = """\
The user asks about a specific time in a transcript. Current unix time is
{now}. Respond with JSON {{"start": <unix seconds>, "end": <unix seconds>}}
for the window they mean (use a 10-minute window when only a point in time
is given). Respond with only the JSON.
Question: {question}
"""

ANSWER_PROMPT = """\
Answer the question using only the transcript excerpts below.

Transcript:
{context}

Question: {question}
"""

SUMMARIZE_PROMPT = """\
Summarize the following live-transcript excerpts in a few sentences.

Transcript:
{context}
"""

_JSON_OBJ = re.compile(r"\{.*\}", re.DOTALL)


class StreamingChains:
    def __init__(
        self,
        llm: ChatLLM,
        embedder,
        store: VectorStore,
        db: TimestampDatabase,
        *,
        top_k: int = 4,
        recent_seconds: float = 600.0,
    ) -> None:
        self.llm = llm
        self.embedder = embedder
        self.store = store
        self.db = db
        self.top_k = top_k
        self.recent_seconds = recent_seconds

    # -- ingestion sink ----------------------------------------------------
    def store_chunk(self, text: str, source: str, t_first: float, t_last: float) -> None:
        """Accumulator sink: timestamp DB + vector store in lockstep."""
        self.db.insert(text, source, t_first, t_last)
        emb = self.embedder.embed_documents([text])
        self.store.add(
            [Chunk(text=text, source=source, metadata={"t_first": t_first, "t_last": t_last})],
            emb,
        )

    # -- routing -----------------------------------------------------------
    def classify_intent(self, question: str) -> str:
        raw = "".join(
            self.llm.stream(
                [("user", INTENT_PROMPT.format(question=question))],
                temperature=0.0,
                max_tokens=8,
            )
        ).strip().lower()
        for intent in INTENTS:
            if intent in raw:
                return intent
        logger.warning("unparseable intent %r; defaulting to relevance", raw)
        return "relevance"

    def answer(
        self, question: str, *, now: Optional[float] = None, **settings: Any
    ) -> Iterator[str]:
        now = time.time() if now is None else now
        intent = self.classify_intent(question)
        logger.info("intent=%s for question %r", intent, question[:80])
        if intent == "recent":
            return self.answer_by_recent(question, now=now, **settings)
        if intent == "past":
            return self.answer_by_past(question, now=now, **settings)
        if intent == "summarize":
            return self.summarize(now=now, **settings)
        return self.answer_by_relevance(question, **settings)

    # -- strategies --------------------------------------------------------
    def _complete(self, prompt: str, **settings: Any) -> Iterator[str]:
        return self.llm.stream([("user", prompt)], **settings)

    def answer_by_recent(
        self, question: str, *, now: float, **settings: Any
    ) -> Iterator[str]:
        rows = self.db.recent(self.recent_seconds, now)
        context = "\n".join(r["text"] for r in reversed(rows)) or "(no transcript yet)"
        return self._complete(
            ANSWER_PROMPT.format(context=context, question=question), **settings
        )

    def answer_by_past(
        self, question: str, *, now: float, **settings: Any
    ) -> Iterator[str]:
        raw = "".join(
            self.llm.stream(
                [("user", TIME_WINDOW_PROMPT.format(now=int(now), question=question))],
                temperature=0.0,
                max_tokens=64,
            )
        )
        start, end = now - self.recent_seconds, now
        m = _JSON_OBJ.search(raw)
        if m:
            try:
                window = json.loads(m.group(0))
                start = float(window.get("start", start))
                end = float(window.get("end", end))
            except (json.JSONDecodeError, TypeError, ValueError):
                logger.warning("unparseable time window %r", raw[:120])
        rows = self.db.window(start, end)
        context = "\n".join(r["text"] for r in rows) or "(nothing in that window)"
        return self._complete(
            ANSWER_PROMPT.format(context=context, question=question), **settings
        )

    def answer_by_relevance(self, question: str, **settings: Any) -> Iterator[str]:
        emb = self.embedder.embed_query(question)
        hits = self.store.search(emb, self.top_k)
        context = "\n".join(h.chunk.text for h in hits) or "(empty index)"
        return self._complete(
            ANSWER_PROMPT.format(context=context, question=question), **settings
        )

    def summarize(self, *, now: float, **settings: Any) -> Iterator[str]:
        rows = self.db.recent(self.recent_seconds, now)
        context = "\n".join(r["text"] for r in reversed(rows)) or "(no transcript yet)"
        return self._complete(SUMMARIZE_PROMPT.format(context=context), **settings)
