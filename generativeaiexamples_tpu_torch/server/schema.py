"""API data types of the chain server (port of the JAX package's
``server/schema.py``), as dataclasses with hand-written validation.

Field for field the reference's pydantic models, with their bounds and
defaults: ``Prompt`` in, ``ChainResponse`` chunks out with a ``[DONE]``
finish_reason sentinel, ``DocumentSearch``/``DocumentSearchResponse``,
``DocumentsResponse``, ``HealthResponse``, the bulk-ingest job models
(``BulkIngestResponse``, ``IngestJobStatus``, ``IngestStatusResponse``)
and the ``/debug`` models (``RequestTraceStage``, ``RequestTraceRecord``,
``DebugRequestsResponse``, ``TimeseriesSeries``,
``DebugTimeseriesResponse``).  Each model validates on
construction, as a pydantic model does (so an assistant ``Message`` is
sanitized too), and ``parse`` builds one from decoded JSON with pydantic's
lax coercions (``"0.5"`` for a float, ``"yes"`` for a bool, ``5.0`` for an
int); unknown keys are ignored.  A bad value raises
:class:`ValidationError`, whose text is the 422's ``detail`` (its wording
is not pydantic's).  ``to_json`` gives the bytes of pydantic's
``model_dump_json()``: the models' field order, compact separators and
UTF-8 text (no ASCII escapes).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Dict, List, Optional

_TAG_RE = re.compile(r"<[^>]*>")
MAX_CONTENT_LEN = 131072  # request cap, reference server.py:63,123

_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))


class ValidationError(ValueError):
    """A request body that does not fit the schema (answered with 422)."""


def sanitize(text: str) -> str:
    """Strip HTML tags from user-supplied text."""
    return _TAG_RE.sub("", text)


def _str(value: Any, loc: str, max_length: int) -> str:
    if not isinstance(value, str):
        raise ValidationError(f"{loc}: Input should be a valid string")
    if len(value) > max_length:
        raise ValidationError(f"{loc}: String should have at most {max_length} characters")
    return value


def _number(value: Any, loc: str) -> float:
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value.strip())
        except ValueError:
            pass
    raise ValidationError(f"{loc}: Input should be a valid number")


def _bounded(value: float, loc: str, ge: float, le: float) -> None:
    # NaN fails both comparisons, as in pydantic.
    if not value >= ge:
        raise ValidationError(f"{loc}: Input should be greater than or equal to {ge}")
    if not value <= le:
        raise ValidationError(f"{loc}: Input should be less than or equal to {le}")


def _float_min(value: Any, loc: str, ge: float) -> float:
    out = _number(value, loc)
    if not out >= ge:
        raise ValidationError(f"{loc}: Input should be greater than or equal to {ge}")
    return out


def _float(value: Any, loc: str, ge: float, le: float) -> float:
    out = _number(value, loc)
    _bounded(out, loc, ge, le)
    return out


def _int(value: Any, loc: str, ge: int, le: int) -> int:
    if isinstance(value, int):  # bool included
        out = int(value)
    else:
        num = _number(value, loc)
        if not math.isfinite(num) or num != int(num):
            raise ValidationError(f"{loc}: Input should be a valid integer")
        out = int(num)
    _bounded(out, loc, ge, le)
    return out


def _count(value: Any, loc: str) -> int:
    """A non-negative integer (pydantic's ``int`` with ``ge=0``)."""
    return _int(value, loc, 0, 2**63 - 1)


def _dict(value: Any, loc: str) -> dict:
    if not isinstance(value, dict):
        raise ValidationError(f"{loc}: Input should be a valid dictionary")
    return value


def _bool(value: Any, loc: str) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str):
        low = value.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
    raise ValidationError(f"{loc}: Input should be a valid boolean")


def _list(value: Any, loc: str, max_length: int) -> list:
    if not isinstance(value, (list, tuple)):
        raise ValidationError(f"{loc}: Input should be a valid list")
    if len(value) > max_length:
        raise ValidationError(f"{loc}: List should have at most {max_length} items")
    return list(value)


def _str_list(value: Any, loc: str, max_length: int) -> List[str]:
    return [_str(v, f"{loc}.{i}", 2**31) for i, v in enumerate(_list(value, loc, max_length))]


def _model(cls, value: Any, loc: str):
    if isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        raise ValidationError(f"{loc}: Input should be a valid dictionary or instance of {cls.__name__}")
    return cls.parse(value, loc)


class _Model:
    """Construction from decoded JSON and pydantic-compatible dumps."""

    @classmethod
    def parse(cls, data: Any, loc: str = ""):
        """Build from a decoded JSON object: unknown keys are ignored, a
        missing required field (one without a default) is an error."""
        if not isinstance(data, dict):
            raise ValidationError(f"{loc or cls.__name__}: Input should be a valid dictionary")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kwargs[f.name] = data[f.name]
            elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise ValidationError(f"{loc + '.' if loc else ''}{f.name}: Field required")
        try:
            return cls(**kwargs)
        except ValidationError as exc:
            raise ValidationError(f"{loc}.{exc}" if loc else str(exc)) from None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """pydantic's ``model_dump_json()``: field order, no spaces, UTF-8."""
        return json.dumps(self.to_dict(), ensure_ascii=False, separators=(",", ":"))


@dataclasses.dataclass
class Message(_Model):
    """One chat turn."""

    role: str = "user"
    content: str = ""

    def __post_init__(self) -> None:
        role = sanitize(_str(self.role, "role", 256)).lower()
        if role not in ("user", "assistant", "system"):
            raise ValidationError("role: Value error, Role must be one of 'user', 'assistant', or 'system'")
        self.role = role
        self.content = sanitize(_str(self.content, "content", MAX_CONTENT_LEN))


@dataclasses.dataclass
class Prompt(_Model):
    """/generate request body (``messages`` and ``use_knowledge_base`` are
    required)."""

    messages: List[Message]
    use_knowledge_base: bool
    temperature: float = 0.2
    top_p: float = 0.7
    max_tokens: int = 1024
    stop: List[str] = dataclasses.field(default_factory=list)
    # Optional conversation key (extension over the reference schema):
    # threads through to the engine's KV prefix cache.
    session_id: str = ""
    # Named collection to retrieve from; empty or "default" uses the
    # singleton store.
    collection: str = ""

    def __post_init__(self) -> None:
        self.messages = [
            _model(Message, m, f"messages.{i}") for i, m in enumerate(_list(self.messages, "messages", 50000))
        ]
        self.use_knowledge_base = _bool(self.use_knowledge_base, "use_knowledge_base")
        self.temperature = _float(self.temperature, "temperature", 0.0, 1.0)
        self.top_p = _float(self.top_p, "top_p", 0.1, 1.0)
        self.max_tokens = _int(self.max_tokens, "max_tokens", 0, 1024)
        self.stop = _str_list(self.stop, "stop", 256)
        self.session_id = _str(self.session_id, "session_id", 256)
        self.collection = sanitize(_str(self.collection, "collection", 256))


@dataclasses.dataclass
class ChainResponseChoices(_Model):
    index: int = 0
    message: Message = dataclasses.field(default_factory=lambda: Message(role="assistant", content=""))
    finish_reason: str = ""

    def __post_init__(self) -> None:
        self.index = _int(self.index, "index", 0, 256)
        self.message = _model(Message, self.message, "message")
        self.finish_reason = _str(self.finish_reason, "finish_reason", 4096)


@dataclasses.dataclass
class ChainResponse(_Model):
    """One SSE chunk of /generate."""

    id: str = ""
    choices: List[ChainResponseChoices] = dataclasses.field(default_factory=list)
    # Degradation-ladder stages that fired while serving this request;
    # populated on the final [DONE] chunk.
    degraded: List[str] = dataclasses.field(default_factory=list)
    # Result-cache disposition, populated on the final [DONE] chunk.
    cached: bool = False
    cache_tier: str = ""

    def __post_init__(self) -> None:
        self.id = _str(self.id, "id", 100000)
        self.choices = [
            _model(ChainResponseChoices, c, f"choices.{i}") for i, c in enumerate(_list(self.choices, "choices", 256))
        ]
        self.degraded = _str_list(self.degraded, "degraded", 16)
        self.cached = _bool(self.cached, "cached")
        self.cache_tier = _str(self.cache_tier, "cache_tier", 32)


@dataclasses.dataclass
class DocumentSearch(_Model):
    """/search request body."""

    query: str = ""
    top_k: int = 4
    # Named collection to search; empty or "default" uses the singleton.
    collection: str = ""

    def __post_init__(self) -> None:
        self.query = _str(self.query, "query", MAX_CONTENT_LEN)
        self.top_k = _int(self.top_k, "top_k", 0, 25)
        self.collection = sanitize(_str(self.collection, "collection", 256))


@dataclasses.dataclass
class DocumentChunk(_Model):
    content: str = ""
    filename: str = ""
    score: float = 0.0

    def __post_init__(self) -> None:
        self.content = _str(self.content, "content", MAX_CONTENT_LEN)
        self.filename = _str(self.filename, "filename", 4096)
        self.score = _number(self.score, "score")


@dataclasses.dataclass
class DocumentSearchResponse(_Model):
    chunks: List[DocumentChunk]
    degraded: List[str] = dataclasses.field(default_factory=list)
    cached: bool = False
    cache_tier: str = ""

    def __post_init__(self) -> None:
        self.chunks = [_model(DocumentChunk, c, f"chunks.{i}") for i, c in enumerate(_list(self.chunks, "chunks", 2**31))]
        self.degraded = _str_list(self.degraded, "degraded", 16)
        self.cached = _bool(self.cached, "cached")
        self.cache_tier = _str(self.cache_tier, "cache_tier", 32)


@dataclasses.dataclass
class DocumentsResponse(_Model):
    documents: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.documents = _str_list(self.documents, "documents", 2**31)


@dataclasses.dataclass
class HealthResponse(_Model):
    message: str = ""
    # "ok", or "degraded" while an SLO fast-burn alert is firing.
    status: str = "ok"
    # Circuit-breaker state per dependency ("closed"/"half_open"/"open").
    breakers: Dict[str, str] = dataclasses.field(default_factory=dict)
    # SLO verdict summary from the burn-rate engine.
    slo: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.message = _str(self.message, "message", 4096)
        self.status = _str(self.status, "status", 16)
        if not isinstance(self.breakers, dict) or not isinstance(self.slo, dict):
            raise ValidationError("breakers, slo: Input should be a valid dictionary")


@dataclasses.dataclass
class BulkIngestResponse(_Model):
    """202 body of POST /documents/bulk: the background job handle."""

    job_id: str = ""
    files_received: int = 0
    message: str = ""

    def __post_init__(self) -> None:
        self.job_id = _str(self.job_id, "job_id", 64)
        self.files_received = _count(self.files_received, "files_received")
        self.message = _str(self.message, "message", 4096)


@dataclasses.dataclass
class IngestJobStatus(_Model):
    """Progress of one bulk-ingestion job (GET /documents/status)."""

    job_id: str = ""
    status: str = ""
    files_total: int = 0
    files_done: int = 0
    files_failed: int = 0
    chunks_total: int = 0
    chunks_ingested: int = 0
    docs_per_sec: float = 0.0
    errors: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.job_id = _str(self.job_id, "job_id", 64)
        self.status = _str(self.status, "status", 32)
        for name in ("files_total", "files_done", "files_failed", "chunks_total", "chunks_ingested"):
            setattr(self, name, _count(getattr(self, name), name))
        self.docs_per_sec = _number(self.docs_per_sec, "docs_per_sec")
        self.errors = _str_list(self.errors, "errors", 64)


@dataclasses.dataclass
class IngestStatusResponse(_Model):
    jobs: List[IngestJobStatus] = dataclasses.field(default_factory=list)
    active_jobs: int = 0

    def __post_init__(self) -> None:
        self.jobs = [_model(IngestJobStatus, j, f"jobs.{i}") for i, j in enumerate(_list(self.jobs, "jobs", 2**31))]
        self.active_jobs = _count(self.active_jobs, "active_jobs")


@dataclasses.dataclass
class RequestTraceStage(_Model):
    """One completed hot-path stage inside a request trace."""

    stage: str = ""
    # Offset from the trace's creation, and the stage's wall duration.
    start_ms: float = 0.0
    duration_ms: float = 0.0
    # Facts the stage already computed: cache tier, batch id/size, ...
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.stage = _str(self.stage, "stage", 64)
        self.start_ms = _float_min(self.start_ms, "start_ms", 0.0)
        self.duration_ms = _float_min(self.duration_ms, "duration_ms", 0.0)
        self.attrs = _dict(self.attrs, "attrs")


@dataclasses.dataclass
class RequestTraceRecord(_Model):
    """One completed request in the GET /debug/requests flight recorder."""

    seq: int = 0
    # True when the trace sits in the pinned ring (error or degraded).
    pinned: bool = False
    request_id: str = ""
    route: str = ""
    status: Optional[int] = None
    error: Optional[str] = None
    degraded: List[str] = dataclasses.field(default_factory=list)
    total_ms: float = 0.0
    # Unix wall-clock seconds of the request's start.
    started_at: float = 0.0
    stages: List[RequestTraceStage] = dataclasses.field(default_factory=list)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.seq = _count(self.seq, "seq")
        self.pinned = _bool(self.pinned, "pinned")
        self.request_id = _str(self.request_id, "request_id", 64)
        self.route = _str(self.route, "route", 256)
        if self.status is not None:
            self.status = _int(self.status, "status", -(2**63), 2**63 - 1)
        if self.error is not None:
            self.error = _str(self.error, "error", 512)
        self.degraded = _str_list(self.degraded, "degraded", 16)
        self.total_ms = _float_min(self.total_ms, "total_ms", 0.0)
        self.started_at = _number(self.started_at, "started_at")
        self.stages = [
            _model(RequestTraceStage, st, f"stages.{i}") for i, st in enumerate(_list(self.stages, "stages", 2**31))
        ]
        self.attrs = _dict(self.attrs, "attrs")


@dataclasses.dataclass
class DebugRequestsResponse(_Model):
    requests: List[RequestTraceRecord] = dataclasses.field(default_factory=list)
    count: int = 0

    def __post_init__(self) -> None:
        self.requests = [
            _model(RequestTraceRecord, r, f"requests.{i}") for i, r in enumerate(_list(self.requests, "requests", 2**31))
        ]
        self.count = _count(self.count, "count")


@dataclasses.dataclass
class TimeseriesSeries(_Model):
    """One TSDB series: its kind plus bucket rows, oldest first."""

    kind: str = "value"
    # Bucket rows laid out per the response's ``columns``.
    points: List[List[float]] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.kind = _str(self.kind, "kind", 16)
        self.points = [
            [_number(v, f"points.{i}.{j}") for j, v in enumerate(_list(row, f"points.{i}", 2**31))]
            for i, row in enumerate(_list(self.points, "points", 2**31))
        ]


@dataclasses.dataclass
class DebugTimeseriesResponse(_Model):
    """GET /debug/timeseries: the in-process TSDB's bucketed history."""

    window_s: float = 300.0
    # Layout of every bucket row under ``series.*.points``.
    columns: List[str] = dataclasses.field(default_factory=list)
    series: Dict[str, TimeseriesSeries] = dataclasses.field(default_factory=dict)
    # Every series the process knows, for discovery (unfiltered).
    names: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.window_s = _number(self.window_s, "window_s")
        if not self.window_s > 0.0:
            raise ValidationError("window_s: Input should be greater than 0.0")
        self.columns = _str_list(self.columns, "columns", 2**31)
        self.series = {
            _str(k, "series", 2**31): _model(TimeseriesSeries, v, f"series.{k}")
            for k, v in _dict(self.series, "series").items()
        }
        self.names = _str_list(self.names, "names", 2**31)
