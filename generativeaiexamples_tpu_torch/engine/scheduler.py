"""Continuous-batching scheduler (port of ``engine/scheduler.py``, the
non-speculative path, on the contiguous cache or the paged pool).

* **Slot model**: the int8 KV cache holds ``max_batch`` fixed slots; a
  request occupies a slot from prefill to finish.
* **KV layout** (``kv_layout``): ``"contiguous"`` gives each slot a
  ``max_len`` row of the cache; ``"paged"`` maps each slot's tokens to
  pages of a shared pool (``engine.paged_kv``) through a page table.
  Paged prefix reuse is zero-copy: a finished history parks as a
  page-owning segment (the slot frees at once), a hit references the
  segment's pages from a free slot, and the first divergent write into
  a shared page copies only that page.
* **Batched cold prefill**: waiting prompts prefill together into a small
  private cache (cold prefill through the flash kernel), then their rows
  are copied into their slots.
* **Chunked decode**: every decoding slot advances through one decode
  chunk per tick (append-buffer protocol, decode kernel); idle lanes
  compute masked garbage that is never emitted.
* **Chunked prefill**: prompts longer than ``prefill_chunk_tokens`` claim
  a slot and prefill one chunk per tick, interleaved with decode.
* **Prefix cache**: finished slots park their KV under a host-side radix
  index; a prompt sharing a long prefix grafts the cached rows into its
  slot and prefills only the suffix.
* **Pipelined tick**: admission work is dispatched first, the decode
  chunk behind it on the same CUDA stream, and only then does the host
  wait for sampled tokens: no host sync between dispatch and finalize.

The scheduler thread emits tokens through ``on_token`` / ``on_done``
callbacks.  Speculative decoding is not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import host_to_device, resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine.decode import (
    make_decode_chunk_fn,
    make_paged_decode_chunk_fn,
    prepare_cache,
    prepare_paged_pool,
    prepare_params,
)
from generativeaiexamples_tpu_torch.engine.paged_kv import PAGE_EVENTS, num_slot_pages
from generativeaiexamples_tpu_torch.engine.prefix_cache import PrefixCacheIndex
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams, sample
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops.decode_attention import flush_clip_start, paged_slots
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size

logger = get_logger(__name__)

# What the engine server serves with (its command-line defaults); the chain
# server's in-process LLM (``chains/llm.py::GPUChatLLM``) starts from them.
SERVING_DEFAULTS = dict(
    max_batch=32, max_len=2048, decode_chunk_size=8, prefill_chunk_tokens=256,
    prefix_cache="shared", kv_layout="contiguous", seed=0,
)


@dataclasses.dataclass
class Request:
    token_ids: list[int]
    sampling: SamplingParams
    on_token: Callable[[int], None]
    on_done: Callable[[str], None]  # finish_reason
    eos_id: Optional[int] = None
    id: str = ""
    # Conversation key for KV prefix reuse across turns.
    session_id: str = ""
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    length: int = 0  # valid cache entries
    emitted: int = 0
    # Parked state (prefix cache): ``cached`` marks a slot whose rows still
    # hold reusable KV for ``history``.
    session_id: str = ""
    cached: bool = False
    history: list[int] = dataclasses.field(default_factory=list)
    parked_at: float = 0.0
    # Chunked prefill: next prompt position to prefill (None = not warming).
    warm_pos: Optional[int] = None


class Stats:
    """Served-token counters surfaced by /metrics."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.requests_total = 0
        self.tokens_total = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        # Recent time-to-first-token samples (seconds) for percentiles.
        self.ttft_recent: collections.deque = collections.deque(maxlen=4096)
        self.active_slots = 0
        self.queued = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.shared_prefix_hits = 0
        self.prefill_chunks = 0
        self.tick_count = 0
        self.prefill_s = 0.0
        self.prefill_rows = 0
        self.decode_s = 0.0
        self.decode_chunks = 0
        self.tick_ms_ewma = 0.0
        # Paged KV pool gauges (zero under the contiguous cache): total
        # pages, free-list depth, pages held by parked segments, pages
        # shared by more than one owner (refcount > 1, COW-armed), pages
        # privatized by copy-on-write, and parked segments evicted under
        # pool pressure.
        self.kv_pages_total = 0
        self.kv_pages_free = 0
        self.kv_pages_parked = 0
        self.kv_pages_shared = 0
        self.kv_cow_breaks = 0
        self.kv_page_evictions = 0

    def note_ttft(self, seconds: float) -> None:
        """Record one request's time to first token (caller holds lock)."""
        self.ttft_sum += seconds
        self.ttft_count += 1
        self.ttft_recent.append(seconds)

    def snapshot(self) -> dict:
        with self.lock:
            recent = sorted(self.ttft_recent)
            return {
                "requests_total": self.requests_total,
                "tokens_total": self.tokens_total,
                "tick_count": self.tick_count,
                "prefill_s": round(self.prefill_s, 3),
                "prefill_rows": self.prefill_rows,
                "decode_s": round(self.decode_s, 3),
                "decode_chunks": self.decode_chunks,
                "ttft_avg_ms": self.ttft_sum / self.ttft_count * 1000 if self.ttft_count else 0.0,
                "ttft_p50_ms": recent[len(recent) // 2] * 1000 if recent else 0.0,
                "ttft_count": self.ttft_count,
                "active_slots": self.active_slots,
                "queued": self.queued,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "shared_prefix_hits": self.shared_prefix_hits,
                "prefill_chunks": self.prefill_chunks,
                "tick_ms_ewma": round(self.tick_ms_ewma, 3),
                "kv_pages_total": self.kv_pages_total,
                "kv_pages_free": self.kv_pages_free,
                "kv_pages_parked": self.kv_pages_parked,
                "kv_pages_shared": self.kv_pages_shared,
                "kv_cow_breaks": self.kv_cow_breaks,
                "kv_page_evictions": self.kv_page_evictions,
            }


class Scheduler:
    """Continuous batching over a fixed-slot int8 KV cache.

    Runs on ``device`` (default ``cuda``; pass ``device="cpu"`` for the
    plain versions of the kernels).  ``params`` are the port's params
    (``engine.weights.params_from_numpy`` or
    ``engine.decode.init_random_int8_params``; ``None`` builds random int8
    weights), laid out once here for the W8A8 kernel
    (``engine.decode.prepare_params``).

    ``kv_layout="paged"`` serves from the paged pool: ``kv_page_size``
    tokens per page (a power of two), ``kv_pool_pages`` pages (floored at
    ``max_batch * n_slot_pages + 1``), and ``kv_page_low_water`` free pages
    below which a tick evicts least-recently-used parked segments
    (default: one slot's worth).
    """

    # Minimum shared-prefix length for the suffix-prefill path.
    MIN_PREFIX = 32
    # Per-batch admission cap (a power of two: batches bucket to one).
    ADMIT_CAP = 64
    # Per-tick admission cap in prompt tokens: bounds how long running
    # lanes wait behind one tick's prefill.
    ADMIT_TOKEN_BUDGET = 32768

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params=None,
        *,
        device=None,
        max_batch: int = 8,
        max_len: Optional[int] = None,
        decode_chunk_size: int = 8,
        seed: int = 0,
        prefill_chunk_tokens: Optional[int] = 256,
        prefix_cache: str = "shared",
        kv_layout: str = "contiguous",
        kv_page_size: int = 64,
        kv_pool_pages: Optional[int] = None,
        kv_page_low_water: Optional[int] = None,
    ) -> None:
        self.device = resolve_device(device)
        if cfg.kv_dtype != "int8":
            raise ValueError("the port serves the int8 KV cache: use kv_dtype='int8'")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout mode {kv_layout!r}")
        if kv_page_size < 1 or (kv_page_size & (kv_page_size - 1)):
            raise ValueError(f"kv_page_size must be a power of two, got {kv_page_size}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.decode_chunk_size = decode_chunk_size
        if prefix_cache not in ("shared", "session", "off"):
            raise ValueError(f"unknown prefix_cache mode {prefix_cache!r}")
        self.stats = Stats()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.kv_layout = kv_layout
        self.kv_page_size = int(kv_page_size)
        self._pool = None
        # Parked prefix segments (paged mode) hold pages, not slots; their
        # ids start at max_batch so they never collide with slot ids.
        self._next_seg = max_batch
        self._session_segs: dict[str, int] = {}
        self._seg_sessions: dict[int, str] = {}
        with torch.inference_mode():
            self.params = prepare_params(cfg, params, device=self.device, generator=self._gen)
            if kv_layout == "paged":
                self._pool = prepare_paged_pool(
                    cfg, max_batch, self.max_len, self.kv_page_size, kv_pool_pages, device=self.device
                )
                # The pool's leaves are updated in place (COW copies
                # included), so this alias stays valid for the pool's life.
                self._cache = self._pool.leaves
            else:
                self._cache = prepare_cache(cfg, max_batch, self.max_len, self.device)
        self.matmul_kernel = "w8a8"  # the one projection path the port serves
        if self._pool is not None:
            self._decode_chunk = make_paged_decode_chunk_fn(cfg, self.max_len, self.kv_page_size)
            self._kv_low_water = (
                int(kv_page_low_water) if kv_page_low_water is not None else self._pool.n_slot_pages
            )
            # Pages promised to batch admissions whose allocation happens at
            # the batch's dispatch later this tick.
            self._kv_pages_reserved = 0
        else:
            self._decode_chunk = make_decode_chunk_fn(cfg, self.max_len)
        self.prefix_cache = prefix_cache
        self._prefix_index = PrefixCacheIndex()
        if self._pool is not None:
            self._publish_pool_gauges()
        if prefill_chunk_tokens is not None and prefill_chunk_tokens <= 0:
            prefill_chunk_tokens = None
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # Pipelined ticks pin not-yet-decoding lanes at max_len - 1, whose
        # flush garbage-writes [max_len - chunk, max_len): admitted prompt
        # KV must stay strictly below it.
        self._admit_limit = flush_clip_start(self.max_len, self.decode_chunk_size)
        if self._admit_limit < 2:
            raise ValueError(
                f"max_len {self.max_len} leaves no admissible prompt room "
                f"beside decode_chunk_size {self.decode_chunk_size}"
            )
        self._slots = [_Slot() for _ in range(max_batch)]
        self._cancelled: set[str] = set()
        self._cancel_lock = threading.Lock()
        self._cur_tok = np.zeros((max_batch,), dtype=np.int32)
        self._tok_count = 0
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._backlog: "collections.deque[Request]" = collections.deque()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- device helpers ----------------------------------------------------

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device without a host sync (pinned, non-blocking)."""
        return host_to_device(torch.from_numpy(np.ascontiguousarray(arr)), self.device)

    def _full(self, value, dtype) -> torch.Tensor:
        return torch.full((1,), value, dtype=dtype, device=self.device)

    # -- device ops ----------------------------------------------------------

    def _prefill_some(self, tokens, lengths, temp, top_p, top_k):
        """Cold-prefill a batch of prompts into a fresh small cache; returns
        (small cache, sampled first tokens on the device)."""
        b, s = tokens.shape
        small = llama.init_kv_cache(self.cfg, b, s, device=self.device)
        positions = torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)
        hidden, small = llama.forward(
            self.params, self.cfg, tokens.long(), positions, small, lengths, cold_prefill=True
        )
        last = hidden[torch.arange(b, device=self.device), (lengths.long() - 1).clamp(min=0)]
        lg = llama.logits(self.params, last[:, None, :])[:, 0]
        return small, sample(lg, self._gen, temp, top_p, top_k)

    def _graft_rows(self, small, slots: torch.Tensor) -> None:
        """Copy the small cache's rows 0..k-1 into their slots."""
        k = slots.shape[0]
        for big, sm in zip(self._cache, small):
            s = sm.shape[3]
            big[:, :, slots, :s] = sm[:, :, :k]

    def _graft_rows_paged(self, small, phys: torch.Tensor) -> None:
        """Paged twin of :meth:`_graft_rows`: the small cache's rows
        0..k-1 scatter to the physical pool slots ``phys`` (k, s) computed
        from each slot's page table.  Padded tail positions map through
        unowned entries to the garbage page."""
        k = phys.shape[0]
        for big, sm in zip(self._cache, small):
            big[:, :, phys] = sm[:, :, :k]

    def _prefill_suffix(self, tokens, start: int, suffix_len: int, slot: int, sampling, kv_bucket: int):
        """Warm-prefill ``tokens`` (1, s) at positions ``start..`` into slot
        ``slot``'s rows, attending over the slot's cached prefix.  In paged
        mode the pages covering ``[start, start + suffix_len)`` are made
        private first (a grafted boundary page is copied), and the forward
        writes and reads through the slot's table row."""
        s = tokens.shape[1]
        positions = start + torch.arange(s, dtype=torch.int32, device=self.device)[None, :]
        if self._pool is not None:
            self._pool.make_writable(slot, start, start + suffix_len)
            hidden, _ = llama.forward(
                self.params, self.cfg, tokens.long(), positions, self._cache,
                self._full(start + suffix_len, torch.int32), kv_bucket=kv_bucket,
                page_table=self._pool.device_table()[slot : slot + 1],
                page_tokens=self._pool.page_tokens, pages_len=self.max_len,
            )
        else:
            row = tuple(c[:, :, slot : slot + 1] for c in self._cache)
            hidden, _ = llama.forward(
                self.params, self.cfg, tokens.long(), positions, row,
                self._full(start + suffix_len, torch.int32), kv_bucket=kv_bucket,
            )
        last = hidden[0, max(suffix_len - 1, 0)]
        lg = llama.logits(self.params, last[None, None, :])[:, 0]
        temp, top_p, top_k = sampling
        return sample(lg, self._gen, temp, top_p, top_k)

    def _graft_prefix(self, src: int, dst: int, n: int) -> None:
        """Copy the first ``n`` cache positions of slot ``src`` into ``dst``
        (over-copy past the shared prefix is harmless: the destination
        rewrites those positions before any mask exposes them).  The copy
        is device work, so it counts in ``device_graft_dispatch``: a paged
        graft must leave that count flat."""
        PAGE_EVENTS["device_graft_dispatch"] += 1
        for buf in self._cache:
            m = min(n, buf.shape[3])
            buf[:, :, dst, :m] = buf[:, :, src, :m]

    def _sampling_dev(self, sp: SamplingParams):
        return (
            self._full(sp.temperature, torch.float32),
            self._full(sp.top_p, torch.float32),
            self._full(sp.top_k, torch.int32),
        )

    # -- public API --------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue a request (the queue is unbounded)."""
        request.submitted_at = time.perf_counter()
        with self.stats.lock:
            self.stats.queued += 1
        self._pending.put(request)

    def cancel(self, request_id: str) -> None:
        """Stop generating for a request; its slot frees at the next chunk
        boundary and ``on_done("cancelled")`` fires."""
        if not request_id:
            return
        with self._cancel_lock:
            self._cancelled.add(request_id)

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    @property
    def max_prompt_len(self) -> int:
        """The longest prompt admitted whole: a longer one is clipped to its
        tail (``_clip_prompt``)."""
        return self._admit_limit - 1

    def healthy(self) -> bool:
        """False iff the tick thread died while meant to be running."""
        return self._thread is None or not self._running or self._thread.is_alive()

    # -- internals ---------------------------------------------------------

    def _is_cancelled(self, request_id: str) -> bool:
        with self._cancel_lock:
            if request_id in self._cancelled:
                self._cancelled.discard(request_id)
                return True
            return False

    def _drop_if_cancelled(self, req: Request) -> bool:
        if not (req.id and self._is_cancelled(req.id)):
            return False
        with self.stats.lock:
            self.stats.queued -= 1
        try:
            req.on_done("cancelled")
        except Exception:
            logger.exception("on_done callback failed")
        return True

    def _next_pending(self) -> Optional[Request]:
        if self._backlog:
            return self._backlog.popleft()
        try:
            return self._pending.get_nowait()
        except queue.Empty:
            return None

    def _flush_tokens(self) -> None:
        if self._tok_count:
            with self.stats.lock:
                self.stats.tokens_total += self._tok_count
                self._tok_count = 0

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s.request is None and not s.cached]

    def _reclaim_parked(self, n: int) -> list[int]:
        """Evict up to ``n`` parked prefix segments, oldest first, never one
        pinned by an in-flight graft."""
        parked = sorted(
            (
                i
                for i, s in enumerate(self._slots)
                if s.request is None and s.cached and not self._prefix_index.pinned(i)
            ),
            key=lambda i: self._slots[i].parked_at,
        )
        out = []
        for i in parked[:n]:
            self._unpark(i)
            out.append(i)
        return out

    def _unpark(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        self._prefix_index.remove(slot_idx)
        slot.session_id = ""
        slot.cached = False
        slot.history = []
        slot.parked_at = 0.0
        slot.length = 0
        slot.warm_pos = None

    def _park_segment(self, session_id: str, history: list[int], pages: list[int]) -> int:
        """Register a finished history as a page-owning parked segment
        (paged mode).  A session's previous segment is dropped first (the
        new turn's history extends it)."""
        seg = self._next_seg
        self._next_seg += 1
        if session_id:
            stale = self._session_segs.pop(session_id, None)
            if stale is not None:
                self._drop_segment(stale)
            self._session_segs[session_id] = seg
            self._seg_sessions[seg] = session_id
        self._prefix_index.insert(seg, history, pages=pages)
        return seg

    def _drop_segment(self, seg: int) -> None:
        """Remove a parked segment and release its page references (pages
        shared with live slots survive on their refcounts)."""
        pages = self._prefix_index.pages(seg)
        self._prefix_index.remove(seg)
        sid = self._seg_sessions.pop(seg, None)
        if sid is not None and self._session_segs.get(sid) == seg:
            del self._session_segs[sid]
        if pages and self._pool is not None:
            self._pool.release(pages)

    def _publish_pool_gauges(self) -> None:
        pool = self._pool
        with self.stats.lock:
            self.stats.kv_pages_total = pool.total_pages
            self.stats.kv_pages_free = pool.pages_free
            self.stats.kv_pages_parked = self._prefix_index.total_pages()
            self.stats.kv_pages_shared = pool.pages_shared
            self.stats.kv_cow_breaks = pool.cow_breaks

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s.request is not None and s.warm_pos is None]

    def _warming(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s.request is not None and s.warm_pos is not None]

    def _clip_prompt(self, req: Request) -> None:
        """Truncate an over-long prompt to the admissible bound, keeping
        the tail."""
        if len(req.token_ids) >= self._admit_limit:
            req.token_ids = req.token_ids[-(self._admit_limit - 1) :]

    def _finish(self, slot_idx: int, reason: str) -> None:
        self._flush_tokens()
        slot = self._slots[slot_idx]
        req = slot.request
        slot.request = None
        if (
            req is not None
            and reason in ("stop", "length")
            and (
                (req.session_id and self.prefix_cache != "off")
                or (self.prefix_cache == "shared" and slot.length + slot.emitted > self.MIN_PREFIX)
            )
            # Parked history stays clear of the flush-clip tail zone.
            and slot.length + slot.emitted
            < min(
                flush_clip_start(self.max_len, self.decode_chunk_size),
                self.max_len - max(16, self.decode_chunk_size + 1),
            )
        ):
            # The last sampled token of a length finish was never fed back,
            # so its KV was never written.
            history = list(slot.history) if (reason == "stop" or not slot.emitted) else slot.history[:-1]
            if self._pool is not None:
                # Segment parking: keep exactly the pages the history
                # occupies, hand them to a parked segment, free the slot.
                self._pool.trim(slot_idx, len(history))
                self._park_segment(req.session_id, history, self._pool.detach(slot_idx))
                self._unpark(slot_idx)
            else:
                if req.session_id:
                    for i, s in enumerate(self._slots):
                        if s.session_id == req.session_id and s.request is None:
                            self._unpark(i)  # stale earlier turn of this session
                slot.session_id = req.session_id
                slot.cached = True
                slot.history = history
                slot.length = len(history)
                slot.parked_at = time.monotonic()
                if self.prefix_cache == "shared":
                    self._prefix_index.insert(slot_idx, history)
        else:
            self._unpark(slot_idx)
            if self._pool is not None:
                self._pool.reset_slot(slot_idx)
        slot.emitted = 0
        if req is not None and req.id:
            with self._cancel_lock:
                self._cancelled.discard(req.id)
        if req is not None:
            try:
                req.on_done(reason)
            except Exception:
                logger.exception("on_done callback failed")

    def _admit_many(self, reqs: Sequence[Request], slot_idxs: Sequence[int]) -> None:
        self._admit_finalize(*self._admit_dispatch(reqs, slot_idxs))

    def _admit_dispatch(self, reqs: Sequence[Request], slot_idxs: Sequence[int]) -> tuple:
        """Dispatch a batched cold prefill and the row copies without
        waiting for the device; claims the slots."""
        t_admit0 = time.perf_counter()
        plens = []
        for req in reqs:
            self._clip_prompt(req)
            plens.append(len(req.token_ids))
        pb = bucket_size(len(reqs), minimum=min(4, self.max_batch))
        s = min(bucket_size(max(plens), dense=True), self.max_len)
        tokens = np.zeros((pb, s), dtype=np.int32)
        lengths = np.zeros((pb,), dtype=np.int32)
        temp = np.zeros((pb,), dtype=np.float32)
        top_p = np.ones((pb,), dtype=np.float32)
        top_k = np.zeros((pb,), dtype=np.int32)
        for r, req in enumerate(reqs):
            tokens[r, : plens[r]] = req.token_ids
            lengths[r] = plens[r]
            temp[r] = req.sampling.temperature
            top_p[r] = req.sampling.top_p
            top_k[r] = req.sampling.top_k
        small, tok = self._prefill_some(
            self._h2d(tokens), self._h2d(lengths), self._h2d(temp), self._h2d(top_p), self._h2d(top_k)
        )
        if self._pool is not None:
            # Allocate each admitted slot's pages, then scatter the rows to
            # their physical pool slots.
            for r, slot_idx in enumerate(slot_idxs):
                self._pool.reset_slot(slot_idx)
                self._pool.make_writable(slot_idx, 0, plens[r])
            rows = torch.from_numpy(self._pool.tables[np.asarray(slot_idxs)])
            phys = paged_slots(rows, torch.arange(s).expand(len(slot_idxs), s), self._pool.page_tokens)
            self._graft_rows_paged(small, self._h2d(phys.numpy()))
        else:
            self._graft_rows(small, self._h2d(np.asarray(slot_idxs, dtype=np.int64)))
        for r, (req, slot_idx) in enumerate(zip(reqs, slot_idxs)):
            slot = self._slots[slot_idx]
            slot.request = req
            slot.length = plens[r]
            slot.emitted = 0
            slot.history = list(req.token_ids)
        return reqs, slot_idxs, tok, t_admit0

    def _admit_finalize(self, reqs, slot_idxs, tok, t_admit0: float) -> None:
        """Fetch a dispatched admission batch's first tokens and emit them."""
        tok_host = tok.cpu().numpy()
        now = time.perf_counter()
        for r, (req, slot_idx) in enumerate(zip(reqs, slot_idxs)):
            req.first_token_at = now
            with self.stats.lock:
                self.stats.queued -= 1
                self.stats.requests_total += 1
                self.stats.note_ttft(req.first_token_at - req.submitted_at)
            self._handle_token(slot_idx, int(tok_host[r]))
        with self.stats.lock:
            self.stats.prefill_s += time.perf_counter() - t_admit0
            self.stats.prefill_rows += len(reqs)

    def _find_parked(self, req: Request) -> tuple[int, int]:
        """This session's parked slot (contiguous) or segment (paged) whose
        history is a long-enough prefix of the prompt: (slot_or_seg,
        prefix_len) or (-1, 0)."""
        if not req.session_id:
            return -1, 0
        if self._pool is not None:
            seg = self._session_segs.get(req.session_id)
            if seg is None:
                return -1, 0
            n = 0
            for a, b in zip(self._prefix_index.tokens(seg) or (), req.token_ids):
                if a != b:
                    break
                n += 1
            return (seg, n) if n >= self.MIN_PREFIX else (-1, 0)
        for i, s in enumerate(self._slots):
            if s.request is None and s.session_id == req.session_id:
                n = 0
                for a, b in zip(s.history, req.token_ids):
                    if a != b:
                        break
                    n += 1
                if n >= self.MIN_PREFIX:
                    return i, n
                return -1, 0
        return -1, 0

    def _find_shared(self, req: Request) -> tuple[int, int]:
        """The parked segment sharing the longest prefix with the prompt."""
        if self.prefix_cache != "shared":
            return -1, 0
        seg, common = self._prefix_index.match(req.token_ids)
        if seg is None:
            return -1, 0
        common = min(common, len(req.token_ids) - 1)
        if common < self.MIN_PREFIX:
            return -1, 0
        if self._pool is None:
            slot = self._slots[seg]
            if slot.request is not None or not slot.cached:
                self._prefix_index.remove(seg)  # stale entry: never graft live rows
                return -1, 0
        return seg, common

    def _suffix_dispatch(self, req: Request, slot_idx: int, common: int):
        """Dispatch a suffix prefill into ``slot_idx`` (which holds KV for
        ``common`` prompt tokens) without waiting; claims the slot."""
        t0 = time.perf_counter()
        plen = len(req.token_ids)
        suffix = req.token_ids[common:]
        s = min(bucket_size(len(suffix), minimum=16, dense=True), self.max_len)
        tokens = np.zeros((1, s), dtype=np.int32)
        tokens[0, : len(suffix)] = suffix
        kv_bucket = bucket_size(common + s, maximum=self.max_len, dense=True)
        tok = self._prefill_suffix(
            self._h2d(tokens), common, len(suffix), slot_idx, self._sampling_dev(req.sampling), kv_bucket
        )
        slot = self._slots[slot_idx]
        slot.request = req
        slot.length = plen
        slot.emitted = 0
        slot.history = list(req.token_ids)
        slot.warm_pos = None
        return req, slot_idx, tok, t0

    def _suffix_finalize(self, req, slot_idx, tok, t0) -> None:
        tok_host = int(tok.cpu()[0])
        req.first_token_at = time.perf_counter()
        with self.stats.lock:
            self.stats.requests_total += 1
            self.stats.note_ttft(req.first_token_at - req.submitted_at)
            self.stats.prefill_s += req.first_token_at - t0
            self.stats.prefill_rows += 1
        self._handle_token(slot_idx, tok_host)

    def _admit_hit(self, req: Request, slot_idx: int, common: int, *, shared: bool):
        """Admit a prefix-cache hit into ``slot_idx`` (its rows hold the
        first ``common`` tokens' KV): prefill only the suffix, directly or
        by chunked warming.  Returns the finalize callable (None when the
        slot enters warming)."""
        plen = len(req.token_ids)
        common = min(common, plen - 1, self._admit_limit - 2)
        with self.stats.lock:
            self.stats.queued -= 1
            if shared:
                self.stats.shared_prefix_hits += 1
            else:
                self.stats.prefix_hits += 1
            self.stats.prefix_tokens_reused += common
        self._unpark(slot_idx)
        if self.prefill_chunk_tokens and plen - common > self.prefill_chunk_tokens:
            self._claim_warm(req, slot_idx, common)
            fin, _ = self._advance_warm(slot_idx)
            return fin
        t = self._suffix_dispatch(req, slot_idx, common)
        return lambda: self._suffix_finalize(*t)

    def _admit_paged_hit(
        self, req: Request, seg: int, common: int, free: list[int], *, consume: bool, shared: bool
    ) -> tuple[bool, Optional[Callable[[], None]]]:
        """Admit a prefix hit from a parked segment (paged mode): a slot
        taken from ``free`` (the caller's unclaimed slots) references the
        segment's pages (host work only) and only the suffix is
        prefilled.  ``consume`` (session hits) drops the segment after the
        transfer.  Returns ``(admitted, finalize)``; ``(False, None)`` when
        no free slot or pages exist.

        The reference takes ``self._free_slots()[0]`` here, which can be a
        slot the same tick already gave to a pending batch admission (that
        batch claims its slots only at dispatch); taking from the caller's
        list cannot."""
        plen = len(req.token_ids)
        common = min(common, plen - 1, self._admit_limit - 2)
        if not free:
            return False, None
        # Pinned across the page-pressure eviction: _ensure_pages must not
        # evict the segment this admission is about to reference.
        self._prefix_index.pin(seg)
        try:
            if not self._admit_pages_ok(plen, common):
                return False, None
            slot_idx = free.pop(0)
            self._pool.share_pages(self._prefix_index.pages(seg), slot_idx, common)
        finally:
            self._prefix_index.unpin(seg)
        if consume:
            self._drop_segment(seg)
        else:
            self._prefix_index.touch(seg)
        return True, self._admit_hit(req, slot_idx, common, shared=shared)

    def _admit_pages_ok(self, plen: int, common: int = 0, *, reserve: bool = False) -> bool:
        """Page-aware admission gate (paged mode): admit only when the free
        list covers the prompt's new pages plus one decode chunk of
        headroom; ``common`` tokens arrive on shared pages.  Evicts LRU
        parked segments to make room; False means backlog.  ``reserve``
        holds the need against later checks this tick, for batch
        admissions that allocate at their dispatch."""
        pt = self._pool.page_tokens
        horizon = min(plen + self.decode_chunk_size + 1, self.max_len)
        need = max(num_slot_pages(horizon, pt) - common // pt, 1)
        ok = self._ensure_pages(need + self._kv_pages_reserved)
        if ok and reserve:
            self._kv_pages_reserved += need
        return ok

    def _ensure_pages(self, need: int) -> bool:
        """Free at least ``need`` pages, evicting LRU parked segments as
        required; False when that many cannot be freed."""
        if self._pool.pages_free >= need:
            return True
        self._evict_segments(need)
        return self._pool.pages_free >= need

    def _evict_segments(self, target: int) -> int:
        """Evict least-recently-used unpinned parked segments until
        ``target`` pages are free (or none are left); returns the count."""
        evicted = 0
        for seg in self._prefix_index.lru_order():
            if self._pool.pages_free >= target:
                break
            if self._prefix_index.pinned(seg):
                continue
            self._drop_segment(seg)
            evicted += 1
        if evicted:
            with self.stats.lock:
                self.stats.kv_page_evictions += evicted
        return evicted

    def _graft_into(self, src: int, dst: int, common: int) -> None:
        """Copy the shared segment's first ``common`` positions (bucketed)
        from slot ``src`` into slot ``dst``; the source stays parked."""
        n = min(bucket_size(common, minimum=16, dense=True), self.max_len)
        self._graft_prefix(src, dst, n)
        self._prefix_index.touch(src)

    def _claim_warm(self, req: Request, slot_idx: int, start: int) -> None:
        slot = self._slots[slot_idx]
        slot.request = req
        slot.length = len(req.token_ids)
        slot.emitted = 0
        slot.history = list(req.token_ids)
        slot.session_id = ""
        slot.cached = False
        slot.parked_at = 0.0
        slot.warm_pos = start

    def _claim_warm_cold(self, req: Request, slot_idx: int) -> None:
        with self.stats.lock:
            self.stats.queued -= 1
        self._claim_warm(req, slot_idx, 0)

    def _advance_warm(self, slot_idx: int):
        """Dispatch one prefill chunk for a warming slot.  The final chunk
        returns a finalize callable that fetches the first token.  Returns
        (finalize_or_None, chunk_tokens)."""
        slot = self._slots[slot_idx]
        req = slot.request
        if req is None or slot.warm_pos is None:
            return None, 0
        if req.id and self._is_cancelled(req.id):
            self._finish(slot_idx, "cancelled")
            return None, 0
        t0 = time.perf_counter()
        pos = slot.warm_pos
        plen = slot.length
        n = min(self.prefill_chunk_tokens, plen - pos)
        s = min(bucket_size(n, minimum=16, dense=True), self.max_len)
        tokens = np.zeros((1, s), dtype=np.int32)
        tokens[0, :n] = slot.history[pos : pos + n]
        kv_bucket = bucket_size(pos + s, maximum=self.max_len, dense=True)
        tok = self._prefill_suffix(
            self._h2d(tokens), pos, n, slot_idx, self._sampling_dev(req.sampling), kv_bucket
        )
        with self.stats.lock:
            self.stats.prefill_chunks += 1
        if pos + n < plen:
            slot.warm_pos = pos + n
            return None, n
        slot.warm_pos = None
        return (lambda: self._suffix_finalize(req, slot_idx, tok, t0)), n

    def _handle_token(self, slot_idx: int, tid: int) -> None:
        """Process one sampled token for a slot; may finish the slot."""
        slot = self._slots[slot_idx]
        req = slot.request
        if req is None:
            return
        if req.id and self._is_cancelled(req.id):
            self._finish(slot_idx, "cancelled")
            return
        self._cur_tok[slot_idx] = tid
        if req.eos_id is not None and tid == req.eos_id and req.sampling.stop_on_eos:
            self._finish(slot_idx, "stop")
            return
        try:
            req.on_token(tid)
        except Exception:
            logger.exception("on_token callback failed; cancelling request")
            self._finish(slot_idx, "error")
            return
        slot.emitted += 1
        slot.history.append(tid)
        self._tok_count += 1
        if slot.emitted >= req.sampling.max_tokens:
            self._finish(slot_idx, "length")
        elif slot.length + slot.emitted >= self.max_len:
            self._finish(slot_idx, "length")

    def _loop(self) -> None:
        logger.info("scheduler started: %d slots, chunk %d", self.max_batch, self.decode_chunk_size)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while self._running:
                tick_t0 = time.perf_counter()
                try:
                    self._tick()
                except Exception:
                    # A failing request must not take the loop down: fail
                    # every live request (warming ones included), drop the
                    # parked prefixes and start from a clean cache.
                    logger.exception("scheduler tick failed; failing active slots")
                    for i, s in enumerate(self._slots):
                        if s.request is not None:
                            self._finish(i, "error")
                    for i, s in enumerate(self._slots):
                        if s.cached:
                            self._unpark(i)
                    if self._pool is not None:
                        self._prefix_index.clear()
                        self._session_segs.clear()
                        self._seg_sessions.clear()
                        self._pool.reset_all()
                    else:
                        self._cache = prepare_cache(self.cfg, self.max_batch, self.max_len, self.device)
                self.stats.tick_ms_ewma += 0.1 * ((time.perf_counter() - tick_t0) * 1e3 - self.stats.tick_ms_ewma)
        logger.info("scheduler stopped")

    def _tick(self) -> None:
        with self.stats.lock:
            self.stats.tick_count += 1
        progressed = False
        if self._pool is not None:
            self._kv_pages_reserved = 0
            # Pool pressure: below the low-water mark at a tick boundary,
            # evict LRU parked segments so admission allocates from a
            # healthy free list.
            if self._pool.pages_free < self._kv_low_water:
                self._evict_segments(self._kv_low_water)
        # Pipelined tick: admission work is dispatched first, the decode
        # chunk for the pre-admission active snapshot behind it, and only
        # then does the host wait.  Newly admitted slots join decode next
        # tick; their lanes are pinned at max_len - 1 meanwhile, whose
        # flush lands in the tail zone _clip_prompt keeps clear.
        decode_active = self._active()
        admits: list[Callable[[], None]] = []

        def settle(fin) -> None:
            if fin is not None:
                admits.append(fin)

        budget = self.ADMIT_TOKEN_BUDGET
        # Phase 1: warming slots advance one prefill chunk each.
        for i in self._warming():
            fin, n = self._advance_warm(i)
            budget -= n
            settle(fin)
            progressed = True
        # Phase 2: admit pending requests in ADMIT_CAP-sized batches until
        # slots, the queue or this tick's token budget run out.
        free = self._free_slots()
        stalled = False
        while not stalled and budget > 0:
            batch: list[tuple[Request, int]] = []
            batch_tokens = 0
            while len(batch) < self.ADMIT_CAP:
                req = self._next_pending()
                if req is None:
                    stalled = True
                    break
                if self._drop_if_cancelled(req):
                    continue
                self._clip_prompt(req)
                plen = len(req.token_ids)
                parked, common = self._find_parked(req)
                shared_src, shared_common = (-1, 0)
                if parked < 0:
                    shared_src, shared_common = self._find_shared(req)
                reuse = common if parked >= 0 else shared_common
                cost = plen - reuse
                if self.prefill_chunk_tokens and cost > self.prefill_chunk_tokens:
                    cost = self.prefill_chunk_tokens
                if batch_tokens + cost > budget and (batch or budget < self.ADMIT_TOKEN_BUDGET):
                    self._backlog.appendleft(req)
                    budget = 0
                    break
                if parked >= 0:
                    if self._pool is not None:
                        # Session hit (paged): reference the session
                        # segment's pages from a free slot and consume it.
                        ok, fin = self._admit_paged_hit(req, parked, common, free, consume=True, shared=False)
                        if not ok:
                            self._backlog.appendleft(req)
                            stalled = True
                            break
                        settle(fin)
                    else:
                        settle(self._admit_hit(req, parked, common, shared=False))
                    budget -= cost
                    progressed = True
                    continue
                if shared_src >= 0 and self._pool is not None:
                    # Shared-prefix hit (paged): the segment keeps serving
                    # other requests; copy-on-write isolates divergence.
                    ok, fin = self._admit_paged_hit(req, shared_src, shared_common, free, consume=False, shared=True)
                    if not ok:
                        self._backlog.appendleft(req)
                        stalled = True
                        break
                    settle(fin)
                    budget -= cost
                    progressed = True
                    continue
                if shared_src >= 0:
                    self._prefix_index.pin(shared_src)
                    try:
                        if not free:
                            free = self._reclaim_parked(1)
                    finally:
                        self._prefix_index.unpin(shared_src)
                    if free:
                        dst = free.pop()
                        self._graft_into(shared_src, dst, shared_common)
                        settle(self._admit_hit(req, dst, shared_common, shared=True))
                    else:
                        # No spare slot: consume the segment itself.
                        settle(self._admit_hit(req, shared_src, shared_common, shared=True))
                    budget -= cost
                    progressed = True
                    continue
                if not free:
                    free = self._reclaim_parked(1)
                    if not free:
                        self._backlog.appendleft(req)
                        stalled = True
                        break
                chunked_cold = bool(self.prefill_chunk_tokens and plen > self.prefill_chunk_tokens)
                # In paged mode a free slot is not capacity: the free list
                # must also cover the prompt and a chunk of decode.  Chunked
                # admissions allocate their first chunk at once; batch
                # admissions at the batch's dispatch, so theirs is reserved.
                if self._pool is not None and not self._admit_pages_ok(plen, reserve=not chunked_cold):
                    self._backlog.appendleft(req)
                    stalled = True
                    break
                if chunked_cold:
                    slot_idx = free.pop()
                    self._claim_warm_cold(req, slot_idx)
                    fin, _ = self._advance_warm(slot_idx)
                    settle(fin)
                    budget -= cost
                    progressed = True
                    continue
                batch.append((req, free.pop()))
                batch_tokens += plen
            if not batch:
                break
            t = self._admit_dispatch([r for r, _ in batch], [i for _, i in batch])
            if self._pool is not None:
                self._kv_pages_reserved = 0  # the dispatch allocated them
            admits.append(lambda t=t: self._admit_finalize(*t))
            budget -= batch_tokens
            progressed = True

        with self.stats.lock:
            self.stats.active_slots = len(self._active())
        decode_pending = None
        if decode_active:
            decode_pending = self._decode_dispatch(decode_active)
            progressed = True
        for fin in admits:
            fin()
        if decode_pending is not None:
            self._decode_finalize(*decode_pending)
        if self._pool is not None:
            self._publish_pool_gauges()
        if not progressed:
            req = self._next_pending()
            if req is None:
                try:
                    req = self._pending.get(timeout=0.05)
                except queue.Empty:
                    return
            if self._drop_if_cancelled(req):
                return
            if not self._admit_request_now(req):
                self._backlog.appendleft(req)

    def _admit_request_now(self, req: Request) -> bool:
        """Idle-path admission through the same decision tree as the busy
        tick, finalized synchronously; False when no slot could be
        claimed."""
        self._clip_prompt(req)
        parked, common = self._find_parked(req)
        if parked >= 0:
            if self._pool is not None:
                ok, fin = self._admit_paged_hit(req, parked, common, self._free_slots(), consume=True, shared=False)
                if not ok:
                    return False
            else:
                fin = self._admit_hit(req, parked, common, shared=False)
            if fin is not None:
                fin()
            return True
        shared_src, shared_common = self._find_shared(req)
        if shared_src >= 0 and self._pool is not None:
            ok, fin = self._admit_paged_hit(
                req, shared_src, shared_common, self._free_slots(), consume=False, shared=True
            )
            if not ok:
                return False
            if fin is not None:
                fin()
            return True
        if shared_src >= 0:
            self._prefix_index.pin(shared_src)
            try:
                free = self._free_slots() or self._reclaim_parked(1)
            finally:
                self._prefix_index.unpin(shared_src)
            if free:
                dst = free[0]
                self._graft_into(shared_src, dst, shared_common)
                fin = self._admit_hit(req, dst, shared_common, shared=True)
            else:
                fin = self._admit_hit(req, shared_src, shared_common, shared=True)
            if fin is not None:
                fin()
            return True
        free = self._free_slots() or self._reclaim_parked(1)
        if not free:
            return False
        if self._pool is not None and not self._admit_pages_ok(len(req.token_ids)):
            return False
        if self.prefill_chunk_tokens and len(req.token_ids) > self.prefill_chunk_tokens:
            self._claim_warm_cold(req, free[0])
            fin, _ = self._advance_warm(free[0])
            if fin is not None:
                fin()
            return True
        self._admit_many([req], [free[0]])
        return True

    def _lane_state(self):
        """Per-slot decode inputs: (lengths, temp, top_p, top_k,
        max_active_length).  Parked and warming lanes point at the last
        cache position (its flush lands in the tail garbage zone); empty
        lanes at 0."""
        b = self.max_batch
        active_lengths = [
            s.length + s.emitted - 1 for s in self._slots if s.request is not None and s.warm_pos is None
        ]
        lengths = np.array(
            [
                (s.length + s.emitted - 1)
                if s.request is not None and s.warm_pos is None
                else (self.max_len - 1 if s.cached or s.request is not None else 0)
                for s in self._slots
            ],
            dtype=np.int32,
        )
        temp = np.zeros((b,), dtype=np.float32)
        top_p = np.ones((b,), dtype=np.float32)
        top_k = np.zeros((b,), dtype=np.int32)
        for i, s in enumerate(self._slots):
            if s.request is not None:
                temp[i] = s.request.sampling.temperature
                top_p[i] = s.request.sampling.top_p
                top_k[i] = s.request.sampling.top_k
        return lengths, temp, top_p, top_k, (max(active_lengths) if active_lengths else 0)

    def _decode_dispatch(self, active: list[int]) -> tuple:
        """Dispatch one decode chunk for the ``active`` snapshot without
        waiting; lanes outside it are pinned at the cache tail."""
        t_dec0 = time.perf_counter()
        lengths, temp, top_p, top_k, max_active = self._lane_state()
        snap = np.zeros((self.max_batch,), dtype=bool)
        snap[active] = True
        lengths = np.where(snap, lengths, self.max_len - 1)
        # Attention window: the power-of-two bucket covering every position
        # this chunk can write for a live lane.
        kv_bucket = bucket_size(max_active + self.decode_chunk_size + 1, maximum=self.max_len)
        cache_args: tuple = (self._cache,)
        if self._pool is not None:
            # Private pages for each live lane's write range; lanes outside
            # the snapshot write the garbage page through unowned entries.
            for i in active:
                slot = self._slots[i]
                live = slot.length + slot.emitted
                self._pool.make_writable(i, max(live - 1, 0), min(live + self.decode_chunk_size, self.max_len))
            cache_args = (self._cache, self._pool.device_table())
        _, toks = self._decode_chunk(
            self.params,
            *cache_args,
            self._h2d(self._cur_tok),
            self._h2d(np.minimum(lengths, self.max_len - 1).astype(np.int32)),
            self._gen,
            self._h2d(temp),
            self._h2d(top_p),
            self._h2d(top_k),
            self.decode_chunk_size,
            kv_bucket,
        )
        return toks, active, t_dec0

    def _decode_finalize(self, toks, active: list[int], t_dec0: float) -> None:
        """Fetch a dispatched chunk's tokens and emit them for the slots of
        its snapshot (slots admitted after it keep their first token)."""
        toks_host = toks.cpu().numpy()  # (chunk, b)
        if active:
            self._cur_tok[active] = toks_host[-1][active]
        for row in toks_host:
            for i in active:
                if self._slots[i].request is not None:
                    self._handle_token(i, int(row[i]))
        self._flush_tokens()
        with self.stats.lock:
            self.stats.decode_s += time.perf_counter() - t_dec0
            self.stats.decode_chunks += 1
