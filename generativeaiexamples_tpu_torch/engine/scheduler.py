"""Continuous-batching scheduler (port of ``engine/scheduler.py``, the
non-speculative path, on the contiguous cache or the paged pool).

* **Slot model**: the KV cache (int8, or float in the compute dtype on
  the contiguous layout) holds ``max_batch`` fixed slots; a request
  occupies a slot from prefill to finish.
* **Projection path** (``matmul_kernel``): ``"xla"`` (the default, as in
  the reference) serves the weights as handed over or, with none, random
  float weights; ``"pallas_w8a8"`` quantizes, packs and blocks them for
  the W8A8 kernel.
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
  chunk per tick (int8: append-buffer protocol, decode kernel; float:
  the per-step scatter); idle lanes compute masked garbage that is never
  emitted.
* **Chunked prefill**: prompts longer than ``prefill_chunk_tokens`` claim
  a slot and prefill one chunk per tick, interleaved with decode.
* **Prefix cache**: finished slots park their KV under a host-side radix
  index; a prompt sharing a long prefix grafts the cached rows into its
  slot and prefills only the suffix.
* **Pipelined tick**: admission work is dispatched first, the decode
  chunk behind it on the same CUDA stream, and only then does the host
  wait for sampled tokens: no host sync between dispatch and finalize.

* **Speculative decoding** (``engine.spec_decode``): with a draft model
  (an independent draft, or the target's first layers) or
  ``spec_mode="ngram"`` (prompt lookup), every decode chunk becomes
  speculation rounds: the draft proposes up to ``gamma`` tokens and the
  target verifies them in one forward.  Greedy streams equal the plain
  chunk's.  The draft keeps its own contiguous slot cache (or the n-gram
  matcher its token history), rebuilt along every KV-building path.

* **Admission control** (``max_queue``): ``submit`` refuses a request
  (returns False, counts ``rejected_total``) once that many wait; the
  HTTP front answers 429.  ``replica_index`` tags a pool member's
  ``replica`` fault site (``engine.replica.EnginePool``).

The scheduler thread emits tokens through ``on_token`` / ``on_done``
callbacks, never while it holds ``stats.lock`` (the replica pool takes its
own lock inside them).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import host_to_device, resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine import mesh_serving, spec_decode
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
from generativeaiexamples_tpu_torch.resilience.degrade import mark_degraded
from generativeaiexamples_tpu_torch.resilience.faults import FaultInjected, inject, inject_replica
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
    # Set by the HTTP front for non-streamed requests: a replica pool may
    # fire a second copy to another replica when this one is slow (first
    # response wins).
    hedgeable: bool = False


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
    # Speculation: EWMA of this request's acceptance rate (accepted drafts
    # / gamma), which drives the adaptive lookahead; 1.0 at every claim.
    accept_ewma: float = 1.0


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
        # Requests refused by a full admission queue (the 429 path).
        self.rejected_total = 0
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
        # Tick time scaled to one token per decoding lane per chunk step
        # (a speculative tick that emits 3x the tokens is not 3x slower),
        # and the tokens a tick emits.
        self.tick_ms_norm_ewma = 0.0
        self.tick_tokens_ewma = 0.0
        # Speculation: (slot, round) pairs of greedy or filtered-sampled
        # rows, the tokens they emitted, drafts put before the verifier and
        # accepted (acceptance = accepted / proposed), the acceptance EWMA
        # over chunks, the lookahead of the latest chunk, and ticks that a
        # ``spec_draft`` fault degraded to the plain chunk.
        self.spec_rounds = 0
        self.spec_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_acceptance_ewma = 0.0
        self.spec_gamma = 0
        self.spec_fallbacks = 0
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
        # The 429 hint's page projection: pages a typical admission needs
        # (an EWMA of the gate's need), and pages returned to the free list
        # per second (an EWMA over the telemetry feed's interval).
        self.kv_pages_per_admit = 0
        self.kv_page_free_rate = 0.0

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
                "rejected_total": self.rejected_total,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "shared_prefix_hits": self.shared_prefix_hits,
                "prefill_chunks": self.prefill_chunks,
                "tick_ms_ewma": round(self.tick_ms_ewma, 3),
                "tick_ms_norm_ewma": round(self.tick_ms_norm_ewma, 3),
                "tick_tokens_ewma": round(self.tick_tokens_ewma, 3),
                "spec_rounds": self.spec_rounds,
                "spec_tokens": self.spec_tokens,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_acceptance_ewma": round(self.spec_acceptance_ewma, 4),
                "spec_gamma": self.spec_gamma,
                "spec_fallbacks": self.spec_fallbacks,
                "kv_pages_total": self.kv_pages_total,
                "kv_pages_free": self.kv_pages_free,
                "kv_pages_parked": self.kv_pages_parked,
                "kv_pages_shared": self.kv_pages_shared,
                "kv_cow_breaks": self.kv_cow_breaks,
                "kv_page_evictions": self.kv_page_evictions,
                "kv_pages_per_admit": self.kv_pages_per_admit,
                "kv_page_free_rate": round(self.kv_page_free_rate, 3),
                # Share of the pool off the free list (0.0 without a pool).
                "kv_page_utilization": (
                    round(1.0 - self.kv_pages_free / self.kv_pages_total, 4) if self.kv_pages_total else 0.0
                ),
            }


# Keys of the mesh schedulers' state on their ranks.
_MESH_KEYS = itertools.count(1)


def live_matmul_kernel(params) -> str:
    """``"pallas_w8a8"`` when any projection of ``params`` is blocked for
    the W8A8 kernel, else ``"xla"``."""
    from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix

    blocked = any(isinstance(leaf, BlockedQuantizedMatrix) for leaf in params["layers"].values())
    return "pallas_w8a8" if blocked else "xla"


class Scheduler:
    """Continuous batching over a fixed-slot KV cache.

    Runs on ``device`` (default ``cuda``; pass ``device="cpu"`` for the
    plain versions of the kernels).  ``params`` are the port's params
    (``engine.weights.params_from_numpy``, a loader's, or
    ``engine.decode.prepare_params``'s), laid out once here
    (``engine.decode.prepare_params``) for ``matmul_kernel``: ``"xla"`` /
    None serves them as they are (``None`` params: random float weights
    from the scheduler's generator); ``"pallas_w8a8"`` is the port's W8A8
    route (quantized, packed and blocked; ``None``: random int8).  Leaves
    already blocked pass through either way.  ``matmul_kernel`` the
    attribute names the path that is live, as the reference reports it:
    ``"pallas_w8a8"`` when any projection is blocked, else ``"xla"``.
    The cache follows ``cfg.kv_dtype``; the paged pool needs int8.

    ``kv_layout="paged"`` serves from the paged pool: ``kv_page_size``
    tokens per page (a power of two), ``kv_pool_pages`` pages (floored at
    ``max_batch * n_slot_pages + 1``), and ``kv_page_low_water`` free pages
    below which a tick evicts least-recently-used parked segments
    (default: one slot's worth).

    Speculative decoding: ``draft_cfg`` / ``draft_params`` attach a draft
    model with its own contiguous cache of ``draft_cfg.kv_dtype``,
    prepared as the target is, packed, and quantized with
    ``draft_quantize`` (the reference's default keeps it float; the W8A8
    route quantizes it) (``None`` params: random from the scheduler's
    generator),
    ``spec_mode="ngram"`` prompt lookup over the last ``ngram`` tokens;
    ``gamma`` is the largest lookahead, which ``adaptive_gamma`` shrinks
    chunk by chunk to the power of two the rows' acceptance asks for.
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
        draft_cfg: Optional[llama.LlamaConfig] = None,
        draft_params=None,
        gamma: int = 4,
        adaptive_gamma: bool = True,
        spec_mode: Optional[str] = None,
        ngram: int = 2,
        matmul_kernel: Optional[str] = None,
        draft_quantize: bool = False,
        max_queue: Optional[int] = None,
        mesh=None,
    ) -> None:
        if mesh is not None:
            if draft_cfg is not None or spec_mode is not None:
                raise NotImplementedError(f"speculative decoding over a mesh: {mesh_serving.MESH_LATER}")
            if kv_layout == "paged" and mesh.shape["data"] > 1:
                raise ValueError("the paged pool over a mesh shards KV heads only: data must be 1 "
                                 "(use kv_layout='contiguous' to shard slots over data)")
            device = mesh.devices.flat[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout mode {kv_layout!r}")
        if kv_layout == "paged" and cfg.kv_dtype != "int8":
            raise ValueError(f"the paged KV pool stores int8 pages; kv_dtype={cfg.kv_dtype!r} needs the "
                             "contiguous layout")
        if kv_page_size < 1 or (kv_page_size & (kv_page_size - 1)):
            raise ValueError(f"kv_page_size must be a power of two, got {kv_page_size}")
        if spec_mode not in (None, "ngram"):
            raise ValueError(f"unknown spec_mode {spec_mode!r}")
        if spec_mode == "ngram" and draft_cfg is not None:
            raise ValueError("spec_mode='ngram' excludes a draft model")
        if draft_cfg is not None:
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
        self.cfg = cfg
        # Pool index when an EnginePool owns this scheduler (tags the
        # ``replica`` fault site); None when it serves alone.
        self.replica_index: Optional[int] = None
        # Admission queue bound (None: unbounded, for offline callers).
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.decode_chunk_size = decode_chunk_size
        self.draft_cfg = draft_cfg
        self.spec_mode = spec_mode
        self.ngram = ngram
        self.gamma = gamma
        self.adaptive_gamma = adaptive_gamma
        self._speculating = draft_cfg is not None or spec_mode == "ngram"
        self.effective_max_len = self.max_len
        if self._speculating:
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            # A live row must never start a round inside the flush-clip zone
            # [max_len - (gamma + 1), max_len): a clipped round flush would
            # overwrite history the next round's verify reads.
            self.effective_max_len = self.max_len - (gamma + 1)
            if self.effective_max_len < 2:
                raise ValueError(f"max_len {self.max_len} too small for gamma {gamma}")
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
        w8a8 = matmul_kernel == "pallas_w8a8"
        with torch.inference_mode():
            if mesh is not None:
                self._init_mesh(cfg, params, seed, w8a8, kv_pool_pages)
            else:
                self.params = prepare_params(cfg, params, device=self.device, quantize=w8a8, pack=w8a8,
                                             matmul_kernel=matmul_kernel, generator=self._gen)
            if mesh is None and kv_layout == "paged":
                self._pool = prepare_paged_pool(
                    cfg, max_batch, self.max_len, self.kv_page_size, kv_pool_pages, device=self.device
                )
                # The pool's leaves are updated in place (COW copies
                # included), so this alias stays valid for the pool's life.
                self._cache = self._pool.leaves
            elif mesh is None:
                self._cache = prepare_cache(cfg, max_batch, self.max_len, self.device)
            self.draft_params = None
            self._dcache = None
            self._dhist = None
            if draft_cfg is not None:
                self.draft_params = prepare_params(
                    draft_cfg, draft_params, device=self.device, quantize=draft_quantize or w8a8, pack=True,
                    matmul_kernel=matmul_kernel, generator=self._gen,
                )
                self._dcache = prepare_cache(draft_cfg, max_batch, self.max_len, self.device)
            elif spec_mode == "ngram":
                # The matcher's token history lives on the device: rows are
                # written at admission, the chunk carries them forward.
                self._dhist = torch.zeros((max_batch, self.max_len), dtype=torch.int32, device=self.device)
        # The path that is live, not the one asked for (the reference's
        # rule; /metrics exports it).  A mesh never blocks its projections.
        self.matmul_kernel = "xla" if mesh is not None else live_matmul_kernel(self.params)
        if mesh is not None:
            self._decode_chunk = None  # each rank holds its own (engine.mesh_serving)
        elif self._pool is not None:
            self._decode_chunk = make_paged_decode_chunk_fn(cfg, self.max_len, self.kv_page_size)
        else:
            self._decode_chunk = make_decode_chunk_fn(cfg, self.max_len)
        if self._pool is not None:
            self._kv_low_water = (
                int(kv_page_low_water) if kv_page_low_water is not None else self._pool.n_slot_pages
            )
            # Pages promised to batch admissions whose allocation happens at
            # the batch's dispatch later this tick.
            self._kv_pages_reserved = 0
            # The 429 hint's inputs: the admission need's EWMA (seeded at a
            # whole slot) and the free-rate tracker's last reading.
            self.stats.kv_pages_per_admit = self._pool.n_slot_pages
            self._pages_per_admit_ewma = float(self._pool.n_slot_pages)
            self._kv_frees_prev = 0
            self._kv_free_rate_t = time.time()
        if draft_cfg is not None:
            self._spec_chunk = (
                spec_decode.make_paged_spec_chunk_fn(cfg, draft_cfg, self.max_len, self.kv_page_size)
                if self._pool is not None
                else spec_decode.make_spec_chunk_fn(cfg, draft_cfg, self.max_len)
            )
        elif spec_mode == "ngram":
            self._spec_chunk = (
                spec_decode.make_paged_ngram_spec_chunk_fn(cfg, self.max_len, self.kv_page_size, ngram=ngram)
                if self._pool is not None
                else spec_decode.make_ngram_spec_chunk_fn(cfg, self.max_len, ngram=ngram)
            )
        self.prefix_cache = prefix_cache
        self._prefix_index = PrefixCacheIndex()
        if self._pool is not None:
            self._publish_pool_gauges()
        if prefill_chunk_tokens is not None and prefill_chunk_tokens <= 0:
            prefill_chunk_tokens = None
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # Pipelined ticks pin not-yet-decoding lanes at max_len - 1, whose
        # flush garbage-writes [max_len - w, max_len), w the widest flush
        # this scheduler dispatches: the decode chunk, or a speculative
        # round's gamma + 1 (adaptive gamma only shrinks).  Admitted prompt
        # KV must stay strictly below it.
        self._flush_width = max(decode_chunk_size, gamma + 1) if self._speculating else decode_chunk_size
        self._admit_limit = min(self.effective_max_len, flush_clip_start(self.max_len, self._flush_width))
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
        # Tokens emitted this tick and lanes its decode chunk advanced, for
        # the token-normalized tick time.
        self._tick_tokens = 0
        self._tick_decoded = 0
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._backlog: "collections.deque[Request]" = collections.deque()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # Fleet telemetry: snapshot gauges and counter deltas reach the
        # TSDB at most every 0.25 s (a snapshot takes the stats lock).
        self._tsdb_feed_interval_s = 0.25
        self._last_tsdb_feed = 0.0
        self._tsdb_prev: dict = {}

    def _init_mesh(self, cfg, params, seed: int, quantize: bool, kv_pool_pages) -> None:
        """Build every rank's engine (its shards of the params and the
        cache, its generator) and, on the paged layout, the controller's
        host-only pool whose page tables the ranks read."""
        from generativeaiexamples_tpu_torch.engine.mesh_serving import RankParams, tree_to_host

        self._mesh_key = f"sched-{next(_MESH_KEYS)}"
        if isinstance(params, RankParams):
            source = params
        elif params is None:
            source = RankParams("seed", quantize=quantize)
        else:
            source = RankParams("tree", tree=tree_to_host(params), quantize=quantize)
        self.params = None
        self._cache = None
        self.mesh_shards = self.mesh.run(
            mesh_serving.setup, self._mesh_key, cfg, source, self.max_batch, self.max_len, self.kv_layout,
            self.kv_page_size, kv_pool_pages, seed, gather=True,
        )
        if self.kv_layout == "paged":
            self._pool = prepare_paged_pool(cfg, self.max_batch, self.max_len, self.kv_page_size, kv_pool_pages,
                                            device=self.device, mesh=(self.mesh, self._mesh_key))

    def release_mesh(self) -> None:
        """Free every rank's engine state (params, cache) for this scheduler;
        a mesh that lost a rank holds nothing to free."""
        if self.mesh is not None and self.mesh.runtime.alive:
            self.mesh.run(mesh_serving.drop, self._mesh_key)

    # -- device helpers ----------------------------------------------------

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device without a host sync (pinned, non-blocking).
        Over a mesh the array stays on the host: it is a program's input."""
        if self.mesh is not None:
            return np.ascontiguousarray(arr)
        return host_to_device(torch.from_numpy(np.ascontiguousarray(arr)), self.device)

    def _full(self, value, dtype) -> torch.Tensor:
        if self.mesh is not None:
            return np.full((1,), value, dtype=np.int32 if dtype == torch.int32 else np.float32)
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

    def _prefill_draft(self, tokens, lengths):
        """Cold-prefill the admission batch into a fresh small draft cache
        (no sampling: the draft only needs KV)."""
        b, s = tokens.shape
        small = llama.init_kv_cache(self.draft_cfg, b, s, device=self.device)
        positions = torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)
        llama.forward(self.draft_params, self.draft_cfg, tokens.long(), positions, small, lengths, cold_prefill=True)
        return small

    def _prefill_draft_suffix(self, tokens, start: int, suffix_len: int, slot: int, kv_bucket: int) -> None:
        """Warm-prefill ``tokens`` (1, s) at positions ``start..`` into the
        draft cache row of ``slot``: the draft twin of
        :meth:`_prefill_suffix`, which keeps the draft covering the same
        ``[0, length)`` window as the target on every KV-building path."""
        s = tokens.shape[1]
        positions = start + torch.arange(s, dtype=torch.int32, device=self.device)[None, :]
        row = tuple(c[:, :, slot : slot + 1] for c in self._dcache)
        llama.forward(
            self.draft_params, self.draft_cfg, tokens.long(), positions, row,
            self._full(start + suffix_len, torch.int32), kv_bucket=kv_bucket,
        )

    def _set_history_row(self, slot: int, token_ids) -> None:
        """Rewrite the n-gram matcher's history row of ``slot`` (zeros past
        the tokens clear the row's previous occupant)."""
        row = np.zeros((self.max_len,), dtype=np.int32)
        row[: len(token_ids)] = token_ids
        self._dhist[slot] = self._h2d(row)

    def _graft_rows(self, small, slots: torch.Tensor, cache=None) -> None:
        """Copy the small cache's rows 0..k-1 into their slots of ``cache``
        (default: the target's)."""
        k = slots.shape[0]
        for big, sm in zip(self._cache if cache is None else cache, small):
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
        if self.mesh is not None:
            table_row = None
            if self._pool is not None:
                self._pool.make_writable(slot, start, start + suffix_len)
                table_row = self._pool.tables[slot : slot + 1].copy()
            return self.mesh.run(mesh_serving.prefill_suffix, self._mesh_key, tokens, start, suffix_len, slot,
                                 sampling, kv_bucket, table_row)
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
        if self.mesh is not None:
            self.mesh.run(mesh_serving.graft_prefix, self._mesh_key, src, dst, n)
            return
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

    def submit(self, request: Request) -> bool:
        """Enqueue a request; False (and nothing enqueued) when
        ``max_queue`` requests already wait: the HTTP front answers 429."""
        request.submitted_at = time.perf_counter()
        if self.mesh is not None and not self.mesh.runtime.alive:
            # The mesh lost a rank: nothing will run this request.
            request.on_done("error")
            return True
        with self.stats.lock:
            if self.max_queue is not None and self.stats.queued >= self.max_queue:
                self.stats.rejected_total += 1
                return False
            self.stats.queued += 1
        self._pending.put(request)
        return True

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

    def close(self) -> None:
        """Stop the tick loop and free what the scheduler holds on a mesh's
        ranks (a pool detaching a drained replica calls this)."""
        self.stop()
        self.release_mesh()

    def request_stop(self) -> None:
        """Ask the tick loop to exit without joining it (a health monitor
        must not block on a wedged thread)."""
        self._running = False

    @property
    def max_prompt_len(self) -> int:
        """The longest prompt admitted whole: a longer one is clipped to its
        tail (``_clip_prompt``)."""
        return self._admit_limit - 1

    def healthy(self) -> bool:
        """False iff the tick thread died while meant to be running, or the
        mesh it serves on lost a rank."""
        if self.mesh is not None and not self.mesh.runtime.alive:
            return False
        return self._thread is None or not self._running or self._thread.is_alive()

    def _fail_waiting(self) -> None:
        """Finish every queued and backlogged request with ``error``."""
        waiting = list(self._backlog)
        self._backlog.clear()
        while True:
            try:
                waiting.append(self._pending.get_nowait())
            except queue.Empty:
                break
        for req in waiting:
            with self.stats.lock:
                self.stats.queued -= 1
            try:
                req.on_done("error")
            except Exception:
                logger.exception("on_done callback failed")

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
            # Parked history stays clear of the flush-clip tail zone of the
            # widest flush (decode chunk or speculative round).
            and slot.length + slot.emitted
            < min(
                flush_clip_start(self.max_len, self._flush_width),
                self.max_len - max(16, self._flush_width + 1),
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
        if self._pool is not None:
            # The pool gauges before on_done, as the reference publishes:
            # a caller reading /metrics right after completion sees the park.
            self._publish_pool_gauges()
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
        if self.mesh is not None:
            tok = self._admit_on_mesh(slot_idxs, plens, tokens, lengths, temp, top_p, top_k)
            return self._claim_admitted(reqs, slot_idxs, plens, tok, t_admit0)
        tokens_dev, lengths_dev = self._h2d(tokens), self._h2d(lengths)
        slots_dev = self._h2d(np.asarray(slot_idxs, dtype=np.int64))
        small, tok = self._prefill_some(
            tokens_dev, lengths_dev, self._h2d(temp), self._h2d(top_p), self._h2d(top_k)
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
            self._graft_rows(small, slots_dev)
        if self._dhist is not None:
            hist = np.zeros((len(reqs), self.max_len), dtype=np.int32)
            for r, req in enumerate(reqs):
                hist[r, : plens[r]] = req.token_ids
            self._dhist[slots_dev] = self._h2d(hist)
        if self.draft_cfg is not None:
            # The draft's slot rows mirror the target's: same prompts, same
            # slots.
            self._graft_rows(self._prefill_draft(tokens_dev, lengths_dev), slots_dev, self._dcache)
        return self._claim_admitted(reqs, slot_idxs, plens, tok, t_admit0)

    def _admit_on_mesh(self, slot_idxs, plens, tokens, lengths, temp, top_p, top_k):
        """The mesh's admission: the pool's pages first (host tables, COW
        copies on the ranks), then one program that prefills, samples and
        copies the rows into their slots (``engine.mesh_serving.admit``)."""
        phys = None
        if self._pool is not None:
            for r, slot_idx in enumerate(slot_idxs):
                self._pool.reset_slot(slot_idx)
                self._pool.make_writable(slot_idx, 0, plens[r])
            s = tokens.shape[1]
            rows = torch.from_numpy(self._pool.tables[np.asarray(slot_idxs)])
            phys = paged_slots(rows, torch.arange(s).expand(len(slot_idxs), s), self._pool.page_tokens).numpy()
        return self.mesh.run(mesh_serving.admit, self._mesh_key, tokens, lengths, temp, top_p, top_k,
                             np.asarray(slot_idxs, dtype=np.int64), phys)

    def _claim_admitted(self, reqs, slot_idxs, plens, tok, t_admit0: float) -> tuple:
        for r, (req, slot_idx) in enumerate(zip(reqs, slot_idxs)):
            slot = self._slots[slot_idx]
            slot.request = req
            slot.length = plens[r]
            slot.emitted = 0
            slot.history = list(req.token_ids)
            slot.accept_ewma = 1.0
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
        tok_dev = self._h2d(tokens)
        tok = self._prefill_suffix(
            tok_dev, common, len(suffix), slot_idx, self._sampling_dev(req.sampling), kv_bucket
        )
        if self.draft_cfg is not None:
            self._prefill_draft_suffix(tok_dev, common, len(suffix), slot_idx, kv_bucket)
        if self._dhist is not None:
            self._set_history_row(slot_idx, req.token_ids)
        slot = self._slots[slot_idx]
        slot.request = req
        slot.length = plen
        slot.emitted = 0
        slot.history = list(req.token_ids)
        slot.warm_pos = None
        slot.accept_ewma = 1.0
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
        if self.draft_cfg is not None and common > 0:
            # The segment holds target pages only: rebuild the slot's
            # contiguous draft row over [0, common) with one draft prefill.
            s = min(bucket_size(common, minimum=16, dense=True), self.max_len)
            dtok = np.zeros((1, s), dtype=np.int32)
            dtok[0, :common] = req.token_ids[:common]
            kv_bucket = bucket_size(s, maximum=self.max_len, dense=True)
            self._prefill_draft_suffix(self._h2d(dtok), 0, common, slot_idx, kv_bucket)
        return True, self._admit_hit(req, slot_idx, common, shared=shared)

    def _admit_pages_ok(self, plen: int, common: int = 0, *, reserve: bool = False) -> bool:
        """Page-aware admission gate (paged mode): admit only when the free
        list covers the prompt's new pages plus one decode chunk of
        headroom; ``common`` tokens arrive on shared pages.  Evicts LRU
        parked segments to make room; False means backlog.  ``reserve``
        holds the need against later checks this tick, for batch
        admissions that allocate at their dispatch."""
        pt = self._pool.page_tokens
        horizon = min(plen + self._flush_width + 1, self.max_len)
        need = max(num_slot_pages(horizon, pt) - common // pt, 1)
        self._pages_per_admit_ewma += 0.2 * (need - self._pages_per_admit_ewma)
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
        if self.draft_cfg is not None:
            # The parked draft rows were written in lockstep with the
            # target's: the same copy covers [0, common) in the draft too.
            for buf in self._dcache:
                buf[:, :, dst, :n] = buf[:, :, src, :n]
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
        slot.accept_ewma = 1.0
        if self._dhist is not None:
            # The whole prompt can go in at once: the matcher reads only
            # positions below the live length.
            self._set_history_row(slot_idx, req.token_ids)

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
        tok_dev = self._h2d(tokens)
        tok = self._prefill_suffix(tok_dev, pos, n, slot_idx, self._sampling_dev(req.sampling), kv_bucket)
        if self.draft_cfg is not None:
            # Both caches advance their warm frontier together.
            self._prefill_draft_suffix(tok_dev, pos, n, slot_idx, kv_bucket)
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
        self._tick_tokens += 1
        if slot.emitted >= req.sampling.max_tokens:
            self._finish(slot_idx, "length")
        elif slot.length + slot.emitted >= self.effective_max_len:
            self._finish(slot_idx, "length")

    def _loop(self) -> None:
        logger.info("scheduler started: %d slots, chunk %d", self.max_batch, self.decode_chunk_size)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while self._running:
                tick_t0 = time.perf_counter()
                # The pool's fault site, outside the recovery below: an
                # armed ``replica:error`` ends this thread (what failover
                # must see), ``replica:latency`` lands in the tick time.
                inject_replica(self.replica_index)
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
                    if self.mesh is not None and not self.mesh.runtime.alive:
                        # A lost rank ends the mesh: nothing can run on it
                        # again, so every waiting request fails now too.
                        self._fail_waiting()
                        self._running = False
                        break
                    if self._pool is not None:
                        self._prefix_index.clear()
                        self._session_segs.clear()
                        self._seg_sessions.clear()
                        self._pool.reset_all()
                    elif self.mesh is not None:
                        self.mesh.run(mesh_serving.reset_cache, self._mesh_key)
                    else:
                        self._cache = prepare_cache(self.cfg, self.max_batch, self.max_len, self.device)
                    if self._dcache is not None:
                        self._dcache = prepare_cache(self.draft_cfg, self.max_batch, self.max_len, self.device)
                    if self._dhist is not None:
                        self._dhist.zero_()
                self._note_tick((time.perf_counter() - tick_t0) * 1e3)
        logger.info("scheduler stopped")

    # Snapshot counters mirrored into the TSDB as per-interval deltas (the
    # reference's names; ``spec_accepted``'s series predates the scheme).
    _TSDB_COUNTER_KEYS = ("requests_total", "tokens_total", "rejected_total", "prefix_hits", "shared_prefix_hits",
                          "prefill_chunks", "spec_accepted", "spec_fallbacks")
    _TSDB_SERIES_NAMES = {"spec_accepted": "engine.spec.accepted"}

    def _note_tick(self, dt_ms: float) -> None:
        """Tick-time EWMAs: raw, and scaled back to one token per decoding
        lane per chunk step when speculation emitted more than the plain
        chunk would have (non-speculative ticks: the two are equal).  Then
        the fleet telemetry: the tick histogram and ``engine.tick_ms`` every
        tick, and at most every ``_tsdb_feed_interval_s`` the snapshot's
        gauges, counter deltas and the paged pool's 429 inputs."""
        stats = self.stats
        stats.tick_ms_ewma += 0.1 * (dt_ms - stats.tick_ms_ewma)
        emitted = self._tick_tokens
        baseline = self._tick_decoded * self.decode_chunk_size
        norm_ms = dt_ms * baseline / emitted if emitted > baseline > 0 else dt_ms
        stats.tick_ms_norm_ewma += 0.1 * (norm_ms - stats.tick_ms_norm_ewma)
        stats.tick_tokens_ewma += 0.1 * (emitted - stats.tick_tokens_ewma)
        try:
            from generativeaiexamples_tpu_torch.obs.metrics import observe_engine_tick
            from generativeaiexamples_tpu_torch.obs.tsdb import get_tsdb

            observe_engine_tick(dt_ms)
            db = get_tsdb()
            db.record("engine.tick_ms", norm_ms)
            now = time.time()
            if now - self._last_tsdb_feed < self._tsdb_feed_interval_s:
                return
            self._last_tsdb_feed = now
            snap = stats.snapshot()
            db.record("engine.queued", snap["queued"])
            db.record("engine.active_slots", snap["active_slots"])
            db.record("engine.parked_slots", sum(1 for s in self._slots if s.cached and s.request is None))
            pool = self._pool
            if pool is not None:
                rate = stats.kv_page_free_rate
                dt = now - self._kv_free_rate_t
                if dt > 0:
                    rate += 0.3 * ((pool.frees_total - self._kv_frees_prev) / dt - rate)
                with stats.lock:
                    stats.kv_pages_per_admit = max(1, int(round(self._pages_per_admit_ewma)))
                    stats.kv_page_free_rate = rate
                self._kv_frees_prev = pool.frees_total
                self._kv_free_rate_t = now
                db.record("engine.kv.free_pages", pool.pages_free)
            prev = self._tsdb_prev
            for key in self._TSDB_COUNTER_KEYS:
                delta = snap.get(key, 0) - prev.get(key, 0)
                prev[key] = snap.get(key, 0)
                if delta > 0:
                    db.record(self._TSDB_SERIES_NAMES.get(key, f"engine.{key}"), delta, kind="counter")
        except Exception:  # telemetry must never take the loop down
            logger.exception("tick telemetry feed failed")

    def _tick(self) -> None:
        with self.stats.lock:
            self.stats.tick_count += 1
        progressed = False
        self._tick_tokens = 0
        self._tick_decoded = 0
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
            self._tick_decoded = len(decode_active)
            decode_pending = self._dispatch_decode_phase(decode_active)
            progressed = True
        for fin in admits:
            fin()
        if decode_pending is not None:
            finalize, pending = decode_pending
            finalize(*pending)
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
            if self.mesh is None:
                cache_args = (self._cache, self._pool.device_table())
        if self.mesh is not None:
            # Every rank reads the host's page tables (its pool shard holds
            # its KV heads of the same pages).
            table = self._pool.tables.copy() if self._pool is not None else None
            toks = self.mesh.run(
                mesh_serving.decode, self._mesh_key, self._cur_tok.copy(),
                np.minimum(lengths, self.max_len - 1).astype(np.int32), temp, top_p, top_k, self.decode_chunk_size,
                kv_bucket, table,
            )
            return toks, active, t_dec0
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

    # -- speculative decoding ----------------------------------------------

    def _dispatch_decode_phase(self, active: list[int]):
        """Dispatch this tick's decode work for the ``active`` snapshot;
        returns ``(finalize, args)``.  A speculating scheduler runs
        :meth:`_spec_dispatch`; a ``spec_draft`` fault degrades the whole
        tick to the plain chunk (acceptance drops, never exactness: greedy
        rows keep only drafts equal to the target's argmax, and rejection
        sampling corrects any proposal)."""
        if self._speculating:
            try:
                inject("spec_draft")
            except FaultInjected:
                mark_degraded("spec_draft")
                with self.stats.lock:
                    self.stats.spec_fallbacks += 1
                return self._decode_finalize, self._decode_dispatch(active)
            return self._spec_finalize, self._spec_dispatch(active)
        return self._decode_finalize, self._decode_dispatch(active)

    def _pick_gamma(self, active: list[int]) -> int:
        """This chunk's lookahead: the power-of-two bucket of the highest
        per-slot desire (``accept_ewma * gamma``, clamped to [1, gamma]).
        One gamma serves every lane, so the most hopeful lane sets it."""
        g = self.gamma
        if self.adaptive_gamma and active:
            desired = 1
            for i in active:
                slot = self._slots[i]
                if slot.request is None:
                    continue
                want = int(round(slot.accept_ewma * self.gamma))
                desired = max(desired, min(self.gamma, max(1, want)))
            g = spec_decode.gamma_bucket(desired, self.gamma)
        with self.stats.lock:
            self.stats.spec_gamma = g
        return g

    def _spec_dispatch(self, active: list[int]) -> tuple:
        """Dispatch one speculative chunk (draft-model or n-gram rounds)
        without waiting.  Lanes outside the ``active`` snapshot are pinned
        at ``max_len - 1``: the room clamp holds them to one garbage token a
        round, written in the tail zone ``_admit_limit`` keeps clear.  The
        all-greedy gate is decided here, from the host's temperatures."""
        t_dec0 = time.perf_counter()
        lengths, temp, top_p, top_k, max_active = self._lane_state()
        snap = np.zeros((self.max_batch,), dtype=bool)
        snap[active] = True
        lengths = np.where(snap, lengths, self.max_len - 1)
        g = self._pick_gamma(active)
        # Rounds per chunk: about the plain chunk's emission ceiling.
        rounds = max(1, -(-self.decode_chunk_size // (g + 1)))
        kv_bucket = bucket_size(max_active + rounds * (g + 1) + 1, maximum=self.max_len)
        table = None
        if self._pool is not None:
            # Pages for each live lane's whole potential write range; the
            # finalize trims back to what the verifier accepted, so a
            # rejected draft only ever releases pages.
            for i in active:
                slot = self._slots[i]
                live = slot.length + slot.emitted
                self._pool.make_writable(i, max(live - 1, 0), min(live + rounds * (g + 1) + 1, self.max_len))
            table = self._pool.device_table()
        args = (
            self._h2d(self._cur_tok),
            self._h2d(np.minimum(lengths, self.max_len - 1).astype(np.int32)),
            self._gen,
            self._h2d(temp),
            self._h2d(top_p),
            self._h2d(top_k),
            rounds,
            g,
            kv_bucket,
            bool((temp > 0.0).any()),
        )
        if self.draft_cfg is not None:
            pair = (self.params, self.draft_params)
            if table is not None:
                _, _, outs, n_emits = self._spec_chunk(pair, self._cache, table, self._dcache, *args)
            else:
                _, _, outs, n_emits = self._spec_chunk(pair, self._cache, self._dcache, *args)
        elif table is not None:
            _, _, outs, n_emits = self._spec_chunk(self.params, self._cache, table, self._dhist, *args)
        else:
            _, _, outs, n_emits = self._spec_chunk(self.params, self._cache, self._dhist, *args)
        return outs, n_emits, active, g, t_dec0

    def _spec_finalize(self, outs, n_emits, active: list[int], gamma_used: int, t_dec0: float) -> None:
        """Fetch a dispatched speculative chunk and emit its tokens; only
        lanes of the snapshot update ``_cur_tok``."""
        outs_h = outs.cpu().numpy()
        n_h = n_emits.cpu().numpy()
        last = outs_h[-1, np.arange(self.max_batch), np.maximum(n_h[-1] - 1, 0)]
        if active:
            self._cur_tok[active] = last[active]
        self._consume_spec_outs(outs_h, n_h, active, gamma_used)
        if self._pool is not None:
            # Page rollback of rejected drafts: each lane's accounted length
            # counts accepted tokens only.  Lanes that finished mid-chunk
            # were trimmed (parked) or reset by _finish.
            for i in active:
                slot = self._slots[i]
                if slot.request is not None and slot.warm_pos is None:
                    self._pool.trim(i, slot.length + slot.emitted)
        with self.stats.lock:
            self.stats.decode_s += time.perf_counter() - t_dec0
            self.stats.decode_chunks += 1

    def _consume_spec_outs(self, outs_h: np.ndarray, n_h: np.ndarray, active: list[int], gamma_used: int) -> None:
        """Emit each round's accepted tokens per snapshot lane and account
        acceptance.  ``n_h[r, i]`` counts verifier-accepted tokens (plus the
        correction or bonus token), so a rejected draft never reaches
        ``_handle_token``: never ``slot.history``, a parked segment or the
        radix index.  A lane that finishes mid-chunk drops its later
        rounds."""
        rounds = tokens = proposed = accepted_total = 0
        for r in range(outs_h.shape[0]):
            for i in active:
                slot = self._slots[i]
                req = slot.request
                if req is None:
                    continue
                sp = req.sampling
                # Unfiltered sampled rows emit one token a round by design:
                # speculation buys them nothing, so their desire decays.
                counted = sp.temperature <= 0.0 or sp.top_p < 1.0 or sp.top_k > 0
                n = int(n_h[r, i])
                accepted = min(max(n - 1, 0), gamma_used)
                rate = 0.0
                if counted:
                    rounds += 1
                    proposed += gamma_used
                    accepted_total += accepted
                    rate = accepted / gamma_used
                slot.accept_ewma += 0.3 * (rate - slot.accept_ewma)
                for j in range(n):
                    self._handle_token(i, int(outs_h[r, i, j]))
                    if counted:
                        tokens += 1
                    if slot.request is None:
                        break
        with self.stats.lock:
            self.stats.spec_rounds += rounds
            self.stats.spec_tokens += tokens
            self.stats.spec_proposed += proposed
            self.stats.spec_accepted += accepted_total
            if proposed:
                self.stats.spec_acceptance_ewma += 0.2 * (accepted_total / proposed - self.stats.spec_acceptance_ewma)
        self._flush_tokens()
