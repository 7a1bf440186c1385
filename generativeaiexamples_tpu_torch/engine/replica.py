"""Replica pool (port of ``engine/replica.py``): data-parallel ``Scheduler``
replicas behind one submit/cancel surface, with health-checked failover and
graceful drain.

The reference scales NIM horizontally with a load balancer in front of
identical containers; this is the in-process equivalent.  An
``EnginePool`` owns N ``Scheduler`` replicas, each with its own tick
thread and KV cache (on one card they share the device and, when the
server builds them, one weight tree), and places every request through an
``engine.router.Router`` policy.  The scheduler itself knows nothing of
the pool: placement, admission backpressure, health, requeue and drain
all live here.

Contract per request:

* **Placement** — the router picks a replica; if its admission queue is
  full the pool falls back through the remaining placeable replicas by
  load, and only when EVERY queue is full does ``submit`` return False
  (the HTTP front maps that to 429 — global backpressure).
* **Failover** — a replica whose tick thread dies, or whose tick counter
  freezes for ``stall_timeout`` seconds, is marked unhealthy.  Its
  placed requests that have not yet emitted a token are requeued to a
  surviving replica (the client never notices beyond latency); requests
  already mid-generation get ``on_done("error")``, which the HTTP layer
  surfaces as a retryable 503.
* **Cancel beats requeue** — a request cancelled while queued at a
  draining/failing replica finishes as ``cancelled``, never as a
  resurrected generation on a survivor (the pool's cancelled flag is
  checked under the same lock that drives requeue).
* **Drain** — ``drain(i)`` stops new placements on replica ``i``,
  migrates its queued-but-unadmitted requests to healthy survivors, lets
  in-flight generations finish, then detaches (stops the scheduler).
* **Gray-failure tolerance** (``engine/health.py``) — the binary
  dead/stalled monitor cannot see a slow-but-alive replica, so every
  health pass also scores each replica 0-1 from its TSDB signals.  The
  router weights placement by score; a replica browned out for
  ``eject_after_s`` is EJECTED (unroutable, requests migrated, scheduler
  kept ticking so recovery stays observable, ``pool_size`` shrinks so
  the autoscaler backfills), re-admitted through PROBATION once its
  score recovers, and a max-ejected-fraction guard keeps correlated
  slowness from emptying the pool.  Short non-streaming requests are
  *hedged*: a backup copy fires to the second-best replica after the
  tracked p95 delay, first response wins, the loser is cancelled, and a
  token bucket caps hedges to a few percent of eligible traffic.

Requeue correctness relies on *epochs*, not on acking the old replica: a
migration bumps the placement's epoch and installs fresh callbacks on a
cloned ``Request``, so anything a zombie replica still emits for the old
epoch is dropped at the wrapper.  The old copy is also cancelled
best-effort so a stalled-but-alive scheduler stops burning slots on it.
Hedging rides the same machinery: the hedge copy is a second live epoch
on the placement, the first branch to emit claims the placement, and the
loser's epoch goes stale (epochs come from a per-placement counter, so a
migration can never collide with a hedge branch).

Lock order: pool lock -> scheduler ``stats.lock`` (the scheduler never
calls request callbacks while holding its stats lock, so wrapper
callbacks taking the pool lock from scheduler threads cannot deadlock).
Client callbacks fired by the pool itself are deferred until the pool
lock is released.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, List, Optional, Sequence

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine.health import (
    HedgeController,
    HedgeTimerWheel,
    ReplicaScorer,
)
from generativeaiexamples_tpu_torch.engine.router import ReplicaView, Router
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler

logger = get_logger(__name__)

HEALTHY = "healthy"
DRAINING = "draining"
UNHEALTHY = "unhealthy"
DETACHED = "detached"
# Gray-failure states: EJECTED replicas are alive but unroutable
# (brownout quarantine); PROBATION replicas take traffic again but one
# relapse re-ejects them without the eject_after_s grace.
EJECTED = "ejected"
PROBATION = "probation"


def _default_health_cfg():
    """The app config's ``health`` section, or library defaults when no
    config is loadable (pools constructed outside the server)."""
    try:
        from generativeaiexamples_tpu_torch.core.configuration import get_config

        return get_config().health
    except Exception:
        from generativeaiexamples_tpu_torch.core.configuration import HealthConfig

        return HealthConfig()


class Replica:
    """One scheduler plus the pool-side view of its health."""

    def __init__(self, idx: int, scheduler: Scheduler) -> None:
        self.idx = idx
        self.scheduler = scheduler
        self.state = HEALTHY
        # (last observed tick_count, when it last changed) for stall
        # detection; -1 sentinel so the first observation always counts
        # as progress.
        self._tick_seen: tuple[int, float] = (-1, time.monotonic())
        # Gray-failure bookkeeping: current brownout score and the
        # monotonic timestamps the ejection state machine dwells on.
        self.score = 1.0
        self.low_since: Optional[float] = None
        self.ok_since: Optional[float] = None
        self.probation_since: Optional[float] = None

    def started(self) -> bool:
        return self.scheduler._thread is not None

    def thread_alive(self) -> bool:
        thread = self.scheduler._thread
        return thread is not None and thread.is_alive()

    def placeable(self) -> bool:
        return self.state in (HEALTHY, PROBATION)

    def load(self) -> int:
        stats = self.scheduler.stats
        with stats.lock:
            return stats.queued + stats.active_slots

    def ticking(self, now: float, stall_timeout: float) -> bool:
        """False iff the tick counter has been frozen for longer than
        ``stall_timeout`` (a live tick loop increments it every pass,
        including idle passes, so a frozen counter means a hung device
        dispatch or a deadlocked loop — not an idle scheduler)."""
        count = self.scheduler.stats.tick_count
        last_count, last_change = self._tick_seen
        if count != last_count:
            self._tick_seen = (count, now)
            return True
        return (now - last_change) <= stall_timeout


class _Placement:
    """Pool-side record of one in-flight request."""

    __slots__ = (
        "req",
        "replica",
        "epoch",
        "epoch_seq",
        "tokens",
        "history",
        "cancelled",
        "done",
        "client_on_token",
        "client_on_done",
        "hedge_epoch",
        "hedge_replica",
        "hedge_timer",
        "hedge_eligible",
        "t_submit",
    )

    def __init__(self, req: Request, replica: int) -> None:
        self.req = req
        self.replica = replica
        self.epoch = 0
        self.epoch_seq = 0
        self.tokens = 0
        self.history: list[int] = []
        self.cancelled = False
        self.done = False
        self.client_on_token = req.on_token
        self.client_on_done = req.on_done
        # Live hedge branch (second concurrent copy), if any.
        self.hedge_epoch: Optional[int] = None
        self.hedge_replica: Optional[int] = None
        self.hedge_timer: Optional[threading.Timer] = None
        self.hedge_eligible = False
        self.t_submit = 0.0

    def next_epoch(self) -> int:
        """Unique epoch per placement: migrations and hedge branches
        draw from one counter so their epochs can never collide."""
        self.epoch_seq += 1
        return self.epoch_seq


class _PoolStats:
    """Duck-types ``Scheduler.stats`` for the HTTP front: the handlers
    and /metrics call ``engine.stats.snapshot()`` on scheduler and pool
    alike."""

    def __init__(self, pool: "EnginePool") -> None:
        self._pool = pool

    def snapshot(self) -> dict:
        return self._pool.snapshot()


class EnginePool:
    """N scheduler replicas + a router, presented as one engine.

    A replica's scheduler may serve over its own mesh, a disjoint slice of
    the host's cards (``engine.server.mesh_plans``, over
    ``parallel.mesh.replica_device_slices``); the pool only routes, so no
    collective spans replicas.  A replica whose mesh lost a rank reads
    unhealthy (``Scheduler.healthy``) and fails over like any other."""

    def __init__(
        self,
        schedulers: Sequence[Scheduler],
        *,
        policy: str = "prefix",
        router: Optional[Router] = None,
        stall_timeout: float = 30.0,
        health_interval: Optional[float] = 0.5,
        mirror_max_segments: int = 128,
        scheduler_factory: Optional[Callable[[], Scheduler]] = None,
        replica_bootstrap: Optional[Callable[[Scheduler], None]] = None,
        health_cfg=None,
        tsdb=None,
        recorder=None,
    ) -> None:
        if not schedulers:
            raise ValueError("EnginePool needs at least one scheduler")
        self.health_cfg = health_cfg if health_cfg is not None else _default_health_cfg()
        self.replicas = [Replica(i, s) for i, s in enumerate(schedulers)]
        for i, s in enumerate(schedulers):
            # The scheduler tags its own per-replica telemetry and fault
            # site with this; re-tag in case schedulers are reused.
            s.replica_index = i
        self.router = router or Router(
            policy,
            mirror_max_segments=mirror_max_segments,
            max_sessions=self.health_cfg.max_sessions,
            session_break=self.health_cfg.session_break_score,
        )
        self.stall_timeout = stall_timeout
        self.health_interval = health_interval
        # Builds a fresh Scheduler for scale_to/add_replica; without one
        # the pool can only shrink.  The autoscaler target the control
        # loop last asked for (scale_to records it; exported as the
        # engine_pool_desired_replicas gauge).
        self.scheduler_factory = scheduler_factory
        # Hydrates a factory-built replica's state (e.g. vector-store
        # snapshot restore via durability.hydrate_store) before it joins
        # the pool — scale-up serves the existing corpus immediately
        # instead of re-embedding it.  Best-effort: a bootstrap failure
        # still attaches the replica (it fills lazily).
        self.replica_bootstrap = replica_bootstrap
        self.desired_replicas = len(self.replicas)
        self.stats = _PoolStats(self)
        self._lock = threading.Lock()
        self._placements: dict[str, _Placement] = {}
        # Client-visible rejections only (a replica queue that was full
        # while a sibling accepted does NOT count here; per-replica
        # rejected_total still records the attempt).
        self.rejected_total = 0
        self.failovers_total = 0
        self.requeued_total = 0
        # Gray-failure layer: scorer + hedge policy share the pool's
        # TSDB handle (injectable for hermetic tests and bench phases).
        self._tsdb = tsdb
        self._recorder = recorder
        self.scorer = ReplicaScorer(self.health_cfg, tsdb)
        self.hedger = HedgeController(self.health_cfg)
        self._hedge_wheel = HedgeTimerWheel()
        self.ejections_total = 0
        self.readmissions_total = 0
        self._running = False
        self._monitor: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        for r in self.replicas:
            if r.state != DETACHED:
                r.scheduler.start()
        if self.health_interval:
            self._monitor = threading.Thread(target=self._watch, daemon=True)
            self._monitor.start()
        logger.info(
            "engine pool started: %d replicas, policy %s",
            len(self.replicas),
            self.router.policy,
        )

    def stop(self) -> None:
        self._running = False
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None
        with self._lock:
            timers = [
                p.hedge_timer
                for p in self._placements.values()
                if p.hedge_timer is not None
            ]
        for timer in timers:
            timer.cancel()
        self._hedge_wheel.stop()
        for r in self.replicas:
            if r.state != DETACHED:
                r.scheduler.stop()

    def _watch(self) -> None:
        while self._running:
            # Feed first, then check: the scoring pass inside
            # check_replicas reads the gauges this pass just recorded.
            try:
                self._feed_tsdb()
            except Exception:
                logger.exception("replica telemetry feed failed")
            try:
                self.check_replicas()
            except Exception:
                logger.exception("replica health check failed")
            time.sleep(self.health_interval)

    @property
    def tsdb(self):
        if self._tsdb is None:
            from generativeaiexamples_tpu_torch.obs.tsdb import get_tsdb

            self._tsdb = get_tsdb()
        return self._tsdb

    def _feed_tsdb(self) -> None:
        """Per-replica health/queue/slot/latency gauges into the fleet
        TSDB, once per health interval — ``/debug/timeseries`` shows
        which replica a failover drained and when it came back, and the
        latency series feed the brownout scorer."""
        db = self.tsdb
        with self._lock:
            # Detached replicas are excluded: their series were dropped
            # at detach time and must not resurrect.
            states = [
                (r.idx, r.state, r.score, r.scheduler)
                for r in self.replicas
                if r.state != DETACHED
            ]
            size = sum(
                1 for _, state, _, _ in states
                if state in (HEALTHY, PROBATION)
            )
            desired = self.desired_replicas
        db.record("engine.pool_size", size)
        db.record("engine.pool_desired", desired)
        for idx, state, score, scheduler in states:
            healthy = 1.0 if state in (HEALTHY, PROBATION) else 0.0
            db.record(f"engine.replica.{idx}.healthy", healthy)
            db.record(f"engine.replica.{idx}.score", score)
            stats = getattr(scheduler, "stats", None)
            if stats is None:
                continue
            with stats.lock:
                queued = stats.queued
                active = stats.active_slots
                ttft_sum = stats.ttft_sum
                ttft_count = stats.ttft_count
            db.record(f"engine.replica.{idx}.queued", queued)
            db.record(f"engine.replica.{idx}.active_slots", active)
            # tick_ms_norm_ewma is single-writer (the tick thread); a
            # torn read is impossible for a Python float.  The
            # token-NORMALIZED value feeds the straggler scorer so a
            # speculating replica's multi-token ticks don't read as
            # latency (falls back to the raw EWMA for duck-typed stats).
            db.record(
                f"engine.replica.{idx}.tick_ms",
                getattr(stats, "tick_ms_norm_ewma", 0.0)
                or stats.tick_ms_ewma,
            )
            if ttft_count:
                db.record(
                    f"engine.replica.{idx}.ttft_ms",
                    ttft_sum / ttft_count * 1000.0,
                )

    # -- request surface (Scheduler-compatible) ---------------------------

    def submit(self, request: Request) -> bool:
        """Place and enqueue a request; False means every placeable
        replica's admission queue is full (HTTP front: 429)."""
        if not request.id:
            # Tracking (cancel, requeue) is keyed by id; direct callers
            # that did not set one get a pool-generated id.
            request.id = f"pool-{uuid.uuid4().hex[:16]}"
        with self._lock:
            views = self._views_locked()
            if not views:
                self.rejected_total += 1
                return False
            primary = self.router.select(
                request.token_ids, request.session_id, views
            )
            placement = _Placement(request, primary)
            request.on_token, request.on_done = self._wrap(placement, 0)
            # Placement must be registered BEFORE submit: the scheduler
            # thread may finish the request before submit returns.
            self._placements[request.id] = placement
            order = [primary] + [
                v.idx
                for v in sorted(views, key=lambda v: v.load)
                if v.idx != primary
            ]
            for idx in order:
                placement.replica = idx
                if self.replicas[idx].scheduler.submit(request):
                    placement.t_submit = time.monotonic()
                    self._maybe_arm_hedge_locked(placement, views)
                    return True
            del self._placements[request.id]
            request.on_token = placement.client_on_token
            request.on_done = placement.client_on_done
            self.rejected_total += 1
            return False

    def _maybe_arm_hedge_locked(
        self, placement: _Placement, views: Sequence[ReplicaView]
    ) -> None:
        """Arm the hedge timer for an eligible request: short,
        explicitly hedgeable (non-streaming front paths set the flag),
        and with a second replica to hedge to.  The timer fires after
        the tracked p95 of eligible-request latency, so a healthy pool
        almost never hedges."""
        hedger = self.hedger
        if not hedger.enabled or not getattr(placement.req, "hedgeable", False):
            return
        if len(views) < 2:
            return
        if placement.req.sampling.max_tokens > self.health_cfg.hedge_max_tokens:
            return
        placement.hedge_eligible = True
        hedger.note_submit()
        if not hedger.ready:
            # Still learning the latency distribution: the request
            # feeds the estimator but cannot hedge yet.
            return
        placement.hedge_timer = self._hedge_wheel.arm(
            hedger.delay_ms() / 1000.0, self._hedge_fire, placement.req.id
        )

    def _hedge_fire(self, request_id: str) -> None:
        """Timer body: the primary has been slow for a p95's worth of
        time — fire a backup copy to the best alternative replica if the
        budget allows and the request is still token-less."""
        with self._lock:
            placement = self._placements.get(request_id)
            if (
                placement is None
                or placement.done
                or placement.cancelled
                or placement.tokens > 0
                or placement.hedge_epoch is not None
            ):
                return
            placement.hedge_timer = None
            views = [
                v for v in self._views_locked() if v.idx != placement.replica
            ]
            if not views:
                return
            if not self.hedger.try_spend():
                return
            target = min(
                views, key=lambda v: (v.load + 1.0) / max(v.score, 1e-3)
            )
            epoch = placement.next_epoch()
            old = placement.req
            clone = Request(
                token_ids=list(old.token_ids),
                sampling=old.sampling,
                on_token=lambda tid: None,
                on_done=lambda reason: None,
                eos_id=old.eos_id,
                id=old.id,
                session_id=old.session_id,
            )
            clone.on_token, clone.on_done = self._wrap(placement, epoch)
            if self.replicas[target.idx].scheduler.submit(clone):
                placement.hedge_epoch = epoch
                placement.hedge_replica = target.idx
                self.hedger.note_fired()

    def cancel(self, request_id: str) -> None:
        """Stop generating for a request wherever it currently lives.
        Recording the flag and reading the current replica under the
        pool lock is what makes cancel win over a concurrent requeue."""
        if not request_id:
            return
        with self._lock:
            placement = self._placements.get(request_id)
            if placement is None or placement.done:
                return
            placement.cancelled = True
            scheduler = self.replicas[placement.replica].scheduler
            hedge_scheduler = (
                self.replicas[placement.hedge_replica].scheduler
                if placement.hedge_replica is not None
                else None
            )
            timer = placement.hedge_timer
            placement.hedge_timer = None
        if timer is not None:
            timer.cancel()
        scheduler.cancel(request_id)
        if hedge_scheduler is not None:
            hedge_scheduler.cancel(request_id)

    # -- health / admin ----------------------------------------------------

    def healthy(self) -> bool:
        """False when any replica is unhealthy or no replica can take
        traffic — the /health endpoint's degraded signal."""
        with self._lock:
            if any(r.state == UNHEALTHY for r in self.replicas):
                return False
            return any(r.placeable() for r in self.replicas)

    def replica_states(self) -> list[dict]:
        with self._lock:
            return [{"replica": r.idx, "state": r.state} for r in self.replicas]

    def drain(self, idx: int) -> str:
        """Gracefully retire replica ``idx``: no new placements, queued
        requests migrate to healthy survivors, in-flight generations run
        to completion, then the replica detaches.  Returns the replica's
        state after this call."""
        if not 0 <= idx < len(self.replicas):
            raise ValueError(f"no replica {idx}")
        actions: List[Callable[[], None]] = []
        with self._lock:
            replica = self.replicas[idx]
            if replica.state in (UNHEALTHY, DETACHED):
                return replica.state
            replica.state = DRAINING
            self.router.drop_replica(idx)
            survivors = [r for r in self.replicas if r.placeable()]
            if survivors:
                for placement in [
                    p
                    for p in self._placements.values()
                    if p.replica == idx
                    and not (p.done or p.cancelled or p.tokens > 0)
                ]:
                    if not self._move_locked(placement, replica, survivors):
                        # The old copy is already cancelled and epoch-
                        # neutered; with every survivor queue full the
                        # request must fail loudly, not hang.
                        self._abort_locked(placement, "error", actions)
            # Without survivors the queued requests stay and finish on
            # the draining replica — drain just blocks new placements.
            self._maybe_detach_locked(replica, actions)
        for act in actions:
            act()
        return self.replicas[idx].state

    # -- elasticity --------------------------------------------------------

    def pool_size(self) -> int:
        """Placeable replica count — the serving capacity the autoscaler
        compares against its desired target.  EJECTED replicas are
        excluded on purpose: quarantined capacity reads as missing, so
        the autoscaler backfills instead of double-counting a straggler
        as serving headroom."""
        with self._lock:
            return sum(
                1 for r in self.replicas if r.state in (HEALTHY, PROBATION)
            )

    def ejected_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == EJECTED)

    def replica_scores(self) -> dict[int, float]:
        with self._lock:
            return {
                r.idx: r.score
                for r in self.replicas
                if r.state != DETACHED
            }

    def add_replica(self) -> int:
        """Grow the pool by one replica built from ``scheduler_factory``.

        The scheduler is constructed OUTSIDE the pool lock (it allocates a
        KV cache); the new replica joins with a fresh index, starts
        immediately when the pool is running, and picks up router mirror
        and TSDB series lazily — the router and health monitor iterate
        ``self.replicas`` under the pool lock, so mid-flight growth is
        safe.  Returns the new replica's index."""
        if self.scheduler_factory is None:
            raise RuntimeError(
                "EnginePool has no scheduler_factory; cannot scale up"
            )
        scheduler = self.scheduler_factory()
        if self.replica_bootstrap is not None:
            # Outside the pool lock, like construction: snapshot hydration
            # can read hundreds of MB and must not stall the router.
            # Two-parameter hooks also receive the new replica's index
            # (computed here as a hint; the authoritative index is
            # assigned under the lock below) so shard-aware bootstraps
            # can hydrate only the partitions routed to this replica.
            with self._lock:
                idx_hint = len(self.replicas)
            try:
                import inspect

                try:
                    n_params = len(
                        inspect.signature(
                            self.replica_bootstrap
                        ).parameters
                    )
                except (TypeError, ValueError):
                    n_params = 1
                if n_params >= 2:
                    self.replica_bootstrap(scheduler, idx_hint)
                else:
                    self.replica_bootstrap(scheduler)
            except Exception:
                logger.exception(
                    "replica bootstrap failed; attaching cold replica"
                )
        with self._lock:
            idx = len(self.replicas)
            self.replicas.append(Replica(idx, scheduler))
            running = self._running
        if running:
            scheduler.start()
        logger.info("replica %d attached (pool scale-up)", idx)
        return idx

    def scale_to(self, n: int) -> dict:
        """Drive the HEALTHY replica count toward ``n``.

        Scale-up attaches factory-built replicas; scale-down gracefully
        retires the least-loaded healthy replicas through :meth:`drain`
        (queued requests migrate, in-flight generations finish, then the
        replica detaches and its router mirror and per-replica TSDB
        series are cleaned up).  Best-effort: without a factory the pool
        cannot grow, and a replica with in-flight work detaches only
        once it empties.  Returns ``{"size", "added", "drained"}``."""
        n = max(1, int(n))
        self.desired_replicas = n
        added: List[int] = []
        drained: List[int] = []
        while self.pool_size() < n and self.scheduler_factory is not None:
            added.append(self.add_replica())
        with self._lock:
            healthy = sorted(
                (r for r in self.replicas if r.state in (HEALTHY, PROBATION)),
                key=lambda r: (r.load(), -r.idx),
            )
            excess = [r.idx for r in healthy[: max(0, len(healthy) - n)]]
        for idx in excess:
            self.drain(idx)
            drained.append(idx)
        return {"size": self.pool_size(), "added": added, "drained": drained}

    def check_replicas(self, now: Optional[float] = None) -> None:
        """One health pass: detect dead/stalled replicas, fail their
        requests over, detach empty draining replicas, then run the
        gray-failure state machine (score -> eject -> probation ->
        re-admit).  The monitor thread calls this every
        ``health_interval``; tests call it directly."""
        if now is None:
            now = time.monotonic()
        cfg = self.health_cfg
        scores: dict[int, float] = {}
        if cfg.enabled:
            with self._lock:
                live = [
                    r.idx
                    for r in self.replicas
                    if r.state in (HEALTHY, PROBATION, EJECTED)
                ]
            # TSDB reads happen outside the pool lock: scoring must
            # never stall placement.
            try:
                scores = self.scorer.score_all(live)
            except Exception:
                logger.exception("replica scoring failed")
        actions: List[Callable[[], None]] = []
        with self._lock:
            for replica in self.replicas:
                if replica.idx in scores:
                    replica.score = scores[replica.idx]
                if (
                    replica.state in (HEALTHY, DRAINING, PROBATION, EJECTED)
                    and replica.started()
                ):
                    dead = not replica.thread_alive()
                    stalled = not dead and not replica.ticking(
                        now, self.stall_timeout
                    )
                    if dead or stalled:
                        self._fail_replica_locked(
                            replica, "died" if dead else "stalled", actions
                        )
                if replica.state == DRAINING:
                    self._maybe_detach_locked(replica, actions)
            if cfg.enabled:
                self._gray_pass_locked(now, actions)
        for act in actions:
            act()

    def _gray_pass_locked(
        self, now: float, actions: List[Callable[[], None]]
    ) -> None:
        """Ejection state machine over the fresh scores.

        HEALTHY --(score <= eject_threshold for eject_after_s)--> EJECTED
        EJECTED --(score >= readmit_score for readmit_after_s)--> PROBATION
        PROBATION --(any relapse below threshold)--> EJECTED (no grace)
        PROBATION --(probation_s clean)--> HEALTHY

        The fraction guard bounds EJECTED to ``max_eject_fraction`` of
        the live set; with relative scoring a correlated slowdown never
        gets here anyway (everyone's ratio stays ~1), but the guard
        holds even if the signals misbehave.
        """
        cfg = self.health_cfg
        live = [
            r
            for r in self.replicas
            if r.state in (HEALTHY, PROBATION, EJECTED)
        ]
        ejected = sum(1 for r in live if r.state == EJECTED)
        max_ejectable = int(cfg.max_eject_fraction * len(live))
        for replica in live:
            if replica.state in (HEALTHY, PROBATION):
                if replica.score <= cfg.eject_threshold:
                    if replica.low_since is None:
                        replica.low_since = now
                    relapse = replica.state == PROBATION
                    dwelt = (now - replica.low_since) >= cfg.eject_after_s
                    if (relapse or dwelt) and ejected < max_ejectable:
                        self._eject_locked(replica, actions)
                        ejected += 1
                else:
                    replica.low_since = None
                    if (
                        replica.state == PROBATION
                        and replica.probation_since is not None
                        and (now - replica.probation_since) >= cfg.probation_s
                    ):
                        replica.state = HEALTHY
                        replica.probation_since = None
                        self._pin_transition(replica, "restored", actions)
                        logger.info(
                            "replica %d cleared probation", replica.idx
                        )
            elif replica.state == EJECTED:
                if replica.score >= cfg.readmit_score:
                    if replica.ok_since is None:
                        replica.ok_since = now
                    if (now - replica.ok_since) >= cfg.readmit_after_s:
                        replica.state = PROBATION
                        replica.probation_since = now
                        replica.ok_since = None
                        replica.low_since = None
                        self.readmissions_total += 1
                        ejected -= 1
                        self._pin_transition(replica, "readmitted", actions)
                        logger.info(
                            "replica %d re-admitted on probation "
                            "(score %.2f)",
                            replica.idx,
                            replica.score,
                        )
                else:
                    replica.ok_since = None

    def _eject_locked(
        self, replica: Replica, actions: List[Callable[[], None]]
    ) -> None:
        """Quarantine a browned-out replica: unroutable, affinity state
        dropped, queued requests migrated — but the scheduler keeps
        ticking so the scorer can watch it recover (and ``pool_size``
        drops, which is what tells the autoscaler to backfill)."""
        logger.warning(
            "replica %d ejected (brownout score %.2f)",
            replica.idx,
            replica.score,
        )
        replica.state = EJECTED
        replica.low_since = None
        replica.ok_since = None
        replica.probation_since = None
        self.ejections_total += 1
        self.router.drop_replica(replica.idx)
        # Hedge branches parked on the straggler would lose the race
        # anyway; drop them before migrating primaries.
        for placement in self._placements.values():
            if placement.hedge_replica == replica.idx:
                self._discard_hedge_locked(placement)
        survivors = [r for r in self.replicas if r.placeable()]
        for placement in [
            p for p in self._placements.values() if p.replica == replica.idx
        ]:
            if placement.done or placement.cancelled or placement.tokens > 0:
                # Mid-generation work finishes on the straggler: slow
                # beats replayed tokens or a spurious error.
                continue
            if placement.hedge_epoch is not None:
                self._promote_hedge_locked(placement)
                continue
            if survivors and not self._move_locked(
                placement, replica, survivors
            ):
                self._abort_locked(placement, "error", actions)
            # Without survivors queued requests stay put: the replica
            # is alive, just slow.
        self._pin_transition(replica, "ejected", actions)

    def _pin_transition(
        self,
        replica: Replica,
        what: str,
        actions: List[Callable[[], None]],
    ) -> None:
        """Defer a flight-recorder pin for an ejection-family transition
        (same schema-valid shape as the SLO and autoscale pins; the
        non-empty ``degraded`` list is what pins it)."""
        entry = {
            "request_id": f"gray-{what}-{replica.idx}",
            "route": "engine",
            "status": None,
            "error": None,
            "degraded": [f"gray:{what}:{replica.idx}"],
            "total_ms": 0.0,
            "started_at": time.time(),
            "stages": [],
            "attrs": {
                "gray": what,
                "replica": replica.idx,
                "score": round(replica.score, 4),
            },
        }
        actions.append(lambda: self._record_transition(entry))

    def _record_transition(self, entry: dict) -> None:
        recorder = self._recorder
        if recorder is None:
            from generativeaiexamples_tpu_torch.obs.recorder import (
                get_flight_recorder,
            )

            recorder = get_flight_recorder()
        recorder.record(entry)

    # -- internals ---------------------------------------------------------

    def _views_locked(self) -> list[ReplicaView]:
        return [
            ReplicaView(r.idx, r.load(), r.score)
            for r in self.replicas
            if r.placeable()
        ]

    def _claim_hedge_locked(self, placement: _Placement) -> None:
        """The hedge branch produced the first result: it becomes the
        primary, and the old primary copy is cancelled (its epoch goes
        stale, so anything it still emits is dropped)."""
        loser = placement.replica
        placement.replica = placement.hedge_replica
        placement.epoch = placement.hedge_epoch
        placement.hedge_epoch = None
        placement.hedge_replica = None
        self.replicas[loser].scheduler.cancel(placement.req.id)
        self.hedger.note_win()
        self.hedger.note_cancelled()

    def _discard_hedge_locked(self, placement: _Placement) -> None:
        """The primary won (or the hedge's replica is going away): drop
        the hedge branch and cancel its copy."""
        hedge_replica = placement.hedge_replica
        placement.hedge_epoch = None
        placement.hedge_replica = None
        if hedge_replica is not None:
            self.replicas[hedge_replica].scheduler.cancel(placement.req.id)
            self.hedger.note_cancelled()

    def _promote_hedge_locked(self, placement: _Placement) -> None:
        """The primary replica failed or was ejected while a token-less
        hedge copy is live elsewhere: the hedge branch simply becomes
        the primary (no client-visible error, no requeue needed)."""
        placement.replica = placement.hedge_replica
        placement.epoch = placement.hedge_epoch
        placement.hedge_epoch = None
        placement.hedge_replica = None

    def _wrap(
        self, placement: _Placement, epoch: int
    ) -> tuple[Callable[[int], None], Callable[[str], None]]:
        """Callbacks for one (placement, epoch).  A migration bumps the
        placement's epoch, so callbacks from the abandoned copy — a
        zombie replica finishing the cancel, or a racing token — are
        dropped here instead of reaching the client twice.  A hedge
        branch is a second live epoch: the first branch to emit claims
        the placement and the loser is cancelled (first-response-wins)."""

        def on_token(tid: int) -> None:
            with self._lock:
                if placement.done:
                    return
                if epoch == placement.epoch:
                    if placement.hedge_epoch is not None and placement.tokens == 0:
                        # Primary spoke first: the hedge lost the race.
                        self._discard_hedge_locked(placement)
                elif (
                    placement.hedge_epoch is not None
                    and epoch == placement.hedge_epoch
                ):
                    self._claim_hedge_locked(placement)
                else:
                    return
                placement.tokens += 1
                placement.history.append(tid)
                client = placement.client_on_token
            client(tid)

        def on_done(reason: str) -> None:
            timer: Optional[threading.Timer] = None
            latency_ms = 0.0
            with self._lock:
                if placement.done:
                    return
                if epoch == placement.epoch:
                    if (
                        reason not in ("stop", "length")
                        and not placement.cancelled
                        and placement.hedge_epoch is not None
                    ):
                        # Primary errored while a hedge copy is live:
                        # the hedge quietly takes over.
                        self._promote_hedge_locked(placement)
                        return
                elif (
                    placement.hedge_epoch is not None
                    and epoch == placement.hedge_epoch
                ):
                    if reason in ("stop", "length"):
                        self._claim_hedge_locked(placement)
                    else:
                        # The hedge copy itself failed: drop the branch,
                        # the primary is still running.
                        placement.hedge_epoch = None
                        placement.hedge_replica = None
                        return
                else:
                    return
                placement.done = True
                timer = placement.hedge_timer
                placement.hedge_timer = None
                if placement.hedge_epoch is not None:
                    self._discard_hedge_locked(placement)
                self._placements.pop(placement.req.id, None)
                if reason in ("stop", "length"):
                    # Mirror what the replica likely parked so the
                    # prefix policy routes the next matching prompt
                    # back here.
                    self.router.note_finished(
                        placement.replica,
                        list(placement.req.token_ids) + placement.history,
                    )
                    if placement.hedge_eligible and placement.t_submit:
                        latency_ms = (
                            time.monotonic() - placement.t_submit
                        ) * 1000.0
                client = placement.client_on_done
            if timer is not None:
                timer.cancel()
            if latency_ms > 0:
                # Class-EWMA of eligible-request latency: this is what
                # sets the next hedge's trigger delay.
                self.hedger.note_latency(latency_ms)
            client(reason)

        return on_token, on_done

    def _move_locked(
        self,
        placement: _Placement,
        source: Replica,
        survivors: Sequence[Replica],
    ) -> bool:
        """Re-place a zero-token request onto a survivor.  The old copy
        is epoch-neutered and cancelled best-effort; a fresh Request
        clone carries new callbacks so the client stream continues from
        exactly zero emitted tokens."""
        if placement.hedge_epoch is not None:
            self._discard_hedge_locked(placement)
        placement.epoch = placement.next_epoch()
        old = placement.req
        source.scheduler.cancel(old.id)
        clone = Request(
            token_ids=list(old.token_ids),
            sampling=old.sampling,
            on_token=lambda tid: None,
            on_done=lambda reason: None,
            eos_id=old.eos_id,
            id=old.id,
            session_id=old.session_id,
        )
        clone.on_token, clone.on_done = self._wrap(placement, placement.epoch)
        placement.req = clone
        for survivor in sorted(survivors, key=lambda r: r.load()):
            placement.replica = survivor.idx
            if survivor.scheduler.submit(clone):
                self.requeued_total += 1
                return True
        return False

    def _fail_replica_locked(
        self, replica: Replica, why: str, actions: List[Callable[[], None]]
    ) -> None:
        logger.warning(
            "replica %d %s; failing over its requests", replica.idx, why
        )
        replica.state = UNHEALTHY
        replica.scheduler.request_stop()
        self.failovers_total += 1
        self.router.drop_replica(replica.idx)
        # Hedge branches parked on the dead replica die with it; the
        # primaries keep running wherever they are.
        for placement in self._placements.values():
            if placement.hedge_replica == replica.idx:
                placement.hedge_epoch = None
                placement.hedge_replica = None
        survivors = [r for r in self.replicas if r.placeable()]
        for placement in [
            p for p in self._placements.values() if p.replica == replica.idx
        ]:
            if placement.done:
                continue
            if placement.cancelled:
                # Cancel wins over requeue: the dead replica will never
                # deliver the cancelled callback, so the pool does.
                self._abort_locked(placement, "cancelled", actions)
            elif placement.tokens > 0:
                # Mid-generation: restarting would replay tokens the
                # client already holds — surface a retryable error.
                replica.scheduler.cancel(placement.req.id)
                self._abort_locked(placement, "error", actions)
            elif placement.hedge_epoch is not None:
                # A token-less hedge copy is already live elsewhere:
                # cheaper than a requeue, and invisible to the client.
                self._promote_hedge_locked(placement)
            elif not self._move_locked(placement, replica, survivors):
                self._abort_locked(placement, "error", actions)

    def _abort_locked(
        self,
        placement: _Placement,
        reason: str,
        actions: List[Callable[[], None]],
    ) -> None:
        if placement.hedge_epoch is not None:
            self._discard_hedge_locked(placement)
        placement.epoch = placement.next_epoch()  # neuter zombie callbacks
        placement.done = True
        timer = placement.hedge_timer
        placement.hedge_timer = None
        if timer is not None:
            actions.append(timer.cancel)
        self._placements.pop(placement.req.id, None)
        client = placement.client_on_done
        actions.append(lambda: client(reason))

    def _maybe_detach_locked(
        self, replica: Replica, actions: List[Callable[[], None]]
    ) -> None:
        if replica.state != DRAINING:
            return
        if any(
            p.replica == replica.idx and not p.done
            for p in self._placements.values()
        ):
            return
        replica.state = DETACHED
        scheduler = replica.scheduler
        # Joins the tick thread and frees a mesh's rank state — no lock.
        actions.append(scheduler.close)
        idx = replica.idx

        def _drop_series() -> None:
            # The replica's per-replica gauges die with it; a later
            # scale-up reusing the index starts clean rings.
            self.tsdb.drop_series(f"engine.replica.{idx}.")
            self.scorer.drop(idx)

        actions.append(_drop_series)
        logger.info("replica %d drained and detached", replica.idx)

    # -- aggregation -------------------------------------------------------

    # Counters summed across replicas for the aggregate snapshot;
    # "queued"/"active_slots" are gauges but sum the same way.
    _SUM_KEYS = (
        "requests_total",
        "tokens_total",
        "tick_count",
        "prefill_rows",
        "decode_chunks",
        "active_slots",
        "queued",
        "prefix_hits",
        "prefix_tokens_reused",
        "shared_prefix_hits",
        "prefill_chunks",
        "spec_rounds",
        "spec_tokens",
        "spec_proposed",
        "spec_accepted",
        "spec_fallbacks",
        "ttft_count",
        # Paged-KV pool gauges/counters sum across replicas: each
        # replica owns a disjoint page pool, so pool-wide capacity and
        # pressure are the sums (all zero under the contiguous layout).
        "kv_pages_total",
        "kv_pages_free",
        "kv_pages_parked",
        "kv_pages_shared",
        "kv_cow_breaks",
        "kv_page_evictions",
    )

    def snapshot(self) -> dict:
        """Pool-wide stats: aggregate (Scheduler.Stats-compatible keys)
        plus a per-replica breakdown under ``"replicas"``."""
        with self._lock:
            members = [(r, r.state, r.score) for r in self.replicas]
            rejected = self.rejected_total
            failovers = self.failovers_total
            requeued = self.requeued_total
            desired = self.desired_replicas
            ejections = self.ejections_total
            readmissions = self.readmissions_total
            session_evictions = self.router.session_evictions_total
        agg: dict = {k: 0 for k in self._SUM_KEYS}
        agg["prefill_s"] = 0.0
        agg["decode_s"] = 0.0
        ttft_weighted = 0.0
        tick_ewma_max = 0.0
        tick_norm_max = 0.0
        accept_weighted = 0.0
        spec_gamma_max = 0
        ttft_recent: list = []
        replicas = []
        for replica, state, score in members:
            stats = replica.scheduler.stats
            snap = stats.snapshot()
            with stats.lock:
                ttft_recent += stats.ttft_recent
            snap["replica"] = replica.idx
            snap["state"] = state
            snap["healthy"] = (
                1 if state in (HEALTHY, DRAINING, PROBATION) else 0
            )
            snap["score"] = round(score, 4)
            replicas.append(snap)
            for k in self._SUM_KEYS:
                agg[k] += snap.get(k, 0)
            agg["prefill_s"] += snap["prefill_s"]
            agg["decode_s"] += snap["decode_s"]
            ttft_weighted += snap["ttft_avg_ms"] * snap.get("ttft_count", 0)
            accept_weighted += snap.get(
                "spec_acceptance_ewma", 0.0
            ) * snap.get("spec_proposed", 0)
            if state in (HEALTHY, DRAINING, PROBATION):
                tick_ewma_max = max(
                    tick_ewma_max, snap.get("tick_ms_ewma", 0.0)
                )
                tick_norm_max = max(
                    tick_norm_max, snap.get("tick_ms_norm_ewma", 0.0)
                )
                spec_gamma_max = max(
                    spec_gamma_max, snap.get("spec_gamma", 0)
                )
        agg["ttft_avg_ms"] = (
            ttft_weighted / agg["ttft_count"] if agg["ttft_count"] else 0.0
        )
        # The port's TTFT median (``engine_ttft_p50_ms``) over every
        # replica's recent samples.
        ttft_recent.sort()
        agg["ttft_p50_ms"] = (
            ttft_recent[len(ttft_recent) // 2] * 1000 if ttft_recent else 0.0
        )
        # Worst live replica's tick EWMA: the conservative basis for the
        # Retry-After drain estimate on the 429 path (norm twin for
        # consumers calibrated against per-token cost under speculation).
        agg["tick_ms_ewma"] = tick_ewma_max
        agg["tick_ms_norm_ewma"] = tick_norm_max
        # Proposal-weighted acceptance: replicas that speculated more
        # weigh more; idle/non-spec replicas contribute nothing.
        agg["spec_acceptance_ewma"] = round(
            accept_weighted / agg["spec_proposed"], 4
        ) if agg["spec_proposed"] else 0.0
        agg["spec_gamma"] = spec_gamma_max
        # Derived page-pool views for the 429 Retry-After projection and
        # dashboards: utilization over the summed pool, the worst
        # replica's per-admission page need, and the pool-wide free
        # rate (sums — any replica's frees can serve a new admission
        # after routing).
        agg["kv_page_utilization"] = (
            round(1.0 - agg["kv_pages_free"] / agg["kv_pages_total"], 4)
            if agg["kv_pages_total"]
            else 0.0
        )
        agg["kv_pages_per_admit"] = max(
            (s.get("kv_pages_per_admit", 0) for s in replicas), default=0
        )
        agg["kv_page_free_rate"] = round(
            sum(s.get("kv_page_free_rate", 0.0) for s in replicas), 3
        )
        agg["pool_size"] = sum(
            1 for _, state, _ in members if state in (HEALTHY, PROBATION)
        )
        agg["desired_replicas"] = desired
        agg["rejected_total"] = rejected
        agg["router_policy"] = self.router.policy
        agg["router_failovers_total"] = failovers
        agg["router_requeued_total"] = requeued
        agg["ejected_replicas"] = sum(
            1 for _, state, _ in members if state == EJECTED
        )
        agg["ejections_total"] = ejections
        agg["readmissions_total"] = readmissions
        agg["session_evictions_total"] = session_evictions
        agg.update(self.hedger.snapshot())
        agg["replicas"] = replicas
        return agg
