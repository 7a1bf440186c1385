"""Policy-driven request placement over a pool of scheduler replicas (port
of ``engine/router.py``).

Every request the ``engine.replica.EnginePool`` takes lands on exactly one
replica, and where it lands decides whether the replica's prefix cache
fires or the prompt prefills cold.

Placement policies (``--routing-policy`` on the engine server):

* ``prefix``: the longest cached-prefix match through a router-side
  *mirror* of each replica's radix index (the router cannot read a
  replica's KV, so it records what each replica recently finished in a
  bounded ``PrefixCacheIndex``).  Falls back to least-loaded below
  ``min_prefix`` tokens.  The mirror is a hint: a stale one costs a cold
  prefill, never a wrong answer.
* ``session``: sticky by conversation id; new sessions place
  least-loaded.
* ``least_loaded``: fewest queued + active slots; equal loads rotate so
  cold traffic spreads.
* ``round_robin``: strict rotation over the placeable replicas.

Every policy but ``round_robin`` is weighted by the replica's 0-1
brownout score (``engine/health.py``): a straggler's load is inflated by
``1/score``, its prefix matches are discounted, and sticky sessions break
off it below ``session_break``.  The session map keeps at most
``max_sessions`` entries, least recently used first out
(``session_evictions_total`` counts them).

Host bookkeeping only, and not synchronized: the owning pool calls it
under its own lock.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

from generativeaiexamples_tpu_torch.engine.prefix_cache import PrefixCacheIndex

POLICIES = ("prefix", "session", "least_loaded", "round_robin")

# The scheduler's MIN_PREFIX: below it a replica would not take the
# suffix-prefill path, so affinity buys nothing.
MIN_PREFIX = 32

_MIN_SCORE = 1e-3


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """What placement sees of one placeable replica: its index, its load
    (queued + active slots) and its brownout score."""

    idx: int
    load: int
    score: float = 1.0


class Router:
    def __init__(
        self,
        policy: str = "prefix",
        *,
        min_prefix: int = MIN_PREFIX,
        mirror_max_segments: int = 128,
        max_sessions: int = 10000,
        session_break: float = 0.5,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; choose from {POLICIES}")
        self.policy = policy
        self.min_prefix = min_prefix
        self.mirror_max_segments = mirror_max_segments
        self.max_sessions = max_sessions
        self.session_break = session_break
        self.session_evictions_total = 0
        self._rr = 0
        self._sessions: OrderedDict[str, int] = OrderedDict()
        self._mirrors: dict[int, PrefixCacheIndex] = {}
        self._seg_next: dict[int, int] = {}

    # -- placement ---------------------------------------------------------

    def select(self, token_ids: Sequence[int], session_id: str, candidates: Sequence[ReplicaView]) -> int:
        """The replica index for a prompt; ``candidates`` must not be empty
        (the pool refuses before it asks with none)."""
        if not candidates:
            raise ValueError("select() needs at least one candidate")
        if self.policy == "round_robin":
            self._rr += 1
            return candidates[self._rr % len(candidates)].idx
        if self.policy == "least_loaded":
            return self._least_loaded(candidates)
        if self.policy == "session":
            return self._select_session(session_id, candidates)
        return self._select_prefix(token_ids, candidates)

    @staticmethod
    def _effective_load(c: ReplicaView) -> float:
        # +1 keeps an idle straggler apart from an idle healthy peer; a
        # half-score replica looks twice as loaded.
        return (c.load + 1.0) / max(c.score, _MIN_SCORE)

    def _least_loaded(self, candidates: Sequence[ReplicaView]) -> int:
        low = min(self._effective_load(c) for c in candidates)
        ties = [c for c in candidates if self._effective_load(c) == low]
        # Rotate through equal loads, or an idle pool sends every cold
        # request to the lowest index.
        self._rr += 1
        return ties[self._rr % len(ties)].idx

    def _select_session(self, session_id: str, candidates: Sequence[ReplicaView]) -> int:
        if session_id:
            idx = self._sessions.get(session_id)
            if idx is not None:
                sticky = next((c for c in candidates if c.idx == idx), None)
                if sticky is not None and sticky.score >= self.session_break:
                    self._sessions.move_to_end(session_id)
                    return idx
                # The sticky replica is gone or browned out: remap (a cold
                # prefill beats riding a straggler).
        idx = self._least_loaded(candidates)
        if session_id:
            self._sessions[session_id] = idx
            self._sessions.move_to_end(session_id)
            self._evict_sessions()
        return idx

    def _evict_sessions(self) -> None:
        if self.max_sessions <= 0:
            return
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
            self.session_evictions_total += 1

    def _select_prefix(self, token_ids: Sequence[int], candidates: Sequence[ReplicaView]) -> int:
        best_idx: Optional[int] = None
        best_weight = 0.0
        for c in candidates:
            mirror = self._mirrors.get(c.idx)
            if mirror is None:
                continue
            seg, n = mirror.match(token_ids)
            # A match on a browned-out replica is worth less: warm KV on a
            # straggler can still lose to a peer's cold prefill.
            weight = n * c.score
            if seg is not None and weight >= self.min_prefix and weight > best_weight:
                best_idx, best_weight = c.idx, weight
        if best_idx is not None:
            return best_idx
        return self._least_loaded(candidates)

    # -- replica-state feedback -------------------------------------------

    def note_finished(self, idx: int, history: Sequence[int]) -> None:
        """A request finished normally on replica ``idx`` with this history
        (prompt + output): the replica likely parked its KV, so the mirror
        learns the segment."""
        if len(history) < self.min_prefix:
            return
        mirror = self._mirrors.get(idx)
        if mirror is None:
            mirror = PrefixCacheIndex(max_segments=self.mirror_max_segments)
            self._mirrors[idx] = mirror
        seg = self._seg_next.get(idx, 0)
        self._seg_next[idx] = seg + 1
        mirror.insert(seg, history)

    def drop_replica(self, idx: int) -> None:
        """Forget a replica that failed, detached or was ejected: its mirror
        is stale and its sticky sessions remap."""
        self._mirrors.pop(idx, None)
        self._seg_next.pop(idx, None)
        for sid in [s for s, i in self._sessions.items() if i == idx]:
            del self._sessions[sid]
