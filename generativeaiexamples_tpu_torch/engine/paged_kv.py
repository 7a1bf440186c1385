"""Paged KV pool (port of ``engine/paged_kv.py``): fixed-size int8 KV
pages, per-slot page tables, and a refcounted free-list allocator.

KV lives in flat pool leaves on one device: values ``(L, KH, P, HD)``
int8, scales ``(L, KH, P)`` bf16 with ``P = total_pages * page_tokens``.
Each scheduler slot maps logical token positions to pool pages through a
``(max_batch, n_slot_pages)`` int32 page table: logical token ``t`` of
slot ``b`` lives at pool slot ``table[b, t // pt] * pt + t % pt``.
Grafting a prefix is a host table copy plus refcount increments (no
device work; ``PAGE_EVENTS`` counts both sides), divergent appends
copy-on-write only the boundary page, and parking holds exactly
``ceil(len / page_tokens)`` pages.

Layout invariants the attention and flush paths rely on:

* **Page 0 is the garbage page**: permanently refcounted, never in the
  free list, and the target of every unowned table entry.  Masked-lane
  writes (lanes pinned at ``max_len - 1``, append-buffer flush garbage,
  padded prefill tails beyond the owned range) land there, so they never
  touch a live or shared page; masked reads of it weigh exactly zero in
  the attention core.
* **A shared page is read-only**: a write into a page whose refcount
  exceeds 1 is preceded by :meth:`PagedKVPool.make_writable`, which
  installs a private copy for the writing slot.
* **Deadlock-freedom**: ``total_pages`` is floored at
  ``max_batch * n_slot_pages + 1``, so once parked segments are evicted a
  free page always exists for an allocation or a copy-on-write.
  :class:`PoolExhausted` is defensive, not expected.

All bookkeeping is numpy on the host; the device sees the flat leaves
and the uploaded table.  Not thread-safe: the scheduler loop owns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import host_to_device

# Host-side dispatch counters: nothing on the paged graft path launches
# device work, and tests assert it by watching ``device_graft_dispatch``
# (bumped by the scheduler's device-copy graft of the contiguous cache)
# stay flat while ``host_grafts`` advances.  ``cow_copies`` counts pages
# privatized by make_writable; each batched copy bumps ``cow_dispatch``.
PAGE_EVENTS = {
    "device_graft_dispatch": 0,
    "host_grafts": 0,
    "cow_copies": 0,
    "cow_dispatch": 0,
}


class PoolExhausted(RuntimeError):
    """No free page for a required allocation (unreachable at the floor
    sizing; raised so an accounting bug fails loudly)."""


def num_slot_pages(max_len: int, page_tokens: int) -> int:
    """Table width: pages needed to cover one slot's ``max_len`` tokens."""
    return -(-max_len // page_tokens)


def _copy_pages(leaves, src: list[int], dst: list[int], page_tokens: int) -> None:
    """Copy whole pages ``src[i] -> dst[i]`` inside every leaf, in place,
    on the current stream: one gather and one scatter per leaf over a
    ``(..., total_pages, page_tokens, ...)`` view.  ``dst`` pages are
    fresh, so no pair reads a page another pair writes."""
    s, d = (host_to_device(torch.tensor(x, dtype=torch.long), leaves[0].device) for x in (src, dst))
    for leaf in leaves:
        pages = leaf.view(*leaf.shape[:2], -1, page_tokens, *leaf.shape[3:])
        pages[:, :, d] = pages[:, :, s]


class PagedKVPool:
    """Host-side allocator plus device leaves for the paged KV cache."""

    def __init__(
        self,
        cfg,
        max_batch: int,
        max_len: int,
        page_tokens: int,
        total_pages: Optional[int] = None,
        *,
        device,
        mesh=None,
    ):
        """``mesh`` is ``(Mesh, state key)`` for a controller's pool whose
        leaves live on the mesh's ranks, each rank holding its KV heads'
        pages (``engine.mesh_serving``): the bookkeeping stays here, the
        leaves are None, and the copies and resets run on every rank
        through ``Mesh.run``."""
        if getattr(cfg, "kv_dtype", None) != "int8":
            raise ValueError(
                "paged KV cache requires kv_dtype='int8' (per-page scale "
                "leaves mirror the int8 cache layout)"
            )
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1: {page_tokens}")
        self.device = torch.device(device)
        self.page_tokens = int(page_tokens)
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.n_slot_pages = num_slot_pages(max_len, page_tokens)
        floor = self.max_batch * self.n_slot_pages + 1
        self.total_pages = max(int(total_pages or 0), floor)

        p = self.total_pages * self.page_tokens
        shape = (cfg.n_layers, cfg.n_kv_heads, p, cfg.head_dim)
        self.mesh = mesh
        self.leaves = None if mesh is not None else (
            torch.zeros(shape, dtype=torch.int8, device=self.device),
            torch.zeros(shape, dtype=torch.int8, device=self.device),
            torch.zeros(shape[:-1], dtype=torch.bfloat16, device=self.device),
            torch.zeros(shape[:-1], dtype=torch.bfloat16, device=self.device),
        )
        # refcount[0] stays >= 1 forever: the garbage page is never
        # allocated and never freed.
        self._refcount = np.zeros(self.total_pages, np.int32)
        self._refcount[0] = 1
        self._free = list(range(self.total_pages - 1, 0, -1))
        self.tables = np.zeros((self.max_batch, self.n_slot_pages), np.int32)
        # Leading table entries currently owned (allocated or shared).
        self._held = np.zeros(self.max_batch, np.int32)
        self._dirty = True
        self._device_table: Optional[torch.Tensor] = None
        # Monotonic counters: pages privatized by COW (the
        # ``engine_kv_cow_breaks_total`` counter) and pages returned to
        # the free list.
        self.cow_breaks = 0
        self.frees_total = 0

    # ---- gauges -----------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages with refcount > 1 (held by several owners; COW-armed)."""
        return int((self._refcount[1:] > 1).sum())

    def slot_pages(self, slot: int) -> int:
        return int(self._held[slot])

    # ---- device views ----------------------------------------------

    def device_table(self) -> torch.Tensor:
        """The (max_batch, n_slot_pages) int32 table on the device,
        uploaded only when host state changed since the last call.

        The upload reads a private copy of ``self.tables``: the host
        mutates the table on the next tick while a non-blocking copy may
        still be in flight."""
        if self._dirty or self._device_table is None:
            self._device_table = host_to_device(torch.from_numpy(self.tables.copy()), self.device)
            self._dirty = False
        return self._device_table

    # ---- allocation -------------------------------------------------

    def _alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"no free KV page (total={self.total_pages})")
        pg = self._free.pop()
        self._refcount[pg] = 1
        return pg

    def _deref(self, pg: int) -> None:
        if pg == 0:
            return
        self._refcount[pg] -= 1
        if self._refcount[pg] == 0:
            self._free.append(pg)
            self.frees_total += 1

    def reset_slot(self, slot: int) -> None:
        """Release every page the slot holds; its table row goes back to
        all-garbage (page 0)."""
        h = int(self._held[slot])
        for j in range(h):
            self._deref(int(self.tables[slot, j]))
        if h:
            self.tables[slot, :h] = 0
            self._dirty = True
        self._held[slot] = 0

    def trim(self, slot: int, n_tokens: int) -> None:
        """Release pages beyond ``ceil(n_tokens / page_tokens)``; a page
        another slot still references survives its refcount."""
        keep = num_slot_pages(max(int(n_tokens), 0), self.page_tokens)
        h = int(self._held[slot])
        for j in range(keep, h):
            self._deref(int(self.tables[slot, j]))
            self.tables[slot, j] = 0
        if h > keep:
            self._dirty = True
            self._held[slot] = keep

    def share(self, src: int, dst: int, n_tokens: int) -> None:
        """Zero-copy graft: ``dst`` references ``src``'s first
        ``ceil(n_tokens / page_tokens)`` pages (boundary page included: a
        later divergent append into it COWs).  Host work only; ``dst``
        must hold no pages."""
        n = num_slot_pages(max(int(n_tokens), 0), self.page_tokens)
        if self._held[dst]:
            raise ValueError(f"share target slot {dst} still holds pages; reset first")
        for j in range(n):
            pg = int(self.tables[src, j])
            self.tables[dst, j] = pg
            if pg:
                self._refcount[pg] += 1
        self._held[dst] = n
        self._dirty = True
        PAGE_EVENTS["host_grafts"] += 1

    # ---- segment ownership ------------------------------------------
    #
    # The radix prefix index (engine.prefix_cache) owns parked prefixes as
    # page lists: parking detaches the pages from the finishing slot, a
    # prefix hit shares them into the slot the admission claims, and
    # evicting the segment releases them.  Refcount transfers only.

    def detach(self, slot: int) -> list[int]:
        """Transfer the slot's held pages out: returns the page ids (the
        caller now owns their references) and clears the table row
        without dereferencing."""
        h = int(self._held[slot])
        pages = [int(self.tables[slot, j]) for j in range(h)]
        if h:
            self.tables[slot, :h] = 0
            self._dirty = True
        self._held[slot] = 0
        return pages

    def release(self, pages) -> None:
        """Drop one reference per page (segment eviction)."""
        for pg in pages:
            self._deref(int(pg))

    def share_pages(self, pages, dst: int, n_tokens: int) -> None:
        """Zero-copy graft from a parked segment's page list: ``dst``
        references the first ``ceil(n_tokens / page_tokens)`` of
        ``pages``.  ``dst`` must hold no pages."""
        n = num_slot_pages(max(int(n_tokens), 0), self.page_tokens)
        if n > len(pages):
            raise ValueError(f"segment holds {len(pages)} pages; {n} needed for {n_tokens} tokens")
        if self._held[dst]:
            raise ValueError(f"share target slot {dst} still holds pages; reset first")
        for j in range(n):
            pg = int(pages[j])
            self.tables[dst, j] = pg
            if pg:
                self._refcount[pg] += 1
        self._held[dst] = n
        self._dirty = True
        PAGE_EVENTS["host_grafts"] += 1

    def make_writable(self, slot: int, start_tok: int, end_tok: int) -> None:
        """Make the pages covering tokens ``[start_tok, end_tok)`` private
        to ``slot``: allocate missing pages, copy-on-write shared ones (one
        batched copy for the call).  Pages wholly before ``start_tok``
        stay shared."""
        if end_tok <= start_tok:
            return
        pt = self.page_tokens
        first = max(int(start_tok), 0) // pt
        last = num_slot_pages(min(int(end_tok), self.max_len), pt)
        cow_src, cow_dst = [], []
        changed = False
        for j in range(first, last):
            if j >= self._held[slot]:
                self.tables[slot, j] = self._alloc()
                changed = True
            else:
                pg = int(self.tables[slot, j])
                if pg == 0:
                    self.tables[slot, j] = self._alloc()
                    changed = True
                elif self._refcount[pg] > 1:
                    fresh = self._alloc()
                    cow_src.append(pg)
                    cow_dst.append(fresh)
                    self._refcount[pg] -= 1
                    self.tables[slot, j] = fresh
                    changed = True
        self._held[slot] = max(int(self._held[slot]), last)
        if changed:
            self._dirty = True
        if cow_src:
            if self.mesh is not None:
                self.mesh[0].run(_rank_copy_pages, self.mesh[1], cow_src, cow_dst, pt)
            else:
                _copy_pages(self.leaves, cow_src, cow_dst, pt)
            PAGE_EVENTS["cow_copies"] += len(cow_src)
            PAGE_EVENTS["cow_dispatch"] += 1
            self.cow_breaks += len(cow_src)

    def reset_all(self) -> None:
        """Recovery reset: every reference is dropped (slot tables and
        whatever parked segments hold; the caller clears its index in the
        same recovery) and the leaves are zeroed."""
        self._refcount[:] = 0
        self._refcount[0] = 1
        self._free = list(range(self.total_pages - 1, 0, -1))
        self.tables[:] = 0
        self._held[:] = 0
        self._dirty = True
        if self.mesh is not None:
            self.mesh[0].run(_rank_zero_pool, self.mesh[1])
            return
        for leaf in self.leaves:
            leaf.zero_()


def _rank_copy_pages(ctx, key: str, src: list[int], dst: list[int], page_tokens: int) -> None:
    """A mesh rank's half of :meth:`PagedKVPool.make_writable`'s copies."""
    _copy_pages(ctx.state[key].cache, src, dst, page_tokens)


def _rank_zero_pool(ctx, key: str) -> None:
    for leaf in ctx.state[key].cache:
        leaf.zero_()
