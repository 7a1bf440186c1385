"""The collectives of a mesh: what XLA inserts for the reference's
sharded programs, called explicitly here.

Each mesh axis has one process group per line of ranks along it
(:class:`AxisGroup`).  Its transport follows the devices of that line,
never a failure:

* distinct CUDA devices: NCCL on device tensors;
* CPU ranks: gloo;
* ranks that share one CUDA device (NCCL refuses two ranks on one GPU):
  staged through one host buffer that every rank of the line maps
  (:class:`SharedLine`, a region a rank): each collective copies each
  rank's bytes into its region, and every rank reads the regions it needs
  back, chunk by chunk between gloo barriers, so only the barriers cross
  gloo.  Staged bytes and time are counted in :data:`COMM_STATS`.

Groups are built straight from a ``torch.distributed`` store (a
``file://`` rendezvous in a temporary directory, so concurrent test
workers never contend for a port), not through the process-global default
group, so one process may take part in several meshes.  Every group has a
timeout: a collective whose peer died raises within it.

Half-precision sums run in f32 (each rank's value is widened, the sum
rounded once; through a shared line the half-precision terms move as
they are and are added in f32 on the rank's device in rank order, the
same bits as gloo's for two ranks).  Gathers, all-to-alls, permutes and
broadcasts move bytes (gloo has no 16-bit integer type; bf16 travels as
its bytes).
"""

from __future__ import annotations

import datetime
import mmap
import os
import time
import weakref
from typing import Optional, Sequence

import torch

# Per-process counts of collectives, as ``chip_smoke.py`` and the tests
# read them: collectives run, bytes each moved through host staging (D2H
# plus H2D; 0 on gloo-over-CPU and NCCL), bytes of payload, and wall ms
# (staging included).  ``by_op`` splits the count by collective.
COMM_STATS = {"collectives": 0, "staged_bytes": 0, "payload_bytes": 0, "ms": 0.0, "by_op": {}}


# When a list, every collective appends ``(op, axis, payload bytes)`` to
# it in the order issued (``trace_collectives``): the tests hold the ranks'
# orders equal.
COMM_TRACE: Optional[list] = None


def reset_comm_stats() -> None:
    COMM_STATS.update(collectives=0, staged_bytes=0, payload_bytes=0, ms=0.0, by_op={})


def trace_collectives(on: bool) -> Optional[list]:
    """Start (``True``) or stop recording the order of this process's
    collectives; returns the record so far."""
    global COMM_TRACE
    got = COMM_TRACE
    COMM_TRACE = [] if on else None
    return got


def transport_for(devices: Sequence[torch.device]) -> str:
    """``"nccl"``, ``"gloo"`` or ``"staged"`` for a line of ranks on
    ``devices`` (see the module docstring)."""
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return "gloo"
    if types == {"cuda"}:
        return "nccl" if len(set(devices)) == len(devices) else "staged"
    raise ValueError(f"a mesh axis spans devices of types {sorted(types)}; ranks must be all CPU or all CUDA")


def _gloo_options(timeout_s: float):
    import torch.distributed as dist

    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return opts


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return x.contiguous().reshape(-1).view(torch.uint8)


# Bytes of one rank's region of a shared line: collectives larger than it
# move in chunks of this size (one barrier pair each).
SHARED_REGION_BYTES = 32 << 20


def _unregister(ptr: int, mm) -> None:
    """A shared line's CUDA registration dropped; ``mm``, its mapping, is
    held until then."""
    torch.cuda.cudart().cudaHostUnregister(ptr)


class SharedLine:
    """A host buffer every rank of one line maps, one region a rank: an
    anonymous shared-memory file (``memfd_create``; it does not count
    against ``/dev/shm``, which a container may cap at 64 MB), which the
    first rank makes and the others open through ``/proc``.  A collective
    runs in rounds: each rank copies a chunk of its bytes into its region
    (or, for an all-to-all, one sub-slot per receiver), a barrier, each
    rank copies the chunks it needs from the others' regions, a barrier.
    The barriers are gloo's (``pg``, a gloo group over the line); no
    payload crosses gloo.  Every rank of the line issues the same rounds
    (the sizes are equal on all ranks)."""

    PATH_BYTES = 256

    def __init__(self, mm, pg, index: int, size: int):
        self._mm = mm
        self._pg = pg
        self.buf = torch.frombuffer(mm, dtype=torch.uint8)
        self.index, self.size = index, size
        self.region = self.buf.numel() // size

    @classmethod
    def open(cls, pg, index: int, size: int, device: torch.device) -> "SharedLine":
        """The line's buffer: the first rank makes the file and broadcasts
        its ``/proc`` path over ``pg``; each rank maps it, and the file
        lives on in the mappings alone.  For ranks on a card (``device``)
        each rank registers its mapping with CUDA, so the copies between
        the card and the line are direct transfers from page-locked
        memory, not staged again through CUDA's own bounce buffers."""
        import torch.distributed as dist

        need = size * SHARED_REGION_BYTES
        name = torch.zeros(cls.PATH_BYTES, dtype=torch.uint8)
        fd = -1
        if index == 0:
            fd = os.memfd_create("gaie-mesh-line")
            os.ftruncate(fd, need)
            raw = f"/proc/{os.getpid()}/fd/{fd}".encode()
            name[: len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        pg.broadcast([name], opts).wait()
        try:
            if index != 0:
                fd = os.open(bytes(name[name != 0].tolist()).decode(), os.O_RDWR)
            mm = mmap.mmap(fd, need)
        finally:
            pg.barrier().wait()  # every rank has the file open before the first closes it
            if fd >= 0:
                os.close(fd)
        line = cls(mm, pg, index, size)
        if torch.device(device).type == "cuda":
            cudart = torch.cuda.cudart()
            ptr = line.buf.data_ptr()
            err = cudart.cudaHostRegister(ptr, need, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of a {need}-byte shared line failed: {err}")
            weakref.finalize(line, _unregister, ptr, mm)
        return line

    def _rounds(self, n: int, slot: int, write, read) -> None:
        for off in range(0, n, slot):
            c = min(slot, n - off)
            write(off, c)
            self._pg.barrier().wait()
            read(off, c)
            self._pg.barrier().wait()

    def _slot(self, personal: bool) -> int:
        return (self.region // self.size) & ~63 if personal else self.region

    def exchange(self, sends: list, wanted: list, personal: bool = False) -> list:
        """``sends``: this rank's flat uint8 payload (one, the same for
        every receiver) or, ``personal``, one per receiver (all of one
        size).  Returns, for each source rank whose ``wanted`` is true, the
        payload it sent this rank, on this rank's device."""
        n = sends[0].numel()
        slot = self._slot(personal)
        mine = self.index * self.region
        out = [torch.empty(n, dtype=torch.uint8, device=sends[0].device) if w else None for w in wanted]

        def write(off, c):
            for j, b in enumerate(sends if personal else sends[:1]):
                self.buf[mine + j * slot : mine + j * slot + c].copy_(b[off : off + c])
            COMM_STATS["staged_bytes"] += c * (self.size if personal else 1)

        def read(off, c):
            for src, o in enumerate(out):
                if o is not None:
                    at = src * self.region + (self.index * slot if personal else 0)
                    o[off : off + c].copy_(self.buf[at : at + c])
                    COMM_STATS["staged_bytes"] += c

        self._rounds(n, slot, write, read)
        return out

    def sum_blocks(self, blocks: torch.Tensor, scatter: bool = False, dtype=None) -> torch.Tensor:
        """``blocks`` (k, m), contiguous: with ``scatter`` (k = size) block
        j goes to rank j, which returns the sum of the blocks it received;
        otherwise (k = 1) every rank returns the sum of every rank's block
        (1, m).  The blocks move in their own dtype; their sum is taken in
        ``dtype`` (default theirs), term by term in rank order on this
        rank's device."""
        item = blocks.element_size()
        raw = blocks.view(torch.uint8).view(blocks.shape[0], -1)
        slot = self._slot(scatter) // item
        mine = self.index * self.region
        acc = torch.empty(blocks.shape[1], dtype=dtype or blocks.dtype, device=blocks.device)

        def write(off, c):
            for j in range(self.size if scatter else 1):
                at = mine + j * slot * item
                self.buf[at : at + c * item].copy_(raw[j, off * item : (off + c) * item])
            COMM_STATS["staged_bytes"] += c * item * (self.size if scatter else 1)

        def read(off, c):
            part = acc[off : off + c]
            for src in range(self.size):
                at = src * self.region + (self.index * slot * item if scatter else 0)
                # To the device in the blocks' dtype, then widened there.
                term = self.buf[at : at + c * item].view(blocks.dtype).to(part.device).to(part.dtype)
                if src == 0:
                    part.copy_(term)
                else:
                    part += term
            COMM_STATS["staged_bytes"] += c * item * self.size

        self._rounds(blocks.shape[1], slot, write, read)
        return acc if scatter else acc[None]


class AxisGroup:
    """One line of ranks along one mesh axis, seen from one member.

    ``size`` ranks, this one at ``index``; ``ranks`` their global ranks.
    A size-1 group runs no collective.  ``shared`` is the line's
    :class:`SharedLine` where the ranks share a card (None otherwise)."""

    def __init__(self, axis: str, ranks: Sequence[int], index: int, devices: Sequence[torch.device], store,
                 timeout_s: float, tag: str):
        self.axis = axis
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.device = devices[index]
        self.transport = transport_for(devices)
        self._pg = None
        self.shared: Optional[SharedLine] = None
        if self.size > 1:
            import torch.distributed as dist

            prefixed = dist.PrefixStore(tag, store)
            if self.transport == "nccl":
                opts = dist.ProcessGroupNCCL.Options()
                opts._timeout = datetime.timedelta(seconds=timeout_s)
                self._pg = dist.ProcessGroupNCCL(prefixed, index, self.size, opts)
            else:
                self._pg = dist.ProcessGroupGloo(prefixed, index, self.size, _gloo_options(timeout_s))
            if self.transport == "staged":
                self.shared = SharedLine.open(self._pg, index, self.size, self.device)

    def _count(self, op: str, t0: float, payload: int) -> None:
        COMM_STATS["collectives"] += 1
        COMM_STATS["payload_bytes"] += payload
        COMM_STATS["ms"] += (time.perf_counter() - t0) * 1e3
        COMM_STATS["by_op"][op] = COMM_STATS["by_op"].get(op, 0) + 1
        if COMM_TRACE is not None:
            COMM_TRACE.append((op, self.axis, payload))

    # -- collectives -----------------------------------------------------
    #
    # Each runs through the shared line where there is one, else as the
    # process group's own call on this rank's tensors.

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group, in ``x``'s dtype (half types
        summed in f32)."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        half = x.dtype in (torch.bfloat16, torch.float16)
        if self.shared is not None:
            # Half types move as they are and are summed in f32 here.
            out = self.shared.sum_blocks(x.contiguous().reshape(1, -1), dtype=torch.float32 if half else None)
            self._count("psum", t0, x.numel() * x.element_size())
            return out[0].view(x.shape).to(x.dtype)
        h = x.to(torch.float32 if half else x.dtype, memory_format=torch.contiguous_format, copy=True)
        self._pg.allreduce([h]).wait()
        self._count("psum", t0, h.numel() * h.element_size())
        return h.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in group order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        h = _bytes_of(x)
        if self.shared is not None:
            out = torch.cat(self.shared.exchange([h] * self.size, [True] * self.size))
        else:
            out = torch.empty(self.size * h.numel(), dtype=torch.uint8, device=h.device)
            self._pg.allgather([list(out.chunk(self.size))], [h]).wait()
        self._count("all_gather", t0, h.numel())
        parts = out.view(x.dtype).view(self.size, *x.shape)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over the group, cut into ``size`` blocks along
        ``dim``: this rank's block, in ``x``'s dtype (half types summed in
        f32).  The gradient of :meth:`all_gather`."""
        if self.size == 1:
            return x
        if x.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: dimension {x.shape[dim]} does not split into {self.size}")
        t0 = time.perf_counter()
        half = x.dtype in (torch.bfloat16, torch.float16)
        if self.shared is not None:
            # Each rank's block for rank j moves as it is; rank j sums the
            # blocks it receives in f32, in rank order.
            blocks = torch.stack(torch.chunk(x, self.size, dim=dim)).contiguous()
            got = self.shared.sum_blocks(blocks.reshape(self.size, -1), scatter=True,
                                         dtype=torch.float32 if half else None)
            self._count("reduce_scatter", t0, blocks.numel() * blocks.element_size())
            return got.view(blocks.shape[1:]).to(x.dtype)
        wide = x.float() if half else x
        blocks = torch.stack(torch.chunk(wide, self.size, dim=dim)).contiguous()  # (size, ...)
        out = torch.empty(blocks[0].numel(), dtype=blocks.dtype, device=blocks.device)
        self._pg._reduce_scatter_base(out, blocks.reshape(-1)).wait()
        self._count("reduce_scatter", t0, blocks.numel() * blocks.element_size())
        return out.view(blocks.shape[1:]).to(x.dtype)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Split ``x`` into ``size`` blocks along ``split_dim``; block i
        goes to rank i, and the received blocks concatenate along
        ``concat_dim`` in group order (``lax.all_to_all(tiled=True)``)."""
        if self.size == 1:
            return x
        if x.shape[split_dim] % self.size:
            raise ValueError(f"all_to_all: dimension {x.shape[split_dim]} does not split into {self.size}")
        t0 = time.perf_counter()
        blocks = torch.stack(torch.chunk(x, self.size, dim=split_dim)).contiguous()  # (size, ...)
        flat = blocks.view(self.size, -1)
        if self.shared is not None:
            out = torch.cat(self.shared.exchange([_bytes_of(b) for b in flat], [True] * self.size, personal=True))
        else:
            inp = _bytes_of(flat)
            out = torch.empty_like(inp)
            self._pg.alltoall_base(out, inp, [], []).wait()
        self._count("all_to_all", t0, flat.numel() * flat.element_size())
        got = out.view(x.dtype).view(blocks.shape)
        return torch.cat(list(got.unbind(0)), dim=concat_dim)

    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: for each (src, dst) pair of group indices, src's
        ``x`` arrives at dst (paired send/recv); a rank no pair sends to
        gets zeros."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        h = _bytes_of(x)
        src = [s for s, d in perm if d == self.index]
        if self.shared is not None:
            got = self.shared.exchange([h] * self.size, [i in src for i in range(self.size)])
            recv = got[src[0]] if src else None
        else:
            recv = torch.empty_like(h) if src else None
            works = []
            for s, d in perm:
                if s == self.index and d != self.index:
                    works.append(self._pg.send([h], d, 0))
                if d == self.index and s != self.index:
                    works.append(self._pg.recv([recv], s, 0))
                if s == d == self.index:
                    recv.copy_(h)
            for w in works:
                w.wait()
        self._count("ppermute", t0, h.numel())
        return recv.view(x.dtype).view(x.shape) if src else torch.zeros_like(x)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Group index ``src``'s ``x`` on every rank of the group."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        t0 = time.perf_counter()
        h = _bytes_of(x)
        if self.shared is not None:
            out = self.shared.exchange([h] * self.size, [i == src for i in range(self.size)])[src]
        else:
            out = h.clone()
            opts = dist.BroadcastOptions()
            opts.rootRank = src
            self._pg.broadcast([out], opts).wait()
        self._count("broadcast", t0, h.numel())
        return out.view(x.dtype).view(x.shape)


def build_axis_groups(sizes: dict, rank: int, devices: Sequence[torch.device], store, timeout_s: float,
                      mesh_id: str) -> dict[str, AxisGroup]:
    """This rank's group along every axis of a mesh of ``sizes`` (ranks in
    MESH_AXES order, rank r on ``devices[r]``)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.parallel.mesh import MESH_AXES

    grid = np.arange(len(devices)).reshape(tuple(sizes[a] for a in MESH_AXES))
    coords = np.unravel_index(rank, grid.shape)
    groups = {}
    for ai, axis in enumerate(MESH_AXES):
        index = [int(c) for c in coords]
        index[ai] = slice(None)
        line = [int(r) for r in grid[tuple(index)]]
        tag = f"{mesh_id}/{axis}/" + "-".join(map(str, line))
        groups[axis] = AxisGroup(axis, line, line.index(rank), [devices[r] for r in line], store, timeout_s, tag)
    return groups


def stats_delta(before: dict, after: Optional[dict] = None) -> dict:
    """``after`` (default: now) minus ``before`` for the scalar counts."""
    after = COMM_STATS if after is None else after
    return {k: after[k] - before[k] for k in ("collectives", "staged_bytes", "payload_bytes", "ms")}
