"""The collectives of a mesh: what XLA inserts for the reference's
sharded programs, called explicitly here.

Each mesh axis has one process group per line of ranks along it
(:class:`AxisGroup`).  Its transport follows the devices of that line,
never a failure:

* distinct CUDA devices: NCCL on device tensors;
* CPU ranks: gloo;
* ranks that share one CUDA device: gloo, each collective staged through
  pinned host buffers (NCCL refuses two ranks on one GPU).  Staged bytes
  and time are counted in :data:`COMM_STATS`.

Groups are built straight from a ``torch.distributed`` store (a
``file://`` rendezvous in a temporary directory, so concurrent test
workers never contend for a port), not through the process-global default
group, so one process may take part in several meshes.  Every group has a
timeout: a collective whose peer died raises within it.

Half-precision sums run in f32 (each rank's value is widened, the sum
rounded once).  Gathers, all-to-alls, permutes and broadcasts move bytes
(gloo has no 16-bit integer type; bf16 travels as its bytes).
"""

from __future__ import annotations

import datetime
import time
from typing import Optional, Sequence

import torch

# Per-process counts of collectives, as ``chip_smoke.py`` and the tests
# read them: collectives run, bytes each moved through host staging (D2H
# plus H2D; 0 on gloo-over-CPU and NCCL), bytes of payload, and wall ms
# (staging included).  ``by_op`` splits the count by collective.
COMM_STATS = {"collectives": 0, "staged_bytes": 0, "payload_bytes": 0, "ms": 0.0, "by_op": {}}


def reset_comm_stats() -> None:
    COMM_STATS.update(collectives=0, staged_bytes=0, payload_bytes=0, ms=0.0, by_op={})


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


class AxisGroup:
    """One line of ranks along one mesh axis, seen from one member.

    ``size`` ranks, this one at ``index``; ``ranks`` their global ranks.
    A size-1 group runs no collective."""

    def __init__(self, axis: str, ranks: Sequence[int], index: int, devices: Sequence[torch.device], store,
                 timeout_s: float, tag: str):
        self.axis = axis
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.device = devices[index]
        self.transport = transport_for(devices)
        self._pg = None
        self._pinned: dict = {}
        if self.size > 1:
            import torch.distributed as dist

            prefixed = dist.PrefixStore(tag, store)
            if self.transport == "nccl":
                opts = dist.ProcessGroupNCCL.Options()
                opts._timeout = datetime.timedelta(seconds=timeout_s)
                self._pg = dist.ProcessGroupNCCL(prefixed, index, self.size, opts)
            else:
                self._pg = dist.ProcessGroupGloo(prefixed, index, self.size, _gloo_options(timeout_s))

    # -- staging ---------------------------------------------------------

    def _buffer(self, role: str, dtype, numel: int) -> torch.Tensor:
        """``numel`` elements of ``dtype`` in this role's pinned host
        buffer.  A role ("in" or "out") keeps one buffer, grown to the next
        power of two of bytes when a collective needs more, so shapes that
        vary with the batch and the prompt hold at most twice the largest
        collective's bytes pinned."""
        nbytes = numel * dtype.itemsize
        buf = self._pinned.get(role)
        if buf is None or buf.numel() < nbytes:
            self._pinned[role] = None  # the old buffer goes before the new one is pinned
            buf = self._pinned[role] = torch.empty(1 << max(nbytes - 1, 1).bit_length(), dtype=torch.uint8,
                                                   pin_memory=True)
        return buf[:nbytes].view(dtype)

    def pinned_bytes(self) -> int:
        """Bytes of host memory this group keeps pinned."""
        return sum(b.numel() for b in self._pinned.values() if b is not None)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the host: itself on CPU/NCCL groups; a pinned copy
        (reused buffers) when staged."""
        if self.transport != "staged":
            return x.contiguous()
        buf = self._buffer("in", x.dtype, x.numel())
        buf.copy_(x.reshape(-1))
        COMM_STATS["staged_bytes"] += x.numel() * x.element_size()
        return buf.view(x.shape)

    def _out(self, like: torch.Tensor, n: int = 1) -> torch.Tensor:
        """Host memory for ``n`` results shaped like ``like`` (flat bytes):
        pinned when staged, so the copy back to the card is one fast
        transfer."""
        if self.transport != "staged":
            return torch.empty(n * like.numel(), dtype=like.dtype)
        return self._buffer("out", like.dtype, n * like.numel())

    def _back(self, y: torch.Tensor) -> torch.Tensor:
        if self.transport != "staged":
            return y
        COMM_STATS["staged_bytes"] += y.numel() * y.element_size()
        return y.to(self.device)

    def _count(self, op: str, t0: float, payload: int) -> None:
        COMM_STATS["collectives"] += 1
        COMM_STATS["payload_bytes"] += payload
        COMM_STATS["ms"] += (time.perf_counter() - t0) * 1e3
        COMM_STATS["by_op"][op] = COMM_STATS["by_op"].get(op, 0) + 1

    # -- collectives -----------------------------------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group, in ``x``'s dtype (half types
        summed in f32)."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        h = self._host(wide)
        if h is wide or h.data_ptr() == wide.data_ptr():
            h = h.clone()
        self._pg.allreduce([h]).wait()
        out = self._back(h).to(x.dtype)
        self._count("psum", t0, x.numel() * wide.element_size())
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in group order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        h = _bytes_of(self._host(x))
        out = self._out(h, self.size)
        self._pg.allgather([list(out.chunk(self.size))], [h]).wait()
        parts = self._back(out).view(x.dtype).view(self.size, *x.shape)
        self._count("all_gather", t0, h.numel())
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Split ``x`` into ``size`` blocks along ``split_dim``; block i
        goes to rank i, and the received blocks concatenate along
        ``concat_dim`` in group order (``lax.all_to_all(tiled=True)``)."""
        if self.size == 1:
            return x
        if x.shape[split_dim] % self.size:
            raise ValueError(f"all_to_all: dimension {x.shape[split_dim]} does not split into {self.size}")
        t0 = time.perf_counter()
        blocks = torch.stack(torch.chunk(x, self.size, dim=split_dim))  # (size, ...)
        h = self._host(blocks.contiguous())
        inp = _bytes_of(h)
        out = self._out(inp)
        self._pg.alltoall_base(out, inp, [], []).wait()
        got = self._back(out).view(x.dtype).view(blocks.shape)
        self._count("all_to_all", t0, inp.numel())
        return torch.cat(list(got.unbind(0)), dim=concat_dim)

    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: for each (src, dst) pair of group indices, src's
        ``x`` arrives at dst (paired send/recv); a rank no pair sends to
        gets zeros."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        h = _bytes_of(self._host(x))
        recv = self._out(h)
        works = []
        got = False
        for src, dst in perm:
            if src == self.index and dst != self.index:
                works.append(self._pg.send([h], dst, 0))
            if dst == self.index and src != self.index:
                works.append(self._pg.recv([recv], src, 0))
                got = True
            if src == dst == self.index:
                recv.copy_(h)
                got = True
        for w in works:
            w.wait()
        self._count("ppermute", t0, h.numel())
        out = self._back(recv).view(x.dtype).view(x.shape)
        return out if got else torch.zeros_like(x)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Group index ``src``'s ``x`` on every rank of the group."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        t0 = time.perf_counter()
        h = _bytes_of(self._host(x)).clone()
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self._pg.broadcast([h], opts).wait()
        self._count("broadcast", t0, h.numel())
        return self._back(h).view(x.dtype).view(x.shape)


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
