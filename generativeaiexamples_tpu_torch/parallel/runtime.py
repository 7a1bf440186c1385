"""The single controller over SPMD ranks.

The reference is one process that drives every device of a mesh.  The
port keeps that shape for its callers: the controller (this process) is
rank 0, and :func:`get_runtime` spawns one follower process per other
rank with ``torch.multiprocessing`` (spawn).  :meth:`Runtime.run` sends a
program and its small inputs (tokens, positions, lengths, slot or page
tables: numpy arrays and numbers) to every follower over a pipe, runs it
as rank 0 here, and waits for every rank's answer.  Programs are
module-level functions ``program(ctx, *args)``; ``ctx`` is the rank's
:class:`RankContext` for the mesh, whose ``state`` dict keeps what a
program leaves on the rank (a shard of the parameters, the cache) for
later programs.  The collectives inside a program are the mesh's
(``parallel.comm``).

A follower that dies makes the controller's next collective raise within
the group timeout (its sockets close) or its answer read fail; the
runtime is then broken and every later :meth:`Runtime.run` raises
:class:`MeshError` at once.  :meth:`Runtime.close` (also run at the
controller's exit) stops every follower; a follower whose controller is
gone exits on its own.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
import traceback
from typing import Any, Optional, Sequence

import torch

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.parallel.autograd import collective

logger = get_logger(__name__)

# Seconds a collective (and a rank's answer beyond the controller's own
# run) may take before it raises.
DEFAULT_TIMEOUT_S = 120.0
# Seconds a follower may take to start (an interpreter, torch, a CUDA
# context: more on a loaded host) before the first program, which waits
# for it; the collective timeout starts only after that.
FOLLOWER_START_S = 300.0


class MeshError(RuntimeError):
    """A rank failed, died or did not answer."""


class RankContext:
    """One rank's view of one mesh: ``rank``, ``device``, the mesh
    ``sizes`` and this rank's ``coords`` per axis, its ``groups`` per axis
    (``parallel.comm.AxisGroup``) and ``state`` (what programs keep)."""

    def __init__(self, rank: int, sizes: dict, devices: Sequence[torch.device], store, timeout_s: float,
                 mesh_id: str):
        from generativeaiexamples_tpu_torch.parallel.comm import build_axis_groups
        from generativeaiexamples_tpu_torch.parallel.mesh import rank_coords

        self.rank = rank
        self.sizes = dict(sizes)
        self.device = devices[rank]
        self.coords = rank_coords(sizes, rank)
        self.groups = build_axis_groups(self.sizes, rank, devices, store, timeout_s, mesh_id)
        self.state: dict = {}
        # Set while this rank builds a training graph: the collectives then
        # carry gradients, chained by this token (``parallel.autograd``).
        self.grad_token = None

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    # The collectives below carry a gradient while a training graph is
    # being built (``parallel.autograd.collective``); otherwise they are
    # the axis group's plain calls.

    def psum(self, x, axis: str):
        return collective(self, "psum", axis, x)

    def copy_to(self, x, axis: str):
        """The f op: identity here, its gradient summed over ``axis``."""
        return collective(self, "copy", axis, x)

    def all_gather(self, x, axis: str, dim: int = 0):
        return collective(self, "all_gather", axis, x, dim)

    def reduce_scatter(self, x, axis: str, dim: int = 0):
        return collective(self, "reduce_scatter", axis, x, dim)

    def all_to_all(self, x, axis: str, split_dim: int, concat_dim: int):
        return collective(self, "all_to_all", axis, x, split_dim, concat_dim)

    def ppermute(self, x, axis: str, perm):
        return collective(self, "ppermute", axis, x, [tuple(p) for p in perm])

    def broadcast(self, x, axis: str, src: int):
        return self.groups[axis].broadcast(x, src)


class _Rank:
    """The rank-side half shared by the controller and the followers: the
    store and one :class:`RankContext` per mesh."""

    def __init__(self, rank: int, devices, store_path: str, timeout_s: float):
        import torch.distributed as dist

        self.rank = rank
        self.devices = devices
        self.timeout_s = timeout_s
        self.store = dist.FileStore(store_path, len(devices))
        self.contexts: dict[str, RankContext] = {}

    def execute(self, mesh_id: str, program, args):
        if program is _new_mesh:
            return program(self, mesh_id, *args)
        ctx = self.contexts[mesh_id]
        if ctx.device.type == "cuda":
            torch.cuda.set_device(ctx.device)
        if getattr(program, "builds_graph", False):
            # Training: tensors that autograd saves may not be inference
            # tensors, so these programs run outside inference mode.
            with torch.inference_mode(False), torch.enable_grad():
                return program(ctx, *args)
        with torch.inference_mode():
            return program(ctx, *args)


def grad_program(fn):
    """Mark a rank program that builds autograd graphs (a training step, or
    one that keeps tensors a later step differentiates): it runs with grad
    mode on instead of under ``torch.inference_mode``."""
    fn.builds_graph = True
    return fn


def _new_mesh(rank: _Rank, mesh_id: str, sizes: dict) -> None:
    rank.contexts[mesh_id] = RankContext(rank.rank, sizes, rank.devices, rank.store, rank.timeout_s, mesh_id)


def cpu_rank_threads(n_ranks: int) -> int:
    """Intra-op threads for one of ``n_ranks`` CPU ranks: they share this
    host's cores evenly."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
    return max(1, cores // n_ranks)


def _follower_main(rank: int, devices, store_path: str, timeout_s: float, conn) -> None:
    """A follower rank's loop: run each program the controller sends and
    answer ``("ok", result)`` or ``("err", traceback)``."""
    devices = [torch.device(d) for d in devices]
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    if devices[rank].type == "cpu":
        torch.set_num_threads(cpu_rank_threads(len(devices)))
    me = _Rank(rank, devices, store_path, timeout_s)
    conn.send(("ready", None))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return  # the controller is gone
        if msg[0] == "close":
            return
        _, mesh_id, program, args, gather = msg
        try:
            out = me.execute(mesh_id, program, args)
            conn.send(("ok", out if gather else None))
        except BaseException:  # noqa: BLE001 - reported to the controller
            try:
                conn.send(("err", traceback.format_exc()))
            except (EOFError, OSError):
                return


class Runtime:
    """The controller (rank 0) and one follower process per other rank,
    over ``devices`` (rank r on ``devices[r]``)."""

    def __init__(self, devices: Sequence[Any], timeout_s: Optional[float] = None):
        import torch.multiprocessing as mp

        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.timeout_s = float(timeout_s or DEFAULT_TIMEOUT_S)
        self._dir = tempfile.mkdtemp(prefix="gaie-mesh-")
        store_path = os.path.join(self._dir, "rendezvous")
        self._lock = threading.Lock()
        self._broken: Optional[str] = None
        self._closed = False
        self._started = False
        self._meshes = 0
        self._procs, self._conns = [], []
        ctx = mp.get_context("spawn")
        names = [str(d) for d in self.devices]
        for r in range(1, len(self.devices)):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_follower_main, args=(r, names, store_path, self.timeout_s, child),
                               daemon=True, name=f"gaie-mesh-rank{r}")
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._me = _Rank(0, self.devices, store_path, self.timeout_s)
        # The controller's CPU rank shares the cores as a follower does,
        # until close() gives the process its own count back.
        self._threads = None
        if self.devices[0].type == "cpu":
            self._threads = torch.get_num_threads()
            torch.set_num_threads(cpu_rank_threads(len(self.devices)))

    @property
    def alive(self) -> bool:
        return not self._closed and self._broken is None and all(p.is_alive() for p in self._procs)

    def context(self, mesh_id: str) -> RankContext:
        return self._me.contexts[mesh_id]

    def new_mesh(self, sizes: dict):
        """A mesh of ``sizes`` over these ranks."""
        from generativeaiexamples_tpu_torch.parallel.mesh import Mesh

        with self._lock:
            self._meshes += 1
            mesh_id = f"m{self._meshes}"
        self.run(mesh_id, _new_mesh, (sizes,))
        return Mesh(self, sizes, mesh_id)

    def run(self, mesh_id: str, program, args, *, gather: bool = False, timeout: Optional[float] = None,
            rank_args: Optional[Sequence[Any]] = None):
        """``program(ctx, *args)`` on every rank; with ``rank_args`` (one
        entry per rank) rank r runs ``program(ctx, *args, rank_args[r])``,
        so each rank is sent only its own part (a batch's rows)."""
        if rank_args is not None and len(rank_args) != len(self.devices):
            raise ValueError(f"rank_args has {len(rank_args)} entries for {len(self.devices)} ranks")

        def args_of(r):
            return tuple(args) if rank_args is None else (*args, rank_args[r])

        with self._lock:
            if self._closed:
                raise MeshError("the mesh is closed")
            if self._broken is not None:
                raise MeshError(f"the mesh is broken: {self._broken}")
            if not self._started:
                self._await_followers()
            wait = self.timeout_s if timeout is None else timeout
            try:
                for r, conn in enumerate(self._conns, 1):
                    conn.send(("run", mesh_id, program, args_of(r), gather))
            except (OSError, EOFError) as e:
                self._broken = f"rank {r} is gone ({e})"
                raise MeshError(self._broken) from e
            local_err = None
            try:
                local = self._me.execute(mesh_id, program, args_of(0))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                local, local_err = None, e
            results, errors = [local], []
            for r, conn in enumerate(self._conns, 1):
                try:
                    if not conn.poll(wait):
                        errors.append(f"rank {r} did not answer within {wait:.0f} s")
                        continue
                    status, value = conn.recv()
                except (EOFError, OSError) as e:
                    errors.append(f"rank {r} died ({type(e).__name__})")
                    continue
                if status == "err":
                    errors.append(f"rank {r} failed:\n{value}")
                results.append(value)
            if errors or local_err is not None:
                # Every rank failing alike (a check before any collective)
                # leaves the ranks in step; a death, a silence or a partial
                # failure does not, and breaks the mesh for good.
                lost = any("died" in e or "did not answer" in e for e in errors) or not self.alive
                if lost or local_err is None or len(errors) != len(self._conns):
                    self._broken = "; ".join(errors) or f"rank 0 failed alone: {local_err!r}"
                what = "; ".join(errors) if errors else f"rank 0 failed: {local_err!r}"
                raise MeshError(f"{getattr(program, '__name__', program)} on the mesh: {what}") from local_err
            return results if gather else local

    def _await_followers(self) -> None:
        """Each follower's start-up message (the first program waits for
        every rank to be up, so that no group's rendezvous times out on a
        start-up); a follower that dies or does not start breaks the
        runtime."""
        for r, conn in enumerate(self._conns, 1):
            try:
                if not conn.poll(max(self.timeout_s, FOLLOWER_START_S)):
                    self._broken = f"rank {r} did not start within {max(self.timeout_s, FOLLOWER_START_S):.0f} s"
                    raise MeshError(self._broken)
                conn.recv()
            except (EOFError, OSError) as e:
                self._broken = f"rank {r} died while starting ({type(e).__name__})"
                raise MeshError(self._broken) from e
        self._started = True

    def close(self) -> None:
        """Stop every follower (terminate any that does not exit) and
        drop the rendezvous directory; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for conn in self._conns:
                try:
                    conn.send(("close",))
                except (OSError, EOFError):
                    pass
            for proc in self._procs:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5)
            for conn in self._conns:
                conn.close()
            self._me.contexts.clear()
            shutil.rmtree(self._dir, ignore_errors=True)
            if self._threads is not None:
                torch.set_num_threads(self._threads)
        with _RUNTIMES_LOCK:
            for key, rt in list(_RUNTIMES.items()):
                if rt is self:
                    del _RUNTIMES[key]


_RUNTIMES: dict[tuple, Runtime] = {}
_RUNTIMES_LOCK = threading.Lock()


def get_runtime(devices: Sequence[Any], timeout_s: Optional[float] = None) -> Runtime:
    """The live runtime over exactly ``devices`` (and this timeout), or a
    new one: every mesh over the same device list shares its ranks."""
    key = (tuple(str(torch.device(d)) for d in devices), timeout_s)
    with _RUNTIMES_LOCK:
        rt = _RUNTIMES.get(key)
        if rt is not None and rt.alive:
            return rt
    if rt is not None:
        rt.close()
    rt = Runtime(devices, timeout_s)
    with _RUNTIMES_LOCK:
        _RUNTIMES[key] = rt
    return rt


def close_all() -> None:
    """Close every runtime this process started."""
    with _RUNTIMES_LOCK:
        runtimes = list(_RUNTIMES.values())
    for rt in runtimes:
        rt.close()


atexit.register(close_all)
