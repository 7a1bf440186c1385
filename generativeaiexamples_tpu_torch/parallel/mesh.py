"""Device mesh construction and logical-axis sharding rules (port of
``parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives.  The port's :class:`Mesh` is an array of *ranks* in
:data:`MESH_AXES` order (``data`` outermost, ``tensor`` innermost), each
rank one process with its own ``torch.device``: the controller (this
process) is rank 0 and ``make_mesh`` spawns the others
(``parallel.runtime``).  Each axis has one process group per line of ranks
along it (``parallel.comm``), and programs run on every rank at once
through :meth:`Mesh.run`.  A device may repeat, as ``[cuda:0, cuda:0]``:
two ranks share one card, as the reference's tests share virtual CPU
devices.

Mesh axes:
  data    data parallelism / batch sharding (serving replicas, train DP)
  fsdp    parameter/optimizer sharding across the data axis (train)
  pipe    pipeline parallelism (layer stages)
  tensor  tensor parallelism (attention heads, MLP hidden, vocabulary)
  seq     sequence/context parallelism for long-context attention
  expert  expert parallelism (MoE model families)

Logical axes used by models: "vocab", "embed", "heads", "kv_heads",
"head_dim", "mlp", "layers", "batch", "seqlen", "expert".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import numpy as np

MESH_AXES = ("data", "fsdp", "pipe", "seq", "expert", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Requested mesh shape; -1 on one axis means 'use remaining devices'."""

    data: int = 1
    fsdp: int = 1
    pipe: int = 1
    seq: int = 1
    tensor: int = -1
    expert: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dataclasses.asdict(self)
        fixed = [v for v in sizes.values() if v != -1]
        n_fixed = math.prod(fixed)
        free_axes = [k for k, v in sizes.items() if v == -1]
        if len(free_axes) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if free_axes:
            if n_devices % n_fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[free_axes[0]] = n_devices // n_fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(f"mesh {sizes} does not cover {n_devices} devices")
        return sizes


def default_devices() -> list:
    """Every visible card, as the reference's default is every device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass devices=[...] (CPU ranks: ['cpu', 'cpu'])")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Ranks in :data:`MESH_AXES` order over a live runtime's processes.

    ``shape`` maps each axis to its size (as ``jax.sharding.Mesh.shape``),
    ``devices`` is the rank -> device array in mesh order, ``size`` the
    rank count.  :meth:`run` runs one program on every rank; :meth:`close`
    stops the ranks' processes."""

    def __init__(self, runtime, sizes: Mapping[str, int], mesh_id: str):
        self.runtime = runtime
        self.shape = {a: int(sizes[a]) for a in MESH_AXES}
        self.id = mesh_id
        self.size = math.prod(self.shape.values())
        self.devices = np.empty(len(runtime.devices), dtype=object)
        self.devices[:] = list(runtime.devices)
        self.devices = self.devices.reshape(tuple(self.shape[a] for a in MESH_AXES))

    def run(self, program, *args, gather: bool = False, timeout: Optional[float] = None,
            rank_args: Optional[Sequence[Any]] = None):
        """Run ``program(ctx, *args)`` on every rank (``ctx`` the rank's
        :class:`~generativeaiexamples_tpu_torch.parallel.runtime.RankContext`
        for this mesh); with ``rank_args`` rank r also gets
        ``rank_args[r]`` as its last argument.  Returns rank 0's result, or
        every rank's in rank order with ``gather``.  Raises if any rank
        failed or died."""
        return self.runtime.run(self.id, program, args, gather=gather, timeout=timeout, rank_args=rank_args)

    def coords(self, rank: int) -> dict[str, int]:
        """The mesh coordinates of ``rank``."""
        return rank_coords(self.shape, rank)

    @property
    def ctx(self):
        """Rank 0's context (this process's rank)."""
        return self.runtime.context(self.id)

    def close(self) -> None:
        self.runtime.close()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def rank_coords(sizes: Mapping[str, int], rank: int) -> dict[str, int]:
    """The mesh coordinates of ``rank`` (row-major over MESH_AXES)."""
    idx = np.unravel_index(rank, tuple(sizes[a] for a in MESH_AXES))
    return {a: int(i) for a, i in zip(MESH_AXES, idx)}


def make_mesh(spec: Optional[MeshSpec] = None, devices: Optional[Sequence[Any]] = None, *,
              timeout_s: Optional[float] = None) -> Mesh:
    """Build a named mesh over the given (default: every visible card)
    devices, one rank per entry.  The ranks' processes are spawned on the
    first mesh over a device list and shared by every later mesh over the
    same list (``parallel.runtime.get_runtime``); ``timeout_s`` bounds each
    collective and each rank's answer."""
    from generativeaiexamples_tpu_torch.parallel.runtime import get_runtime

    devices = list(devices if devices is not None else default_devices())
    spec = spec or MeshSpec()
    sizes = spec.resolve(len(devices))
    runtime = get_runtime(devices, timeout_s=timeout_s)
    return runtime.new_mesh(sizes)


def replica_device_slices(n_replicas: int, devices: Optional[Sequence[Any]] = None) -> list[list[Any]]:
    """Split the visible devices into ``n_replicas`` disjoint, contiguous
    groups, one per data-parallel serving replica (``engine.replica``).
    Replicas never communicate with each other: data parallelism across
    them is pure request routing, so no axis spans groups."""
    devices = list(devices if devices is not None else default_devices())
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if len(devices) % n_replicas:
        raise ValueError(f"{len(devices)} devices do not split into {n_replicas} equal replica slices")
    per = len(devices) // n_replicas
    return [devices[i * per : (i + 1) * per] for i in range(n_replicas)]


def default_rules() -> dict[str, Optional[str]]:
    """Logical axis name -> mesh axis (or None = replicated)."""
    return {
        "vocab": "tensor",
        "embed": None,
        "heads": "tensor",
        "kv_heads": "tensor",
        "head_dim": None,
        "mlp": "tensor",
        "layers": None,
        "batch": "data",
        "seqlen": "seq",
        "expert": "expert",
    }


def fsdp_rules() -> dict[str, Optional[str]]:
    """Training-flavored rules: shard the embed dim over fsdp as well."""
    rules = default_rules()
    rules["embed"] = "fsdp"
    return rules


def logical_to_partition(
    logical_axes: Sequence[Optional[str]], rules: Optional[Mapping[str, Optional[str]]] = None
) -> tuple:
    """Map a tuple of logical axis names to a partition spec: one mesh axis
    name (or None) per dimension, as ``jax.sharding.PartitionSpec``'s
    entries."""
    rules = rules if rules is not None else default_rules()
    return tuple(rules.get(a) if a is not None else None for a in logical_axes)


def shard_slices(shape: Sequence[int], spec: Sequence[Optional[str]], sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple:
    """The index of one rank's block of an array of ``shape`` under
    ``spec``: the block ``jax.sharding.NamedSharding`` places on the device
    at ``coords``.  A dimension that does not divide its axis raises."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, axis in zip(shape, spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n == 1:
            out.append(slice(None))
            continue
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide the {axis!r} axis of size {n}")
        per = dim // n
        out.append(slice(coords[axis] * per, (coords[axis] + 1) * per))
    return tuple(out)


def shard_pytree(tree: Any, spec_tree: Any, sizes: Mapping[str, int], coords: Mapping[str, int]) -> Any:
    """This rank's slice of every leaf of ``tree`` (dicts of arrays or
    tensors) under its spec in ``spec_tree`` (same structure, tuples of
    axis names): the shard ``jax.device_put(x, NamedSharding(mesh, spec))``
    puts on the device at ``coords``."""
    if isinstance(tree, Mapping):
        return {k: shard_pytree(v, spec_tree[k], sizes, coords) for k, v in tree.items()}
    return tree[shard_slices(np.shape(tree), spec_tree, sizes, coords)]
