"""Training over a device mesh: the rank programs and the controller's
handle on a train state that lives on the ranks.

The reference trains one ``jax.jit`` step over a sharded state.  Here the
state lives where ``engine.mesh_serving`` keeps a serving engine: each
rank holds its shard of the params and of both Adam moments in its
context's ``state`` (:class:`RankTrainer`), and the controller holds a
:class:`MeshTrainState` (a key and the step count), never the whole tree.
A step sends each rank only its rows of the batch
(:func:`rank_rows`: rows over ``data`` x ``fsdp``, the sequence over
``seq``) and comes back with ``{"loss", "grad_norm"}`` as numbers.

On each rank a step is: the loss on the rank's shards through the
model's mesh forward (``models.llama.forward(mesh=...)``: fsdp gathers,
f and g ops, ring attention, the experts), its gradient through autograd
with the collectives chained by a token (``parallel.autograd``), the
gradients of leaves replicated over an axis that splits the work summed
over it (:func:`sum_replicated`), the global norm over the shards
(:func:`global_norm`) and AdamW on the shards (elementwise, so the
arithmetic is the one device's).

Kinds of state: ``"llama"`` (``fsdp_rules`` or any rules; the loss is
``engine.training.loss_fn`` or a given one, as the pipeline's),
``"lora"`` (replicated adapters over a base sharded by the default rules),
``"bert"`` (the contrastive step over ``fsdp_rules`` shards).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.parallel.autograd import value_and_grad
from generativeaiexamples_tpu_torch.parallel.mesh import MESH_AXES, shard_slices
from generativeaiexamples_tpu_torch.parallel.runtime import grad_program
from generativeaiexamples_tpu_torch.utils.trees import flatten, unflatten

# Axes that split a step's work (its rows, its sequence, its layers): a
# leaf replicated over one of them gets its gradient summed over it.
WORK_AXES = ("data", "fsdp", "seq", "pipe")
# LoRA's adapters are replicated everywhere and each tensor rank adapts
# only its slice of a sharded target, so ``tensor`` splits their use too.
LORA_SUM_AXES = ("data", "fsdp", "seq", "tensor")

_KEYS = itertools.count()


def sharded_axes(spec, sizes) -> tuple:
    """The populated mesh axes a leaf's spec shards it over, in order."""
    return tuple(a for a in spec if a is not None and sizes.get(a, 1) > 1)


def specs_for(kind: str, cfg, rules, params) -> dict:
    """The partition spec of every leaf of a state of ``kind`` (LoRA's
    adapters are replicated)."""
    if kind == "lora":
        return unflatten([(p, (None,) * leaf.ndim) for p, leaf in flatten(params)])
    if kind == "bert":
        from generativeaiexamples_tpu_torch.models import bert

        return bert.partition_specs(cfg, rules)
    from generativeaiexamples_tpu_torch.models import llama

    return llama.partition_specs(cfg, rules)


def shard_tree(tree, specs, sizes, coords, device) -> dict:
    """This rank's slice of every leaf (numpy, bf16 bits included, or
    tensors), each a tensor of its own on ``device``."""
    from generativeaiexamples_tpu_torch.engine.weights import _owned_slice

    spec_of = dict(flatten(specs))
    return unflatten([(p, _owned_slice(x, shard_slices(tuple(np.shape(x)), spec_of[p], sizes, coords), device)
                       .contiguous()) for p, x in flatten(tree)])


# -- the rank side -------------------------------------------------------------


@dataclasses.dataclass
class RankTrainer:
    """One rank's share of a train state."""

    kind: str
    cfg: Any
    opt: Any
    params: Any
    opt_state: Any
    step: int
    specs: Any
    loss: Optional[Callable] = None
    base: Any = None
    extra: dict = dataclasses.field(default_factory=dict)


def _draw(kind: str, cfg, gen_state, device):
    """The whole tree drawn on ``device`` from a generator state, as the
    one-device ``init_*`` draws it."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    if kind == "bert":
        from generativeaiexamples_tpu_torch.models import bert

        return bert.init_params(cfg, gen, device)
    from generativeaiexamples_tpu_torch.engine.decode import init_random_params

    return init_random_params(cfg, gen, device)


@grad_program
def init(ctx, key: str, kind: str, cfg, opt, rules, source: tuple, extra: dict) -> None:
    """Build this rank's share of a train state under ``key``.  ``source``
    is ``("seed", generator_state)``, ``("tree", params)``, ``("state",
    params, mu, nu, count, step)`` (a one-device state, CPU tensors or
    numpy) or ``("checkpoint", path)``."""
    from generativeaiexamples_tpu_torch.engine.training import AdamState
    from generativeaiexamples_tpu_torch.engine.weights import read_checkpoint_shard

    dev = ctx.device
    count, step = 0, 0
    mu = nu = None
    if source[0] == "seed":
        full = _draw(kind, cfg, source[1], dev)
    elif source[0] == "tree":
        full = source[1]
    elif source[0] == "state":
        full, mu, nu, count, step = source[1:]
    elif source[0] != "checkpoint":
        raise ValueError(f"unknown train state source {source[0]!r}")
    base = None
    if kind == "lora":
        from generativeaiexamples_tpu_torch.engine.weights import shard_params

        base = shard_params(extra.pop("base"), cfg, ctx.sizes, ctx.coords, dev)
    if source[0] == "checkpoint":
        got = read_checkpoint_shard(source[1], ctx.sizes, ctx.coords, dev,
                                    lambda tree: specs_for(kind, cfg, rules, tree))
        params, mu, nu = got["params"], got.get("mu"), got.get("nu")
        count, step = got["count"], got["step"]
        specs = specs_for(kind, cfg, rules, params)
    else:
        specs = specs_for(kind, cfg, rules, full)
        params = shard_tree(full, specs, ctx.sizes, ctx.coords, dev)
        if mu is not None:
            mu = shard_tree(mu, specs, ctx.sizes, ctx.coords, dev)
            nu = shard_tree(nu, specs, ctx.sizes, ctx.coords, dev)
        del full
    opt_state = opt.init(params) if mu is None else AdamState(count=int(count), mu=mu, nu=nu)
    ctx.state[key] = RankTrainer(kind, cfg, opt, params, opt_state, int(step), specs, base=base, extra=extra)


def _batch_on(rows: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in rows.items()}


def rank_loss(ctx, st: RankTrainer, params, batch: dict) -> torch.Tensor:
    """The state's loss on this rank's rows (every rank's value is the
    global loss)."""
    from generativeaiexamples_tpu_torch.engine import training

    if st.kind == "bert":
        return training.contrastive_loss_fn(params, st.cfg, batch, temperature=st.extra.get("temperature", 0.05),
                                            mesh=ctx)
    if st.kind == "lora":
        from generativeaiexamples_tpu_torch.engine.lora import apply_lora

        params = apply_lora(st.base, params, st.extra["lora"], mesh=ctx)
    loss = st.loss or training.loss_fn
    return loss(params, st.cfg, batch["tokens"], batch["targets"], batch["mask"], ctx)


def sum_replicated(ctx, grads: list, specs: list, axes) -> list:
    """Each gradient summed over every populated axis of ``axes`` that its
    leaf is replicated over (one ``psum`` per axis, dtype and set of axes:
    the leaves concatenated)."""
    out = list(grads)
    groups: dict = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        over = tuple(a for a in axes if ctx.size(a) > 1 and a not in spec)
        if over:
            groups.setdefault((over, g.dtype), []).append(i)
    for (over, _), idx in groups.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for axis in over:
            flat = ctx.psum(flat, axis)
        for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
            out[i] = part.view(grads[i].shape)
    return out


def global_norm(ctx, grads: list, specs: list) -> torch.Tensor:
    """``optax.global_norm`` of the whole (unsharded) gradient: each leaf's
    local sum of squares in f32, summed over the axes that shard it and
    only those (a replicated leaf counts once)."""
    by_axes: dict = {}
    for g, spec in zip(grads, specs):
        over = sharded_axes(spec, ctx.sizes)
        s = g.float().square().sum()
        by_axes[over] = s if over not in by_axes else by_axes[over] + s
    total = None
    for over, s in by_axes.items():
        for axis in over:
            s = ctx.psum(s, axis)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _gradients(ctx, st: RankTrainer, rows: dict):
    """The loss on this rank's rows, the gradient of every leaf (summed over
    the replicated axes that split the work), the leaves' paths and the
    global grad norm."""
    items = flatten(st.params)
    paths = [p for p, _ in items]
    live = [leaf.detach().requires_grad_(True) for _, leaf in items]
    spec_of = dict(flatten(st.specs))
    specs = [spec_of[p] for p in paths]
    batch = _batch_on(rows, ctx.device)
    value, grads = value_and_grad(ctx, lambda: rank_loss(ctx, st, unflatten(zip(paths, live)), batch), live)
    with torch.no_grad():
        grads = sum_replicated(ctx, grads, specs, LORA_SUM_AXES if st.kind == "lora" else WORK_AXES)
        norm = global_norm(ctx, grads, specs)
    return value, paths, grads, norm


@grad_program
def step(ctx, key: str, options: dict, rows: dict) -> dict:
    """One optimizer step of the state under ``key`` on this rank's rows
    (``options`` updates the state's: its ``loss``, its ``cfg``, a
    ``temperature``); the step's loss and grad norm (the same on every
    rank)."""
    st = ctx.state[key]
    st.extra.update(options)
    st.loss = options.get("loss", st.loss)
    st.cfg = options.get("cfg", st.cfg)
    value, paths, grads, norm = _gradients(ctx, st, rows)
    with torch.no_grad():
        st.params, st.opt_state = st.opt.step(st.params, unflatten(zip(paths, grads)), st.opt_state)
    st.step += 1
    return {"loss": float(value), "grad_norm": float(norm)}


@grad_program
def loss_and_norm(ctx, key: str, rows: dict) -> tuple[float, float]:
    """The state's loss and grad norm on this rank's rows, without a step
    (tests and the card's planted faults)."""
    value, _, _, norm = _gradients(ctx, ctx.state[key], rows)
    return float(value), float(norm)


def gather_tree(ctx, tree, specs) -> dict:
    """Every leaf gathered whole over the axes that shard it (each rank
    takes part), as CPU tensors."""
    spec_of = dict(flatten(specs))
    out = []
    for path, x in flatten(tree):
        spec = tuple(spec_of[path]) + (None,) * (x.ndim - len(spec_of[path]))
        for dim, axis in enumerate(spec):
            if axis is not None and ctx.size(axis) > 1:
                x = ctx.all_gather(x.contiguous(), axis, dim)
        out.append((path, x.detach().cpu()))
    return unflatten(out)


def gather(ctx, key: str, parts=("params", "mu", "nu")) -> dict:
    """The state's trees gathered whole (rank 0's copy is the answer)."""
    st = ctx.state[key]
    trees = {"params": st.params, "mu": st.opt_state.mu, "nu": st.opt_state.nu}
    out = {name: gather_tree(ctx, trees[name], st.specs) for name in parts}
    out.update(count=st.opt_state.count, step=st.step)
    return out


def describe(ctx, key: str) -> dict:
    """Each leaf's whole shape and dtype (for a checkpoint's headers)."""
    st = ctx.state[key]
    spec_of = dict(flatten(st.specs))
    out = {}
    for name, tree in (("params", st.params), ("mu", st.opt_state.mu), ("nu", st.opt_state.nu)):
        for path, x in flatten(tree):
            spec = tuple(spec_of[path]) + (None,) * (x.ndim - len(spec_of[path]))
            shape = [n * (ctx.size(a) if a is not None else 1) for n, a in zip(x.shape, spec)]
            out[f"{name}/{path}"] = (shape, str(x.dtype).replace("torch.", ""))
    return {"leaves": out, "count": st.opt_state.count, "step": st.step}


def write(ctx, key: str, path: str) -> int:
    """Write this rank's slices into a checkpoint whose headers exist;
    returns the bytes written."""
    from generativeaiexamples_tpu_torch.engine.weights import write_checkpoint_shard

    st = ctx.state[key]
    trees = {"params": st.params, "mu": st.opt_state.mu, "nu": st.opt_state.nu}
    return write_checkpoint_shard(path, trees, st.specs, ctx.sizes, ctx.coords)


@grad_program
def load(ctx, key: str, path: str) -> dict:
    """Replace the state's params and moments with this rank's slices of a
    checkpoint (any mesh shape wrote it, or one device)."""
    from generativeaiexamples_tpu_torch.engine.training import AdamState
    from generativeaiexamples_tpu_torch.engine.weights import read_checkpoint_shard

    st = ctx.state[key]
    got = read_checkpoint_shard(path, ctx.sizes, ctx.coords, ctx.device, lambda _: st.specs)
    st.params = got["params"]
    st.opt_state = AdamState(count=got["count"], mu=got["mu"], nu=got["nu"])
    st.step = got["step"]
    return {"step": st.step}


def drop(ctx, key: str) -> None:
    ctx.state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


# -- the controller side ---------------------------------------------------------


@dataclasses.dataclass
class MeshTrainState:
    """A train state whose shards live on the ranks of ``mesh`` under
    ``key``; ``step`` counts the steps taken."""

    mesh: Any
    key: str
    kind: str
    cfg: Any
    step: int = 0

    def gather(self, parts=("params", "mu", "nu")):
        """A one-device ``TrainState`` of CPU tensors (tests, export): every
        leaf gathered whole."""
        from generativeaiexamples_tpu_torch.engine.training import AdamState, TrainState

        got = self.mesh.run(gather, self.key, tuple(parts))
        return TrainState(got.get("params"), AdamState(got["count"], got.get("mu"), got.get("nu")), got["step"])

    def release(self) -> None:
        """Free the shards on every rank."""
        self.mesh.run(drop, self.key)


def new_state(mesh, kind: str, cfg, opt, rules, source: tuple, **extra) -> MeshTrainState:
    """Build a state of ``kind`` on every rank of ``mesh`` (see :func:`init`)."""
    key = f"train{next(_KEYS)}"
    mesh.run(init, key, kind, cfg, opt, rules, source, dict(extra))
    state = MeshTrainState(mesh, key, kind, cfg)
    if source[0] == "state":
        state.step = int(source[5])
    elif source[0] == "checkpoint":
        state.step = int(mesh.run(_step_of, key))
    return state


def save(state: MeshTrainState, path: str) -> int:
    """Write a mesh state's checkpoint: the headers here, each rank's
    slices by that rank.  Returns the bytes the ranks wrote."""
    from generativeaiexamples_tpu_torch.engine.weights import create_checkpoint

    d = state.mesh.run(describe, state.key)
    create_checkpoint(path, d["leaves"], step=d["step"], count=d["count"])
    return sum(state.mesh.run(write, state.key, path, gather=True))


def load_state(state: MeshTrainState, path: str) -> MeshTrainState:
    """Each rank of ``state`` reads its slices of a checkpoint."""
    state.step = int(state.mesh.run(load, state.key, path)["step"])
    return state


def _step_of(ctx, key):
    return ctx.state[key].step


def host_tree(tree):
    """A tree of tensors as CPU tensors (to send to the ranks)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def upload(mesh, kind: str, cfg, opt, rules, state, **extra) -> MeshTrainState:
    """A one-device ``TrainState`` sharded onto ``mesh``."""
    o = state.opt_state
    return new_state(mesh, kind, cfg, opt, rules,
                     ("state", host_tree(state.params), host_tree(o.mu), host_tree(o.nu), o.count, state.step),
                     **extra)


def rank_rows(mesh, batch: dict, seq_keys=("tokens", "targets", "mask")) -> list:
    """Each rank's part of a batch (numpy): the rows of its block of the
    ``data`` x ``fsdp`` axes and, for ``seq_keys``, its chunk of the
    sequence over ``seq``."""
    sizes = mesh.shape
    blocks = sizes["data"] * sizes["fsdp"]
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
              for k, v in batch.items()}
    out = []
    for r in range(mesh.size):
        c = mesh.coords(r)
        k = c["data"] * sizes["fsdp"] + c["fsdp"]
        part = {}
        for name, a in arrays.items():
            if a.shape[0] % blocks:
                raise ValueError(f"batch {a.shape[0]} rows do not split over data x fsdp = {blocks}")
            per = a.shape[0] // blocks
            a = a[k * per : (k + 1) * per]
            if name in seq_keys and sizes["seq"] > 1:
                if a.shape[1] % sizes["seq"]:
                    raise ValueError(f"sequence {a.shape[1]} does not split over seq = {sizes['seq']}")
                n = a.shape[1] // sizes["seq"]
                a = a[:, c["seq"] * n : (c["seq"] + 1) * n]
            part[name] = np.ascontiguousarray(a)
        out.append(part)
    return out


def run_step(state: MeshTrainState, batch: dict, seq_keys=("tokens", "targets", "mask"), **options):
    """One step on the ranks: ``(state, {"loss", "grad_norm"})`` (floats).
    ``options`` (a ``loss``, the step's ``cfg``, a ``temperature``)
    replace the state's."""
    options = {k: v for k, v in options.items() if v is not None}
    metrics = state.mesh.run(step, state.key, options, rank_args=rank_rows(state.mesh, batch, seq_keys))
    state.step += 1
    return state, metrics


def check_axes(mesh, allowed, what: str) -> None:
    """Refuse a mesh that populates an axis ``what`` does not split."""
    bad = [a for a in MESH_AXES if a not in allowed and mesh.shape[a] > 1]
    if bad:
        raise NotImplementedError(f"{what} over a mesh splits {sorted(allowed)}; this mesh populates {bad}")
