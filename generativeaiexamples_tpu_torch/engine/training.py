"""Training on one device for the llama family and the BERT embedder (port
of ``engine/training.py``).

A next-token cross-entropy step with AdamW and per-layer
rematerialization (``models.llama.forward(remat=True)``), and the
contrastive (InfoNCE) step for embedder fine-tuning.  Gradients come from
``torch.autograd`` on the same functions the reference differentiates
with ``jax.value_and_grad``; on the card the attention runs through the
flash kernel's autograd wrapper (``ops.flash_attention.
FlashAttentionFunction``).

Over a device mesh (``parallel.mesh.make_mesh``) the state lives on the
ranks (``engine.mesh_training``): :func:`init_train_state` and
:func:`init_bert_train_state` with ``mesh`` shard it with
``fsdp_rules`` as the reference does, and the steps run each rank's share
(:func:`loss_fn` with ``mesh`` a rank's context: the batch split over
``data`` x ``fsdp``, the sequence over ``seq``, the loss the global masked
mean).

Documented differences from the reference:

* The optimizer is :class:`AdamW`, written here to follow
  ``optax.adamw``'s defaults and arithmetic order (not
  ``torch.optim.AdamW``, which rounds in another order).
* Checkpoints are the port's own format (``engine.weights.
  save_checkpoint``: one ``.npy`` a leaf and an index, written and read
  slice by slice over a mesh); the reference's are orbax, a JAX format.
* Over a mesh the attention of each rank runs the port's flash kernel on
  its local heads (the reference keeps Pallas off multi-device meshes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import f32

# Weight of the MoE load-balancing auxiliary loss (Switch Transformer's
# default order of magnitude); only applies when cfg.n_experts > 1.
MOE_AUX_WEIGHT = 0.01


# Axes that split a batch (rows over data and fsdp, the sequence over
# seq): the loss's total and count are summed over them.
BATCH_AXES = ("data", "fsdp", "seq")


# -- trees ---------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree, in a fixed order (dict
    insertion order, depth first)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum over leaves of
    each leaf's sum of squares, in f32."""
    total = None
    for g in tree_leaves(tree):
        s = g.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


# -- the optimizer -------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    """``optax.ScaleByAdamState``: steps taken and both moment trees (in
    each parameter's dtype)."""

    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0; weight decay on every leaf), in its arithmetic order, leaf
    by leaf in the leaf's dtype::

        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
        p = p + -lr * (u + wd * p)

    ``b**t`` is computed in f32 on the host as XLA does (``pow(f32, f32)``)
    and cast to the leaf's dtype before dividing.  With ``weight_decay=0``
    this is ``optax.adam``."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format), params)
        return AdamState(count=0, mu=zeros, nu=tree_map(torch.zeros_like, zeros))

    @staticmethod
    def _correction(decay: float, count: int) -> torch.Tensor:
        one = torch.tensor(1.0, dtype=torch.float32)
        return one - torch.pow(torch.tensor(decay, dtype=torch.float32), torch.tensor(float(count)))

    @torch.no_grad()
    def step(self, params, grads, state: AdamState) -> tuple[Any, AdamState]:
        """New params and state from ``grads`` (trees like ``params``)."""
        count = state.count + 1
        bc1, bc2 = self._correction(self.b1, count), self._correction(self.b2, count)

        def leaf(p, g, mu, nu):
            g = g.to(p.dtype)
            mu = (1 - self.b1) * g + self.b1 * mu
            nu = (1 - self.b2) * (g * g) + self.b2 * nu
            # Divisors are tensors on the leaf's device: CUDA turns a
            # division by a Python scalar into a product by its reciprocal.
            mu_hat = mu / bc1.to(device=p.device, dtype=p.dtype)
            nu_hat = nu / bc2.to(device=p.device, dtype=p.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            return (p + (-self.learning_rate) * u).to(p.dtype), mu, nu

        out = tree_map(leaf, params, grads, state.mu, state.nu)
        return _pick(out, 0), AdamState(count=count, mu=_pick(out, 1), nu=_pick(out, 2))


def _pick(tree, i: int):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(learning_rate, weight_decay)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamState
    step: int


# -- losses --------------------------------------------------------------------


def loss_fn(
    params: Any,
    cfg: llama.LlamaConfig,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    mesh=None,
) -> torch.Tensor:
    """Masked next-token cross entropy (tokens (b, s) -> targets (b, s)),
    through the rematerialized forward.  MoE configs add the router
    load-balancing auxiliary loss.

    ``mesh`` (a rank's ``parallel.runtime.RankContext``, inside a training
    program) makes this one rank's share: ``tokens``, ``targets`` and
    ``mask`` are its rows and its chunk of the sequence (positions from
    the chunk's global offset), ``params`` its shards.  The result is the
    global loss on every rank: the masked total and count summed over
    ``data``, ``fsdp`` and ``seq`` before the one division (the ranks'
    mask counts differ), the aux loss the mean over every dispatch group
    of the global batch."""
    b, s = tokens.shape
    offset = mesh.index("seq") * s if mesh is not None else 0
    positions = (torch.arange(s, dtype=torch.int32, device=tokens.device) + offset).expand(b, s)
    kw = {} if mesh is None else {"mesh": mesh, "seq_sharded": mesh.size("seq") > 1}
    if cfg.n_experts > 1:
        hidden, _, aux = llama.forward(params, cfg, tokens, positions, remat=True, return_aux=True, **kw)
    else:
        (hidden, _), aux = llama.forward(params, cfg, tokens, positions, remat=True, **kw), None
    if mesh is None:
        ce = masked_cross_entropy(params, hidden, targets, mask)
        return ce if aux is None else ce + MOE_AUX_WEIGHT * aux
    from generativeaiexamples_tpu_torch.parallel.autograd import psum_axes

    total, count = cross_entropy_terms(params, hidden, targets, mask, mesh)
    loss = -psum_axes(mesh, total, BATCH_AXES) / torch.clamp(psum_axes(mesh, count, BATCH_AXES), min=1.0)
    return loss if aux is None else loss + MOE_AUX_WEIGHT * psum_axes(mesh, aux, BATCH_AXES)


def cross_entropy_terms(params: Any, hidden: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked total log-prob, mask count) for next-token CE: the one place
    the loss math lives (every trainer divides these).

    With ``mesh`` (a rank's context) the head may be held in shards: over
    ``fsdp`` it is gathered; over ``tensor`` (the vocabulary) the (b, s,
    vocab) logits are never gathered: each row's max and sum of
    exponentials are reduced over the axis, and the target's logit comes
    from the rank that holds it (a ``psum`` of one nonzero term)."""
    head = params["lm_head"]
    if mesh is not None and head.shape[0] != hidden.shape[-1]:
        head = llama.fsdp_gather(head, mesh, 0)
    mask = mask.float()
    if mesh is None or mesh.size("tensor") == 1:
        logprobs = F.log_softmax(llama.logits({"lm_head": head}, hidden), dim=-1)
        picked = torch.gather(logprobs, -1, targets.long()[..., None])[..., 0]
        return (picked * mask).sum(), mask.sum()
    local = llama.logits({"lm_head": head}, llama.column_input(hidden, mesh, "tensor"))
    with torch.no_grad():
        top = mesh.all_gather(local.amax(-1, keepdim=True).contiguous(), "tensor", dim=-1).amax(-1, keepdim=True)
    lse = top[..., 0] + torch.log(mesh.psum(torch.exp(local - top).sum(-1), "tensor"))
    rows = local.shape[-1]
    here = targets.long() - mesh.index("tensor") * rows
    inside = (here >= 0) & (here < rows)
    picked = torch.gather(local, -1, here.clamp(0, rows - 1)[..., None])[..., 0] * inside
    picked = mesh.psum(picked, "tensor") - lse
    return (picked * mask).sum(), mask.sum()


def masked_cross_entropy(params: Any, hidden: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Project hidden states and compute masked next-token CE."""
    total, count = cross_entropy_terms(params, hidden, targets, mask)
    return -total / torch.clamp(count, min=1.0)


# -- steps ---------------------------------------------------------------------


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _on(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v, device=device)
            for k, v in batch.items()}


def value_and_grad(loss: Callable, params, *args) -> tuple[torch.Tensor, Any]:
    """``loss(params, *args)`` and its gradient with respect to every leaf
    of ``params`` (a tree like it), as ``jax.value_and_grad``: the leaves
    are taken as fresh graph inputs, so the caller's tensors are left as
    they are."""
    leaves = tree_leaves(params)
    it = iter([leaf.detach().requires_grad_(True) for leaf in leaves])
    live = tree_map(lambda _: next(it), params)
    live_leaves = tree_leaves(live)
    with torch.enable_grad():
        value = loss(live, *args)
        grads = torch.autograd.grad(value, live_leaves)
    it = iter(grads)
    return value.detach(), tree_map(lambda _: next(it), params)


def apply_gradients(state: TrainState, optimizer: AdamW, loss_val: torch.Tensor, grads) -> tuple[TrainState, dict]:
    """The optimizer's update of ``state`` from ``grads``, and the step's
    metrics (``loss``, ``grad_norm`` as ``optax.global_norm``)."""
    params, opt_state = optimizer.step(state.params, grads, state.opt_state)
    return TrainState(params, opt_state, state.step + 1), {"loss": loss_val, "grad_norm": global_norm(grads)}


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW, mesh=None, loss=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``loss`` overrides the loss function (same signature as
    :func:`loss_fn`; over a mesh a module-level function or a
    ``functools.partial`` of one, as it is sent to the ranks).  MoE
    configs train with capacity-factor dispatch whatever the preset's
    serving ``moe_dropless``, as the reference does.

    With ``mesh`` (a ``parallel.mesh.Mesh``) the step takes a
    :class:`~generativeaiexamples_tpu_torch.engine.mesh_training.MeshTrainState`
    (:func:`init_train_state` with the mesh; a one-device ``TrainState`` is
    sharded onto the mesh with ``fsdp_rules`` at its first step), sends
    each rank its rows of the batch and returns ``{"loss", "grad_norm"}``
    as floats.
    """
    if cfg.n_experts > 1 and cfg.moe_dropless:
        cfg = dataclasses.replace(cfg, moe_dropless=False)
    if mesh is not None:
        from generativeaiexamples_tpu_torch.engine import mesh_training
        from generativeaiexamples_tpu_torch.parallel.mesh import fsdp_rules

        def mesh_step(state, batch: dict):
            if isinstance(state, TrainState):
                state = mesh_training.upload(mesh, "llama", cfg, optimizer, fsdp_rules(), state)
            return mesh_training.run_step(state, batch, loss=loss, cfg=cfg)

        return mesh_step
    loss = loss or loss_fn

    def train_step(state: TrainState, batch: dict):
        b = _on(batch, _device_of(state.params))
        loss_val, grads = value_and_grad(
            lambda p: loss(p, cfg, b["tokens"], b["targets"], b["mask"], mesh), state.params
        )
        return apply_gradients(state, optimizer, loss_val, grads)

    return train_step


def init_train_state(
    cfg: llama.LlamaConfig,
    optimizer: AdamW,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    *,
    device=None,
    params: Any = None,
    rules=None,
):
    """Random params (``engine.decode.init_random_params`` from
    ``generator``, by default seed 0 on ``device``) and a fresh optimizer
    state.  ``device`` defaults to the card.

    With ``mesh`` the state is built on its ranks, each holding its shard
    under ``rules`` (default ``fsdp_rules()``, as the reference; the
    pipeline's ``pipeline_rules()``): drawn on each rank's device from
    ``generator``'s state (a generator on the ranks' device type), or
    sliced from ``params`` (a tree of CPU tensors or numpy arrays).
    Returns a ``MeshTrainState``."""
    from generativeaiexamples_tpu_torch.engine.decode import init_random_params

    if mesh is not None:
        from generativeaiexamples_tpu_torch.engine import mesh_training
        from generativeaiexamples_tpu_torch.parallel.mesh import fsdp_rules

        if cfg.n_experts > 1 and cfg.moe_dropless:  # training's dispatch, as make_train_step's
            cfg = dataclasses.replace(cfg, moe_dropless=False)
        source = _mesh_source(params, generator, mesh)
        return mesh_training.new_state(mesh, "llama", cfg, optimizer, rules or fsdp_rules(), source)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = init_random_params(cfg, generator, dev)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _mesh_source(params, generator, mesh) -> tuple:
    """Where each rank gets its params: a tree sent to every rank, or the
    generator's state (seed 0 on the ranks' device by default)."""
    from generativeaiexamples_tpu_torch.engine.mesh_training import host_tree

    if params is not None:
        return ("tree", host_tree(params))
    if generator is None:
        generator = torch.Generator(device=mesh.devices.flat[0]).manual_seed(0)
    return ("seed", generator.get_state())


# -- contrastive embedder fine-tuning --------------------------------------------


def contrastive_loss_fn(params: Any, cfg, batch: dict, *, temperature: float = 0.05, mesh=None) -> torch.Tensor:
    """InfoNCE over (query, positive, hard negatives) with in-batch
    negatives: for each query a softmax cross-entropy over its similarity
    row against every passage of the batch, its own positive the label.

    Batch layout: ``q_tokens``/``q_mask`` (b, s); ``p_tokens``/``p_mask``
    (b, 1 + n_negs, s) with slot 0 the positive.

    With ``mesh`` (a rank's context; the batch's rows split over ``data``
    x ``fsdp``) each query is still scored against every passage of the
    whole batch: the passages' embeddings are gathered over both axes (the
    gradient flows back through the gather), each query's label is offset
    by its rank's rows, and the loss is the mean over every query.  fsdp
    shards of ``params`` are gathered whole at the start."""
    from generativeaiexamples_tpu_torch.models import bert

    if mesh is not None:
        params = _gather_bert(params, cfg, mesh)
    b, s = batch["q_tokens"].shape
    n_p = batch["p_tokens"].shape[1]
    q_emb = bert.embed(params, cfg, batch["q_tokens"], batch["q_mask"])
    p_emb = bert.embed(params, cfg, batch["p_tokens"].reshape(b * n_p, s), batch["p_mask"].reshape(b * n_p, s))
    first = 0
    if mesh is not None:
        p_emb = mesh.all_gather(mesh.all_gather(p_emb, "fsdp", dim=0), "data", dim=0)
        first = (mesh.index("data") * mesh.size("fsdp") + mesh.index("fsdp")) * b
    sims = f32.matmul(q_emb, p_emb.t())
    scores = sims / torch.full((), temperature, dtype=sims.dtype, device=sims.device)  # (b, B * n_p)
    labels = (first + torch.arange(b, device=scores.device)) * n_p  # each query's positive
    logprobs = F.log_softmax(scores, dim=-1)
    picked = torch.gather(logprobs, -1, labels[:, None])
    if mesh is None:
        return -picked.mean()
    from generativeaiexamples_tpu_torch.parallel.autograd import psum_axes

    return -psum_axes(mesh, picked.sum(), ("data", "fsdp")) / (b * mesh.size("data") * mesh.size("fsdp"))


def _gather_bert(params, cfg, mesh):
    """A BERT tree's fsdp shards gathered whole (each on its ``embed``
    axis), through the differentiable gather."""
    from generativeaiexamples_tpu_torch.models import bert

    if mesh.size("fsdp") == 1:
        return params
    axes = bert.param_axes(cfg)

    def leaf(x, logical):
        return mesh.all_gather(x, "fsdp", logical.index("embed")) if "embed" in logical else x

    out = {k: leaf(v, axes[k][1]) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: leaf(v, axes["layers"][k][1]) for k, v in params["layers"].items()}
    return out


def make_contrastive_train_step(cfg, optimizer: AdamW, *, temperature: float = 0.05):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a
    ``models.bert`` encoder (batch layout per :func:`contrastive_loss_fn`).
    A ``MeshTrainState`` (:func:`init_bert_train_state` with a mesh) steps
    on its ranks, each sent its rows."""

    def train_step(state, batch: dict):
        from generativeaiexamples_tpu_torch.engine import mesh_training

        if isinstance(state, mesh_training.MeshTrainState):
            return mesh_training.run_step(state, batch, seq_keys=(), temperature=temperature)
        return one_device_step(state, batch)

    def one_device_step(state: TrainState, batch: dict):
        b = _on(batch, _device_of(state.params))
        loss_val, grads = value_and_grad(lambda p: contrastive_loss_fn(p, cfg, b, temperature=temperature),
                                         state.params)
        return apply_gradients(state, optimizer, loss_val, grads)

    return train_step


def init_bert_train_state(
    cfg,
    optimizer: AdamW,
    params: Any = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    *,
    device=None,
) -> TrainState:
    """TrainState for embedder fine-tuning; pass converted checkpoint
    ``params`` to fine-tune rather than train from scratch.

    With ``mesh`` the state is built on its ranks, sharded with
    ``bert.partition_specs(cfg, fsdp_rules())`` (from ``params``, a tree of
    CPU tensors or numpy, or drawn on each rank from ``generator``'s
    state); the contrastive step splits its batch over ``data`` x
    ``fsdp``, the only axes it splits."""
    from generativeaiexamples_tpu_torch.models import bert

    if mesh is not None:
        from generativeaiexamples_tpu_torch.engine import mesh_training
        from generativeaiexamples_tpu_torch.parallel.mesh import fsdp_rules

        mesh_training.check_axes(mesh, ("data", "fsdp"), "the contrastive step")
        return mesh_training.new_state(mesh, "bert", cfg, optimizer, fsdp_rules(),
                                       _mesh_source(params, generator, mesh))
    if params is None:
        dev = resolve_device(device)
        params = bert.init_params(cfg, generator or torch.Generator(device=dev).manual_seed(0), dev)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_contrastive_batch(examples, tokenizer, *, max_length: int = 128, n_negs: int = 2,
                           query_prefix: str = "") -> dict:
    """Tokenize ``{query, pos_doc, neg_doc}`` records into the contrastive
    batch layout (int32 tensors on the CPU).  Examples with fewer than
    ``n_negs`` mined negatives pad with OTHER examples' positives (a batch
    of one with a fixed unrelated literal), never the example's own
    positive, which would fight its own label in the softmax."""
    b = len(examples)
    n_p = 1 + n_negs

    def encode(text):
        return tokenizer.encode(text, add_bos=True)[:max_length]

    q_tokens = np.zeros((b, max_length), np.int32)
    q_mask = np.zeros((b, max_length), np.int32)
    p_tokens = np.zeros((b, n_p, max_length), np.int32)
    p_mask = np.zeros((b, n_p, max_length), np.int32)
    for i, ex in enumerate(examples):
        q = encode(query_prefix + ex["query"])
        q_tokens[i, : len(q)] = q
        q_mask[i, : len(q)] = 1
        docs = [ex["pos_doc"]] + list(ex.get("neg_doc", []))[:n_negs]
        others = [examples[j]["pos_doc"] for j in range(b) if j != i]
        oi = 0
        while len(docs) < n_p:
            docs.append(others[oi % len(others)] if others else "[pad negative]")
            oi += 1
        for j, doc in enumerate(docs):
            ids = encode(doc)
            p_tokens[i, j, : len(ids)] = ids
            p_mask[i, j, : len(ids)] = 1
    return {name: torch.from_numpy(a) for name, a in
            (("q_tokens", q_tokens), ("q_mask", q_mask), ("p_tokens", p_tokens), ("p_mask", p_mask))}


# -- checkpoints -----------------------------------------------------------------


def save_train_state(state, path: str) -> None:
    """Checkpoint the whole train state (params, both moments, Adam's count
    and the step) in the port's format (``engine.weights.save_checkpoint``,
    a directory).  A ``MeshTrainState`` is written by its ranks, each its
    own slices."""
    from generativeaiexamples_tpu_torch.engine import mesh_training
    from generativeaiexamples_tpu_torch.engine.weights import save_checkpoint

    if isinstance(state, mesh_training.MeshTrainState):
        mesh_training.save(state, path)
        return
    opt = state.opt_state
    save_checkpoint({"params": state.params, "mu": opt.mu, "nu": opt.nu}, path, step=state.step, count=opt.count)


def load_train_state(abstract_state, path: str):
    """Restore a checkpoint onto ``abstract_state``'s structure, devices
    and dtypes (every leaf's shape and dtype must match), whatever mesh or
    single device wrote it.  A ``MeshTrainState``'s ranks each read only
    their slices (resume on the same or a differently shaped mesh)."""
    from generativeaiexamples_tpu_torch.engine import mesh_training
    from generativeaiexamples_tpu_torch.engine.weights import load_checkpoint

    if isinstance(abstract_state, mesh_training.MeshTrainState):
        return mesh_training.load_state(abstract_state, path)
    got = load_checkpoint(path, device="cpu")
    like = {"params": abstract_state.params, "mu": abstract_state.opt_state.mu, "nu": abstract_state.opt_state.nu}

    def place(saved, want):
        if tuple(saved.shape) != tuple(want.shape) or saved.dtype != want.dtype:
            raise ValueError(f"checkpoint leaf {tuple(saved.shape)} {saved.dtype} does not match "
                             f"{tuple(want.shape)} {want.dtype}")
        return saved.to(want.device)

    try:
        placed = {k: tree_map(place, got[k], like[k]) for k in like}
    except KeyError as e:
        raise ValueError(f"checkpoint {path} does not hold the state's tree: {e}") from e
    return TrainState(placed["params"], AdamState(int(got["count"]), placed["mu"], placed["nu"]), int(got["step"]))
