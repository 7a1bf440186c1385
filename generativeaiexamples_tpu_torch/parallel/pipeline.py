"""Pipeline parallelism: GPipe-style layer stages over the ``pipe`` mesh
axis (port of ``parallel/pipeline.py``).

* **Stage = contiguous layer shard.** The stacked (L, ...) layer leaves
  shard over ``pipe`` on their leading axis (:func:`pipeline_rules` maps
  the ``layers`` logical axis to ``pipe``), so stage ``k`` holds layers
  ``[k L/S, (k+1) L/S)``.
* **The GPipe schedule** (:func:`_pipeline_run`), run by every rank of the
  ``pipe`` axis: ``n_micro + S - 1`` ticks; at tick ``t`` stage ``k`` runs
  microbatch ``t - k`` through its layers (``models.llama.dense_layer``,
  each under remat), then hands its activation to stage ``k + 1`` with a
  ``ppermute``.  A stage skips the compute of a bubble tick (no
  microbatch), never the tick's ``ppermute``, so every rank issues the
  same collectives.  The backward is autograd through the schedule: the
  hand-offs' backward sends each activation's gradient to the stage before
  (``parallel.autograd``), and each stage recomputes its layers from the
  microbatch inputs it kept.
* **Stage-local embedding and head.** Embedding, final norm and head are
  replicated over ``pipe``; the embedding runs on stage 0 only and the
  head and cross entropy on the last stage only (branches that hold no
  collective), so the loss forward's only cross-stage traffic is one
  microbatch activation per tick and two scalar ``psum``s.  The backward
  then sums the replicated leaves' gradients over ``pipe``
  (``engine.mesh_training.sum_replicated``).  :func:`pipeline_forward`
  (hidden states) sums the last stage's masked output over ``pipe``.

Composes with ``data`` (each data group pipelines its rows) and with
``tensor`` inside each stage (``pipeline_rules(tensor=True)``: Megatron
tensor parallelism through ``dense_layer(tp_axis="tensor")``).  Dense
configs only, as the reference.

These functions run on a rank: ``mesh`` is its
``parallel.runtime.RankContext``, ``params`` its shards and ``tokens`` its
data group's rows.  The hand-off is a chain ``k -> k + 1`` (the
reference's ring also sends the last stage's activation to stage 0, which
never reads it).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel.mesh import default_rules


def pipeline_rules(tensor: bool = False) -> dict:
    """Sharding rules for the pipelined path: layer stacks over ``pipe``;
    with ``tensor=True`` the head and MLP axes also over ``tensor``
    (Megatron inside each stage); embedding, head and norms replicated."""
    rules = default_rules()
    rules.update(layers="pipe", vocab=None, heads="tensor" if tensor else None,
                 kv_heads="tensor" if tensor else None, mlp="tensor" if tensor else None)
    return rules


def check_pipeline(cfg: llama.LlamaConfig, sizes, batch: int, n_micro: Optional[int]) -> int:
    """The reference's refusals; returns the microbatch count.  ``batch``
    is the whole batch's rows."""
    if cfg.n_experts > 1:
        raise NotImplementedError("pipeline supports dense configs")
    S = sizes["pipe"]
    if cfg.n_layers % S:
        raise ValueError(f"{cfg.n_layers} layers not divisible by pipe={S}")
    M = n_micro or S
    dp = sizes.get("data", 1)
    if batch % (dp * M):
        raise ValueError(f"batch {batch} must be a multiple of data({dp}) × n_micro({M})")
    tp = sizes.get("tensor", 1)
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp):
        raise ValueError(f"heads/kv/d_ff ({cfg.n_heads}/{cfg.n_kv_heads}/{cfg.d_ff}) not divisible by tensor={tp}")
    for axis in ("fsdp", "seq", "expert"):
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(f"the pipeline composes with data and tensor, not {axis}")
    return M


def hand_off(mesh, y: torch.Tensor) -> torch.Tensor:
    """One tick's activation to the next stage (stage ``k`` -> ``k + 1``)."""
    S = mesh.size("pipe")
    return mesh.ppermute(y.contiguous(), "pipe", [(i, i + 1) for i in range(S - 1)])


def _pipeline_run(params, cfg: llama.LlamaConfig, tokens, positions, mesh, kv_lengths=None,
                  n_micro: Optional[int] = None, targets=None, mask=None):
    """The GPipe schedule on this rank (module docstring).  Without
    ``targets``: the data group's final hidden states (every stage holds
    them).  With them: the masked next-token cross entropy, the global
    mean over every stage and data group."""
    from generativeaiexamples_tpu_torch.engine.training import cross_entropy_terms
    from generativeaiexamples_tpu_torch.parallel.autograd import psum_axes

    lb, s = tokens.shape
    M = check_pipeline(cfg, mesh.sizes, lb * mesh.size("data"), n_micro)
    S, stage = mesh.size("pipe"), mesh.index("pipe")
    tp_axis = "tensor" if mesh.size("tensor") > 1 else None
    mb, d = lb // M, cfg.d_model
    dt = cfg.compute_dtype
    dev = tokens.device
    x_mb = None
    if stage == 0:
        x = llama.embed(params, tokens, dt)
        if cfg.scale_embeddings:
            x = x * torch.tensor(d**0.5, dtype=x.dtype, device=x.device)
        x_mb = x.reshape(M, mb, s, d)
    pos_mb = positions.reshape(M, mb, s)
    kvl_mb = kv_lengths.reshape(M, mb) if kv_lengths is not None else None
    n_local = params["layers"]["attn_norm"].shape[0]

    def one_layer(x, li, pos, kvl):
        lp = llama._layer_params(params["layers"], li)
        return llama.dense_layer(x, lp, cfg, pos, kvl, mesh if tp_axis else None, tp_axis=tp_axis)

    def local_layers(x, pos, kvl):
        for li in range(n_local):
            if torch.is_grad_enabled() and cfg.remat:
                x = torch.utils.checkpoint.checkpoint(one_layer, x, li, pos, kvl, use_reentrant=False)
            else:
                x = one_layer(x, li, pos, kvl)
        return x

    state = torch.zeros((mb, s, d), dtype=dt, device=dev)
    outs = [None] * M
    for t in range(M + S - 1):
        j = t - stage
        if 0 <= j < M:
            y = local_layers(x_mb[j] if stage == 0 else state, pos_mb[j], kvl_mb[j] if kvl_mb is not None else None)
            if stage == S - 1:
                outs[j] = y
        else:
            y = torch.zeros((mb, s, d), dtype=dt, device=dev)  # a bubble: no compute, the hand-off all the same
        state = hand_off(mesh, y)
    if targets is not None:
        total = torch.zeros((), dtype=torch.float32, device=dev)
        count = torch.zeros((), dtype=torch.float32, device=dev)
        if stage == S - 1:
            hidden = llama.apply_final_norm(torch.cat(outs), cfg, params)
            total, count = cross_entropy_terms(params, hidden, targets, mask)
        total = psum_axes(mesh, total.float(), ("pipe", "data"))
        count = psum_axes(mesh, count.float(), ("pipe", "data"))
        return -total / torch.clamp(count, min=1.0)
    out = torch.cat(outs) if stage == S - 1 else torch.zeros((lb, s, d), dtype=dt, device=dev)
    return llama.apply_final_norm(mesh.psum(out, "pipe"), cfg, params)


def pipeline_forward(params, cfg: llama.LlamaConfig, tokens, positions, mesh, kv_lengths=None,
                     n_micro: Optional[int] = None) -> torch.Tensor:
    """Cacheless forward through the pipeline stages; this data group's
    hidden states (``params`` sharded with :func:`pipeline_rules`; the rows
    divide into ``n_micro``)."""
    return _pipeline_run(params, cfg, tokens, positions, mesh, kv_lengths, n_micro)


def pipeline_loss_fn(params, cfg: llama.LlamaConfig, tokens, targets, mask, mesh,
                     n_micro: Optional[int] = None) -> torch.Tensor:
    """Masked next-token cross entropy computed on the last pipeline stage
    (scalar collectives only, no activation broadcast); the global loss on
    every rank."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    return _pipeline_run(params, cfg, tokens, positions, mesh, None, n_micro, targets=targets, mask=mask)


def make_pipeline_train_step(cfg: llama.LlamaConfig, optimizer, mesh, n_micro: Optional[int] = None):
    """The pipelined train step: ``engine.training.make_train_step`` with
    the pipelined loss (one optimizer-update and metrics path).  The state
    comes from ``init_train_state(..., mesh=mesh, rules=pipeline_rules(
    tensor=mesh.shape["tensor"] > 1))``."""
    from generativeaiexamples_tpu_torch.engine.training import make_train_step

    step = make_train_step(cfg, optimizer, mesh, loss=functools.partial(pipeline_loss_fn, n_micro=n_micro))

    def train_step(state, batch):
        check_pipeline(cfg, mesh.shape, len(batch["tokens"]), n_micro)
        return step(state, batch)

    return train_step
