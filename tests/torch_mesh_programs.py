"""Programs the mesh tests run on every rank (``Mesh.run``).

They live outside the test modules so that a follower rank unpickling one
imports this module only: the port and numpy, never JAX.
"""

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.weights import shard_params
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import ring_attention as ra
from generativeaiexamples_tpu_torch.parallel.runtime import grad_program


def cpu_ranks():
    """Four CPU ranks (gloo, 20 s group timeout, the host's cores shared
    among them), shared by every mesh test of this process and closed at
    its exit."""
    from generativeaiexamples_tpu_torch.parallel.runtime import get_runtime

    return get_runtime(["cpu"] * 4, timeout_s=20.0)


def _t(a, dev):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def info(ctx):
    import os

    return ctx.rank, dict(ctx.coords), os.getpid(), str(ctx.device)


def shard_tree(ctx, tree, cfg):
    """This rank's slice of every leaf, as numpy (QuantizedMatrix as
    ``(q, scale)``)."""
    out = shard_params(tree, cfg, ctx.sizes, ctx.coords, "cpu")

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if hasattr(x, "q"):
            return (x.q.numpy(), x.scale.numpy())
        return x.numpy()

    return host(out)


def seq_attention(ctx, q, k, v, kv_len, strategy):
    q, k, v, kv_len = (_t(a, ctx.device) for a in (q, k, v, kv_len))
    pos = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[0], -1).contiguous()
    return ra.sequence_parallel_attention(q, k, v, pos, kv_len, mesh=ctx, strategy=strategy).numpy()


def attention_dispatch(ctx, q, k, v):
    from generativeaiexamples_tpu_torch.ops.attention import attention

    q, k, v = (_t(a, ctx.device) for a in (q, k, v))
    pos = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[0], -1).contiguous()
    return attention(q, k, v, pos, None, mesh=ctx).numpy()


def load(ctx, key, tree, cfg):
    """Keep this rank's shard of ``tree`` under ``key``."""
    ctx.state[key] = shard_params(tree, cfg, ctx.sizes, ctx.coords, ctx.device)


def _rows(ctx, n):
    per = n // ctx.size("data")
    return slice(ctx.index("data") * per, (ctx.index("data") + 1) * per)


def forward(ctx, key, cfg, tokens, gather_data=True):
    """Cacheless forward of this rank's data rows; the hidden states of the
    whole batch (gathered over data)."""
    tokens = _t(tokens, ctx.device)[_rows(ctx, tokens.shape[0])]
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    h, _ = llama.forward(ctx.state[key], cfg, tokens.long(), pos, mesh=ctx)
    return ctx.all_gather(h.contiguous(), "data", dim=0).numpy() if gather_data else h.numpy()


def prefill_decode(ctx, key, cfg, tokens, next_token, max_len):
    """Cold prefill of ``tokens`` (1, s) into this rank's cache shard, then
    one warm decode step of ``next_token``; both hidden states."""
    dev = ctx.device
    t = _t(tokens, dev).long()
    s = t.shape[1]
    cache = llama.init_kv_cache(llama.local_config(cfg, ctx), 1, max_len, device=dev)
    pos = torch.arange(s, dtype=torch.int32)[None]
    h, cache = llama.forward(ctx.state[key], cfg, t, pos, cache, torch.tensor([s], dtype=torch.int32),
                             cold_prefill=True, mesh=ctx)
    step, _ = llama.forward(ctx.state[key], cfg, torch.tensor([[next_token]]), torch.tensor([[s]], dtype=torch.int32),
                            cache, torch.tensor([s + 1], dtype=torch.int32), mesh=ctx)
    return h.numpy(), step.numpy()


def dense_layer_tp(ctx, key, cfg, x):
    lp = {k: v[0] for k, v in ctx.state[key]["layers"].items()}
    x = _t(x, ctx.device)
    pos = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape[0], -1).contiguous()
    return llama.dense_layer(x, lp, cfg, pos, mesh=ctx, tp_axis="tensor").numpy()


def logits(ctx, key, cfg, tokens):
    tokens = _t(tokens, ctx.device).long()
    pos = torch.arange(tokens.shape[1], dtype=torch.int32).expand(tokens.shape[0], -1).contiguous()
    h, _ = llama.forward(ctx.state[key], cfg, tokens, pos, mesh=ctx)
    return llama.logits(ctx.state[key], h, ctx).numpy()


def comm_stats(ctx):
    from generativeaiexamples_tpu_torch.parallel.comm import COMM_STATS

    return dict(COMM_STATS)


def fail(ctx, rank=None):
    """Raise on ``rank`` (every rank: None)."""
    if rank is None or ctx.rank == rank:
        raise ValueError(f"planted failure on rank {ctx.rank}")


def psum_ones(ctx):
    return ctx.psum(torch.ones(1), "tensor").item()


def state_keys(ctx):
    """What programs keep on this rank for the mesh (sorted keys)."""
    return sorted(ctx.state)


@grad_program
def loss_with_local_groups(ctx, key, rows):
    """The state's loss with each seq rank forming its own MoE groups from
    its chunk (the trap the global groups avoid): the mesh forward told
    its sequence is whole on the rank for the MoE layers only."""
    from generativeaiexamples_tpu_torch.engine import mesh_training

    real = llama._moe_mlp

    def local_groups(h, lp, cfg, mesh=None, seq_sharded=False):
        out, aux = real(h, lp, cfg, mesh, False)
        return out, aux / ctx.size("seq")  # each rank's share of the mean over its own groups

    llama._moe_mlp = local_groups
    try:
        return mesh_training.loss_and_norm(ctx, key, rows)[0]
    finally:
        llama._moe_mlp = real


@grad_program
def traced_step(ctx, key, rows):
    """One training step with this rank's collectives recorded in order."""
    from generativeaiexamples_tpu_torch.engine import mesh_training
    from generativeaiexamples_tpu_torch.parallel.comm import trace_collectives

    trace_collectives(True)
    try:
        mesh_training.step(ctx, key, {}, rows)
    finally:
        got = trace_collectives(False)
    return got


def norm_of_known_grads(ctx):
    from generativeaiexamples_tpu_torch.engine import mesh_training

    grads = [torch.ones(4), torch.ones(4, 2)]
    return float(mesh_training.global_norm(ctx, grads, [(None,), (None, "tensor")]))


def pipeline_hidden(ctx, cfg, tree, tensor, tokens, n_micro=None):
    """``pipeline_forward`` of this rank's data rows on its shard (under
    ``pipeline_rules``) of a numpy tree; the whole batch's hidden states."""
    from generativeaiexamples_tpu_torch.engine.mesh_training import shard_tree
    from generativeaiexamples_tpu_torch.parallel import pipeline

    params = shard_tree(tree, llama.partition_specs(cfg, pipeline.pipeline_rules(tensor)), ctx.sizes, ctx.coords,
                        ctx.device)
    tokens = _t(tokens, ctx.device)[_rows(ctx, tokens.shape[0])].long()
    pos = torch.arange(tokens.shape[1], dtype=torch.int32).expand(tokens.shape).contiguous()
    h = pipeline.pipeline_forward(params, cfg, tokens, pos, ctx, n_micro=n_micro)
    return ctx.all_gather(h.contiguous(), "data", dim=0).numpy()


def traced_pipeline_loss(ctx, key, rows):
    """The pipelined loss's forward (no graph) with this rank's collectives
    recorded."""
    from generativeaiexamples_tpu_torch.parallel.comm import trace_collectives

    from generativeaiexamples_tpu_torch.parallel.pipeline import pipeline_loss_fn

    st = ctx.state[key]
    b = {k: _t(v, ctx.device) for k, v in rows.items()}
    trace_collectives(True)
    try:
        loss = pipeline_loss_fn(st.params, st.cfg, b["tokens"], b["targets"], b["mask"], ctx)
    finally:
        got = trace_collectives(False)
    return float(loss), got


def checkpoint_stats(ctx, reset=False):
    """This rank's checkpoint byte counts (zeroed with ``reset``)."""
    from generativeaiexamples_tpu_torch.engine import weights

    got = dict(weights.CHECKPOINT_STATS)
    if reset:
        weights.CHECKPOINT_STATS.update(written_bytes=0, read_bytes=0)
    return got


def state_bytes(ctx, key):
    from generativeaiexamples_tpu_torch.engine.training import tree_leaves

    st = ctx.state[key]
    return sum(t.numel() * t.element_size() for t in tree_leaves((st.params, st.opt_state.mu, st.opt_state.nu)))


@grad_program
def seq_attention_grads(ctx, q, k, v, g, strategy):
    """dq / dk / dv of ``sum(attention(q, k, v) * g)`` with the sequence
    split over ``seq`` (this rank's chunk, global positions), through ring
    or Ulysses attention; gathered whole over ``seq``."""
    from generativeaiexamples_tpu_torch.parallel.autograd import value_and_grad

    n, i = ctx.size("seq"), ctx.index("seq")
    s = q.shape[1] // n
    own = slice(i * s, (i + 1) * s)
    leaves = [_t(x, ctx.device)[:, own].contiguous().requires_grad_(True) for x in (q, k, v)]
    g = _t(g, ctx.device)[:, own]
    pos = (torch.arange(s, dtype=torch.int32) + i * s).expand(q.shape[0], s).contiguous()

    def loss():
        ql, kl, vl = leaves
        if strategy == "ring":
            out = ra.ring_gqa_attention(ql, kl, vl, pos, pos, None, mesh=ctx, axis_size=n)
        else:
            out = ra.ulysses_gqa_attention(ql, kl, vl, pos, None, mesh=ctx, axis_size=n)
        return (out * g).sum()

    _, grads = value_and_grad(ctx, loss, leaves)
    with torch.no_grad():
        return [ctx.all_gather(d.contiguous(), "seq", dim=1).numpy() for d in grads]


def collectives_of(ctx, axis, shared=False):
    """Every collective over ``axis`` on seeded inputs (f32 and bf16), a
    transfer of several shared-memory chunks among them.  With ``shared``,
    the group's collectives run through a shared line (what ranks sharing
    a card use), for this call only."""
    from generativeaiexamples_tpu_torch.parallel.comm import SharedLine

    g = torch.Generator().manual_seed(ctx.rank)
    n = ctx.size(axis)
    x = torch.randn(6, 40, generator=g)
    group = ctx.groups[axis]
    if shared:
        group.shared = SharedLine.open(group._pg, group.index, group.size, group.device)
    big = torch.full((9 << 20,), float(ctx.rank + 1))  # 36 MB of f32: two 32 MB rounds
    try:
        return {
            "psum": ctx.psum(x, axis).numpy(),
            "psum_bf16": ctx.psum(x.bfloat16(), axis).float().numpy(),
            "all_gather": ctx.all_gather(x, axis, dim=1).numpy(),
            "all_to_all": ctx.all_to_all(torch.randn(4 * n, 8, generator=g), axis, 0, 1).numpy(),
            "reduce_scatter": ctx.reduce_scatter(torch.randn(2 * n, 10, generator=g), axis, 0).numpy(),
            "reduce_scatter_bf16": ctx.reduce_scatter(torch.randn(3, 2 * n, generator=g).bfloat16(), axis,
                                                      1).float().numpy(),
            "ppermute": ctx.ppermute(x, axis, [(i, i + 1) for i in range(n - 1)]).numpy(),
            "broadcast": group.broadcast(x.bfloat16(), n - 1).float().numpy(),
            "big_psum": ctx.psum(big, axis)[[0, -1]].numpy(),
            "big_gather": ctx.all_gather(big, axis)[[0, -1]].numpy(),
            "big_psum_bf16": ctx.psum(big[: (17 << 20) // 2].repeat(2).bfloat16(), axis)[[0, -1]].float().numpy(),
        }
    finally:
        group.shared = None


def sharded_equals_shard_params(ctx, key, tree, cfg):
    """Whether the shard ``load_checkpoint_sharded`` left under ``key``
    equals ``shard_params``' slice of the whole tree, leaf by leaf."""
    from generativeaiexamples_tpu_torch.utils.trees import flatten

    want = dict(flatten(shard_params(tree, cfg, ctx.sizes, ctx.coords, "cpu")))
    got = flatten(ctx.state.pop(key))
    return len(got) == len(want) and all(torch.equal(x, want[p]) for p, x in got)
