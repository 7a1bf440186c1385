"""Programs the mesh tests run on every rank (``Mesh.run``).

They live outside the test modules so that a follower rank unpickling one
imports this module only: the port and numpy, never JAX.
"""

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.weights import shard_params
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import ring_attention as ra


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
