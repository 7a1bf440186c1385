"""Grouped-query attention with explicit validity masking (port of
``ops/attention.py``).

Masking convention: key slot ``t`` is visible to the query at absolute
position ``p`` iff ``t <= p`` and ``t < kv_length[b]``.  Fully masked rows
come out exactly zero (the mask multiplies the exp-weights).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query attention over an identity-positioned key/value buffer.

    q (b, s, n_q, hd); k, v (b, t, n_kv, hd) (int8 with ``k_scale`` /
    ``v_scale`` (b, t, n_kv) for the int8 KV cache); q_positions (b, s);
    kv_lengths (b,) or None.  Products accumulate in f32; the softmax
    weights round to q's dtype before the PV product, as in the reference.
    Returns (b, s, n_q, hd) in q's dtype.
    """
    b, s, n_q, head_dim = q.shape
    t = k.shape[1]
    n_kv = k.shape[2]
    group = n_q // n_kv
    scale = head_dim**-0.5

    qg = q.reshape(b, s, n_kv, group, head_dim).float()
    scores = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1).float()[:, :, None, None, :]

    t_idx = torch.arange(t, dtype=torch.int32, device=q.device)
    causal = t_idx[None, None, :] <= q_positions[..., None]  # (b, s, t)
    if kv_lengths is not None:
        causal = causal & (t_idx[None, :] < kv_lengths[:, None])[:, None, :]
    mask = causal[:, None, None, :, :]  # (b, 1, 1, s, t)

    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    denom = weights.sum(dim=-1, keepdim=True)
    weights = weights / denom.clamp_min(1e-30)
    if v_scale is not None:
        weights = weights * v_scale.permute(0, 2, 1).float()[:, :, None, None, :]
    out = torch.einsum("bngst,btnh->bsngh", weights.to(q.dtype).float(), v.to(q.dtype).float())
    return out.reshape(b, s, n_q, head_dim).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    mesh=None,
    seq_sharded: bool = False,
) -> torch.Tensor:
    """Dispatch with the gqa_attention contract.

    Over a mesh (``mesh`` a ``parallel.runtime.RankContext``) with a
    populated ``seq`` axis, unscaled self-attention (q-len == kv-len > 1,
    dividing the axis) runs as ring attention across it
    (``parallel.ring_attention``), as in the reference.  With
    ``seq_sharded`` (training) q/k/v are already this rank's chunks of the
    sequence, at the global ``q_positions``, and the ring runs on them.

    int8-scaled attention (warm multi-token chunks over the quantized
    cache) and single-query calls (s == 1) stay plain PyTorch, as they are
    XLA code in the reference.  Every unscaled multi-token block (cold
    prefill over fresh k/v, and warm chunks over a float cache's window,
    ``t > s`` at offset positions) goes to the flash kernel on the card
    and to its plain version on the CPU.
    """
    if k_scale is not None or v_scale is not None or q.shape[1] == 1:
        return gqa_attention(q, k, v, q_positions, kv_lengths, k_scale=k_scale, v_scale=v_scale)
    if mesh is not None:
        from generativeaiexamples_tpu_torch.parallel.ring_attention import (
            ring_gqa_attention,
            seq_parallel_ok,
            sequence_parallel_attention,
        )

        if seq_sharded and mesh.size("seq") > 1:
            return ring_gqa_attention(q, k, v, q_positions, q_positions, kv_lengths, mesh=mesh,
                                      axis_size=mesh.size("seq"))
        if seq_parallel_ok(mesh, q, k):
            return sequence_parallel_attention(q, k, v, q_positions, kv_lengths, mesh=mesh, strategy="ring")
    from generativeaiexamples_tpu_torch.ops.flash_attention import flash_gqa_attention

    return flash_gqa_attention(q, k, v, q_positions, kv_lengths)
