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
) -> torch.Tensor:
    """Dispatch with the gqa_attention contract.

    int8-scaled attention (warm multi-token chunks over the quantized
    cache) stays plain PyTorch, as it is XLA code in the reference.  Every
    unscaled call (cold prefill over fresh bf16 k/v) goes to the flash
    kernel on the card and to its plain version on the CPU.
    """
    if k_scale is not None or v_scale is not None:
        return gqa_attention(q, k, v, q_positions, kv_lengths, k_scale=k_scale, v_scale=v_scale)
    from generativeaiexamples_tpu_torch.ops.flash_attention import flash_gqa_attention

    return flash_gqa_attention(q, k, v, q_positions, kv_lengths)
