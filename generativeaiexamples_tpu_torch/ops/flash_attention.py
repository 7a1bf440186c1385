"""Causal GQA prefill flash attention (port of ``ops/flash_attention.py``).

Semantics are :func:`ops.attention.gqa_attention`'s without scales: key
slot ``t`` is visible to the query at position ``p`` iff ``t <= p`` and
``t < kv_length[b]``; rows with no visible key, and padded rows
(position -1), produce exact zeros.  On a CUDA tensor the hand-written
kernel ``csrc/flash_attention.cu`` runs (with a gradient by
recomputation through :class:`FlashAttentionFunction` when training); on
a CPU tensor the plain version, :func:`flash_gqa_attention_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops.attention import gqa_attention


def flash_gqa_attention_plain(q, k, v, q_positions, kv_lengths=None):
    """The kernel's plain version: ``gqa_attention`` without scales."""
    return gqa_attention(q, k, v, q_positions, kv_lengths)


_FLASH_ARGS = [_cuda.c_ptr] * 6 + [_cuda.c_int] * 6 + [_cuda.c_float, _cuda.c_ptr]
# The head_dims the kernel is instantiated for (Llama-3-8B / 70B, Mixtral,
# StarCoder2: 128; Llama-3.2-1B, the speculative draft: 64; Gemma: 256).
HEAD_DIMS = (64, 128, 256)


def flash_attention_cuda(q, k, v, q_positions, kv_lengths):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors."""
    b, s, n_q, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _cuda.require(
            x.is_cuda and x.is_contiguous() and x.dtype == torch.bfloat16,
            f"flash_attention: {name} must be a contiguous bf16 CUDA tensor",
        )
        # The kernel copies 16-byte vectors.
        _cuda.require(x.data_ptr() % 16 == 0, f"flash_attention: {name} must be 16-byte aligned")
    _cuda.require(hd in HEAD_DIMS, f"flash_attention: head_dim must be one of {HEAD_DIMS}, got {hd}")
    _cuda.require(tuple(v.shape) == tuple(k.shape) and k.shape[0] == b and k.shape[3] == hd,
                  "flash_attention: k/v shapes")
    _cuda.require(n_q % n_kv == 0, "flash_attention: n_q must be a multiple of n_kv")
    q_positions = q_positions.to(torch.int32).contiguous()
    kv_lengths = kv_lengths.to(torch.int32).contiguous()
    _cuda.require(tuple(q_positions.shape) == (b, s) and tuple(kv_lengths.shape) == (b,),
                  "flash_attention: positions/lengths shapes")
    out = torch.empty_like(q)
    fn = _cuda.function("flash_attention", "flash_attention_launch", _FLASH_ARGS)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), kv_lengths.data_ptr(),
        out.data_ptr(), b, s, t, n_q, n_kv, hd, hd**-0.5, _cuda.stream_ptr(q),
    )
    _cuda.check("flash_attention", err)
    _cuda.LAUNCHES["flash_attention"] += 1
    _cuda.FLASH_HD_LAUNCHES[hd] += 1
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """K4 with a gradient (training).  The forward launches the kernel as
    serving does.  The reference has no backward kernel (XLA
    differentiates its attention), so the backward recomputes the
    attention with the plain version and returns its autograd gradient:
    the gradient of the same function, from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_lengths):
        ctx.save_for_backward(q, k, v, q_positions, kv_lengths)
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), q_positions, kv_lengths)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_positions, kv_lengths = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(need) for t, need in zip((q, k, v), wanted)]
        with torch.enable_grad():
            out = flash_gqa_attention_plain(*inputs, q_positions, kv_lengths)
            grads = torch.autograd.grad(out, [t for t, need in zip(inputs, wanted) if need], g)
        it = iter(grads)
        return (*(next(it) if need else None for need in wanted), None, None)


def flash_gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q (b, s, n_q, hd), k/v (b, t, n_kv, hd), q_positions (b, s),
    kv_lengths (b,) or None (all t slots valid) -> (b, s, n_q, hd).

    On the card a call that needs a gradient (grad mode on and an input
    that requires grad) goes through :class:`FlashAttentionFunction`;
    under ``inference_mode`` / ``no_grad`` the kernel launches directly."""
    if kv_lengths is None:
        kv_lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
    if _cuda.on_cuda(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttentionFunction.apply(q, k, v, q_positions, kv_lengths)
        # Packed-qkv slices arrive strided; the kernel reads dense rows.  On
        # the cold-prefill path q and k come fresh from rope (no copy) and
        # v is a slice of the packed projection (one copy).
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), q_positions, kv_lengths)
    return flash_gqa_attention_plain(q, k, v, q_positions, kv_lengths)
