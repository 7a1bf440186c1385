"""Rotary position embeddings, half-split / rotate-half convention
(port of ``ops/rope.py``)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for each rotary pair: (head_dim // 2,) f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (batch, seq, heads, head_dim) vectors by their absolute
    (batch, seq) positions: trig in f32, rotation in x's dtype."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions.float()[..., None] * inv_freq  # (b, s, hd/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
