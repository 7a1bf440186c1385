"""Token sampling: temperature / top-k / top-p per request (port of
``engine/sampler.py``).

Filters run on the top-``CANDIDATES`` tokens of the tempered distribution,
selected with the exact ``torch.topk``; the reference's matching mode is
``GAIE_EXACT_SAMPLING=1``.  Randomness comes from an explicit
``torch.Generator``; greedy rows (temperature 0) take the argmax and use
no random numbers.  Everything stays on the device: no host sync.
"""

from __future__ import annotations

import dataclasses

import torch

_NEG_INF = -1e30

CANDIDATES = 128


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration."""

    temperature: float = 0.2
    top_p: float = 0.7
    top_k: int = 0  # 0 = disabled
    max_tokens: int = 1024
    stop_on_eos: bool = True


def _warp(logits, temperature, top_p, top_k):
    """Temperature -> candidates -> top-k/top-p.  Returns (cand_idx,
    cand_logits with filtered = -1e30, scaled full logits)."""
    vocab = logits.shape[-1]
    temp = temperature.clamp_min(1e-6)[:, None]
    scaled = logits / temp
    k_cap = min(CANDIDATES, vocab)
    sorted_scaled, cand_idx = torch.topk(scaled, k_cap, dim=-1, sorted=True)
    ranks = torch.arange(k_cap, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k.clamp(max=k_cap), torch.full_like(top_k, k_cap))[:, None]
    topk_mask = ranks < k
    sorted_probs = torch.softmax(sorted_scaled, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    topp_mask = (cumulative - sorted_probs) < top_p[:, None]
    keep = topk_mask & topp_mask
    cand_logits = torch.where(keep, sorted_scaled, torch.full_like(sorted_scaled, _NEG_INF))
    return cand_idx, cand_logits, scaled


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
) -> torch.Tensor:
    """Sample one token per row of (b, vocab) f32 logits; (b,) int32.

    temperature (b,) (0 = greedy), top_p (b,) in (0, 1], top_k (b,) int
    (0 = off, clamped to the candidate pool).  Rows with both filters off
    sample the full untruncated distribution.
    """
    greedy = torch.argmax(logits, dim=-1)
    cand_idx, cand_logits, scaled = _warp(logits, temperature, top_p, top_k)
    choice = _categorical(cand_logits, generator)
    sampled = torch.gather(cand_idx, 1, choice[:, None])[:, 0]
    unfiltered = (top_p >= 1.0) & (top_k <= 0) & (temperature > 0.0)
    sampled = torch.where(unfiltered, _categorical(scaled, generator), sampled)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
