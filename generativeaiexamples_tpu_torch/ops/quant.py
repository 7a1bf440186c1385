"""Weight-only int8 quantization for serving (port of ``ops/quant.py``).

Symmetric per-output-channel int8 weights with f32 scales, the ``q_dot``
projection dispatch, and the quantizers the serving params go through.
The arithmetic (f32 amax, ``max(amax, 1e-8) / 127``, round half to even,
clip to +-127) is the reference's, so both packages produce the same
int8 values from the same float weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class QuantizedMatrix:
    """int8 weight + per-output-channel f32 scale (symmetric)."""

    q: torch.Tensor  # int8, shape (..., d_in, d_out)
    scale: torch.Tensor  # f32, shape (..., 1, d_out)

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.ndim


def _quantize(w: torch.Tensor, dim: int) -> QuantizedMatrix:
    wf = w.float()
    amax = wf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedMatrix(q=q, scale=scale)


def quantize_matrix(w: torch.Tensor) -> QuantizedMatrix:
    """Symmetric per-output-channel int8 quantization of (..., d_in, d_out)."""
    return _quantize(w, -2)


def quantize_embedding(w: torch.Tensor) -> QuantizedMatrix:
    """Per-row (token) symmetric int8 for an embedding table (V, d):
    scale (V, 1), so gathered rows dequantize like ``llama.embed``."""
    return _quantize(w, -1)


def dequantize(qm: QuantizedMatrix, dtype=None, *, cfg=None) -> torch.Tensor:
    """Materialize the full-width weight in ``dtype`` (default: the
    config's compute dtype, else bf16)."""
    if dtype is None:
        dtype = cfg.compute_dtype if cfg is not None else torch.bfloat16
    return (qm.q.float() * qm.scale).to(dtype)


def _validate_q_dot(x: torch.Tensor, w: Any, name: Optional[str]) -> None:
    """Shape/dtype validation that names the projection."""
    who = f"projection {name!r}" if name else "q_dot"
    d_in = w.shape[-2]
    if x.ndim < 1 or x.shape[-1] != d_in:
        raise ValueError(
            f"{who}: activation feature width {x.shape[-1] if x.ndim else 0}"
            f" (shape {tuple(x.shape)}) does not match weight d_in {d_in}"
            f" (weight shape {tuple(w.shape)})"
        )
    if not x.is_floating_point():
        raise ValueError(f"{who}: activations must be floating point, got {x.dtype}")


def q_dot(x: torch.Tensor, w: Any, name: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` for a pre-blocked W8A8 projection
    (:class:`~generativeaiexamples_tpu_torch.ops.qmm.BlockedQuantizedMatrix`):
    per-token-quantized W8A8 through the CUDA kernel on the card, or its
    bit-identical plain version on the CPU (``ops.qmm.q_matmul``).

    The reference's weight-only int8 and float products are not ported:
    other weights raise (``engine.decode.prepare_params`` lays params out).
    """
    from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix, q_matmul

    _validate_q_dot(x, w, name)
    if not isinstance(w, BlockedQuantizedMatrix):
        raise TypeError(
            f"projection {name!r}: the port serves pre-blocked W8A8 weights, got {type(w).__name__}"
        )
    return q_matmul(x, w)


# Per-layer projection weights that serving quantizes to int8.
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llama_params(
    params: dict, *, include_lm_head: bool = True, include_embed: bool = False
) -> dict:
    """Quantize every float layer matmul weight (and optionally the
    head/embedding); leaves that are already int8 pass through, and norm
    gains stay in their storage dtype."""

    def quant(leaf, fn):
        return fn(leaf) if isinstance(leaf, torch.Tensor) else leaf

    layers = dict(params["layers"])
    for name in QUANT_TARGETS:
        if name in layers:
            layers[name] = quant(layers[name], quantize_matrix)
    out = {**params, "layers": layers}
    if include_lm_head:
        out["lm_head"] = quant(params["lm_head"], quantize_matrix)
    if include_embed:
        out["embed"] = quant(params["embed"], quantize_embedding)
    return out
