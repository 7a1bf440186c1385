"""Weight-only int8 quantization for serving (port of ``ops/quant.py``).

Symmetric per-output-channel int8 weights with f32 scales, the ``q_dot``
projection dispatch, and the quantizers the serving params go through.
The arithmetic (f32 amax, ``max(amax, 1e-8) / 127``, round half to even,
clip to +-127) is the reference's, so both packages produce the same
int8 values from the same float weights, on the CPU and on the card: the
scale divides by a tensor of 127s (:func:`int8_max_like`), since CUDA
turns a division by a Python scalar into a product by its reciprocal.
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


def int8_max_like(amax: torch.Tensor) -> torch.Tensor:
    """127 in ``amax``'s shape, dtype and device: the divisor of every
    symmetric int8 scale, so the division is IEEE on every device."""
    return torch.full_like(amax, 127.0)


def _quantize(w: torch.Tensor, dim: int) -> QuantizedMatrix:
    if w.ndim > 2 and dim < 0:
        # Stacked layers one at a time, so the f32 temporaries stay one
        # layer's (a loaded Llama-3-8B's w_gu would need 15 GB at once).
        first = _quantize(w[0], dim)
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((w.shape[0], *first.scale.shape), dtype=first.scale.dtype, device=w.device)
        for i in range(w.shape[0]):
            part = first if i == 0 else _quantize(w[i], dim)
            q[i], scale[i] = part.q, part.scale
        return QuantizedMatrix(q=q, scale=scale)
    wf = w.float()
    amax = wf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / int8_max_like(amax)
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
    if isinstance(w, QuantizedMatrix):
        if w.q.dtype != torch.int8:
            raise ValueError(f"{who}: QuantizedMatrix values must be int8, got {w.q.dtype}")
        if w.scale.ndim < 2 or w.scale.shape[-1] != w.q.shape[-1] or w.scale.shape[-2] != 1:
            raise ValueError(
                f"{who}: scale shape {tuple(w.scale.shape)} does not broadcast against int8 weight "
                f"{tuple(w.q.shape)} (expected (..., 1, d_out))"
            )


# Rows of every (K, N) bf16 product on the card: the rows run in blocks of
# exactly this many (the last padded with zero rows), so cuBLAS sees one
# shape whatever the batch and a row's sums do not depend on how many rows
# share the call (a prompt alone and in a batch, a chunk and a cold
# prefill, give the same bits).  128 keeps a decode step (32 rows) bound
# by the weights' bytes on an H100.
FLOAT_BLOCK_ROWS = 128


def _bf16_f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 on the card with an f32 output, a (K, N) weight on
    fixed blocks of :data:`FLOAT_BLOCK_ROWS` rows."""
    if w.ndim == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    pad = (-n) % FLOAT_BLOCK_ROWS
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    out = torch.cat([torch.mm(blk, w, out_dtype=torch.float32) for blk in rows.split(FLOAT_BLOCK_ROWS)])
    return out[:n].reshape(*x.shape[:-1], w.shape[-1])


class _BF16F32Product(torch.autograd.Function):
    """:func:`_bf16_f32_product` with a gradient (``torch.mm(out_dtype=)``
    has none).  The backward is the reference's transposed products: the
    f32 cotangent rounds to bf16, each product accumulates in f32, and
    each gradient rounds once to its operand's dtype (bf16), as XLA's
    transpose of a ``preferred_element_type=f32`` dot gives bf16 operands
    bf16 gradients."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _bf16_f32_product(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if w.ndim == 3:  # x (E, M, K) @ w (E, K, N)
            if ctx.needs_input_grad[0]:
                gx = torch.bmm(g, w.transpose(1, 2), out_dtype=torch.float32).to(x.dtype)
            if ctx.needs_input_grad[1]:
                gw = torch.bmm(x.transpose(1, 2), g, out_dtype=torch.float32).to(w.dtype)
            return gx, gw
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g2, w.t(), out_dtype=torch.float32).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.reshape(-1, x.shape[-1]).t(), g2, out_dtype=torch.float32).to(w.dtype)
        return gx, gw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32 for float operands of one dtype: ``w`` is (K, N),
    or (E, K, N) against x (E, M, K).  bf16 on the card multiplies with
    an f32 output (no bf16 partial sums), a (K, N) weight on blocks of
    :data:`FLOAT_BLOCK_ROWS` rows, through :class:`_BF16F32Product` when
    a gradient is wanted (training); elsewhere both operands go to f32,
    where bf16 products are exact."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _BF16F32Product.apply(x, w)
        return _bf16_f32_product(x, w)
    return torch.matmul(x.float(), w.float())


def float_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for float operands with f32 accumulation and one rounding
    to x's dtype (the reference's ``preferred_element_type=f32`` then
    ``astype``)."""
    return f32_product(x, w).to(x.dtype)


def weight_only_dot(x: torch.Tensor, w: QuantizedMatrix) -> torch.Tensor:
    """The reference's weight-only int8 product (the ``xla`` path): the
    int8 values convert to x's dtype for this call (exact), the product
    runs with f32 accumulation, the per-column scale multiplies the f32
    output, and the result rounds once to x's dtype."""
    return (f32_product(x, w.q.to(x.dtype)) * w.scale[..., 0, :]).to(x.dtype)


def q_dot(x: torch.Tensor, w: Any, name: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` by the weight's layout:

    * a pre-blocked W8A8 projection
      (:class:`~generativeaiexamples_tpu_torch.ops.qmm.BlockedQuantizedMatrix`):
      per-token-quantized W8A8 through the CUDA kernel on the card, or its
      bit-identical plain version on the CPU (``ops.qmm.q_matmul``);
    * a weight-only int8 :class:`QuantizedMatrix` (the ``xla`` path):
      :func:`weight_only_dot`;
    * a float array (the MoE router, float trees): :func:`float_dot`, f32
      accumulation cast to x's dtype.
    """
    from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix, q_matmul

    _validate_q_dot(x, w, name)
    if isinstance(w, BlockedQuantizedMatrix):
        return q_matmul(x, w)
    if isinstance(w, QuantizedMatrix):
        return weight_only_dot(x, w)
    if isinstance(w, torch.Tensor) and w.is_floating_point():
        return float_dot(x, w)
    raise TypeError(
        f"projection {name!r}: the port serves pre-blocked W8A8, weight-only int8 or float weights, "
        f"got {type(w).__name__}"
    )


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
        if name in layers:  # MoE trees lack the dense MLP leaves; experts and the router stay float
            layers[name] = quant(layers[name], quantize_matrix)
    out = {**params, "layers": layers}
    if include_lm_head:
        out["lm_head"] = quant(params["lm_head"], quantize_matrix)
    if include_embed:
        out["embed"] = quant(params["embed"], quantize_embedding)
    return out
