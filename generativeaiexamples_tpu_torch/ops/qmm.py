"""W8A8 quantized matmul (port of ``ops/qmm.py``).

* **Per-token activation quantization** (symmetric int8,
  :func:`quantize_activations`) is a plain PyTorch pass outside the
  kernel, so the kernel and its plain version consume identical operands.
  ``torch.round`` rounds half to even, as ``jnp.round`` does.
* **Blocked weights, made once at load**: :func:`block_matrix` turns a
  :class:`~generativeaiexamples_tpu_torch.ops.quant.QuantizedMatrix`
  into the kernel's Hopper layout: ``(N_pad, K_pad)`` int8, K-contiguous,
  which is the column-major B operand of the int8 ``mma.sync``, plus
  ``(N_pad,)`` f32 scales.  ``BLOCK_EVENTS`` counts blockings so tests can
  show that no decode step re-tiles.
* **Exact integer product, one scale fold**: the int32 accumulator is
  exact, and both versions fold scales with the reference's expression
  ``((float)acc * a_scale) * w_scale``, rounded once to the output type.
  The kernel (``csrc/qmm.cu``) is therefore bit-identical to
  :func:`qmm_plain` and to the reference's ``_qmm_xla``.

The wrapper launches the kernel for CUDA tensors and runs the plain
version only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops import _cuda

# K pads to this quantum (zero columns add exact zeros to the integer dot);
# N pads to the kernel's 64-column output tile (zero rows, scale 0).
K_QUANTUM = 128
N_QUANTUM = 64

# Every block_matrix call (one per projection per model load) increments
# this, and nothing on the per-step path does.
BLOCK_EVENTS = {"count": 0}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class BlockedQuantizedMatrix:
    """A QuantizedMatrix in the W8A8 kernel's layout.

    ``w``: int8 ``(..., N_pad, K_pad)``, K-contiguous (the transposed,
    zero-padded weight).  ``scale``: f32 ``(..., N_pad)`` per-output-channel
    scales (padding channels carry 0).  ``k`` / ``n``: the unpadded
    contraction / output widths.  Leading axes are stacked layers.
    """

    w: torch.Tensor
    scale: torch.Tensor
    k: int
    n: int

    @property
    def shape(self):
        return tuple(self.w.shape[:-2]) + (self.k, self.n)

    @property
    def ndim(self):
        return self.w.ndim

    def layer(self, i: int) -> "BlockedQuantizedMatrix":
        """Layer ``i`` of a stacked weight (a view, no copy)."""
        return BlockedQuantizedMatrix(self.w[i], self.scale[i], self.k, self.n)


def block_matrix(qm) -> BlockedQuantizedMatrix:
    """Re-lay a QuantizedMatrix ``(..., K, N)`` as ``(..., N_pad, K_pad)``
    int8 + ``(..., N_pad)`` scales.  Called once per projection at load."""
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix

    if isinstance(qm, BlockedQuantizedMatrix):  # idempotent
        return qm
    if not isinstance(qm, QuantizedMatrix):
        raise TypeError(f"block_matrix expects a QuantizedMatrix, got {type(qm)!r}")
    *lead, k, n = qm.q.shape
    k_pad = _round_up(k, K_QUANTUM)
    n_pad = _round_up(n, N_QUANTUM)
    w = F.pad(qm.q.transpose(-1, -2), (0, k_pad - k, 0, n_pad - n)).contiguous()
    scale = F.pad(qm.scale.float()[..., 0, :], (0, n_pad - n)).contiguous()
    BLOCK_EVENTS["count"] += 1
    return BlockedQuantizedMatrix(w=w, scale=scale, k=int(k), n=int(n))


def quantize_activations(x: torch.Tensor):
    """Per-token (row) symmetric int8 quantization of ``(M, K)``:
    returns int8 values and f32 ``(M, 1)`` scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    a_scale = amax.clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    return xq, a_scale


def _fold(acc, a_scale, w_scale, out_dtype):
    """The one scale-folding expression both versions share."""
    return ((acc.float() * a_scale) * w_scale).to(out_dtype)


def qmm_plain(xq, a_scale, w, w_scale, n: int, out_dtype):
    """Plain version of the kernel over the same operands.

    The integer product runs in float64, which holds every partial sum of
    int8 x int8 products exactly at these widths (|acc| < 2^31 << 2^53),
    so ``acc.float()`` is the correctly rounded int32 -> f32 conversion
    the kernel makes with ``__int2float_rn``.
    """
    acc = torch.matmul(xq.double(), w.double().transpose(-1, -2))
    return _fold(acc[:, :n], a_scale, w_scale[:n], out_dtype)


_QMM_ARGS = [_cuda.c_ptr] * 5 + [_cuda.c_int] * 5 + [_cuda.c_ptr]


def qmm_cuda(xq, a_scale, w, w_scale, n: int, out_dtype):
    """Launch the W8A8 kernel (``csrc/qmm.cu``) on CUDA tensors."""
    m, k_pad = xq.shape
    n_pad = w.shape[0]
    for name, t in (("xq", xq), ("a_scale", a_scale), ("w", w), ("w_scale", w_scale)):
        _cuda.require(t.is_cuda and t.is_contiguous(), f"qmm: {name} must be a contiguous CUDA tensor")
    _cuda.require(xq.dtype == torch.int8 and w.dtype == torch.int8, "qmm: xq and w must be int8")
    _cuda.require(
        a_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        "qmm: scales must be float32",
    )
    _cuda.require(w.shape[1] == k_pad and k_pad % 64 == 0, f"qmm: K mismatch {tuple(xq.shape)} vs {tuple(w.shape)}")
    _cuda.require(n_pad % 64 == 0 and 0 < n <= n_pad, f"qmm: bad N {n} / {n_pad}")
    _cuda.require(tuple(a_scale.shape) == (m, 1) and tuple(w_scale.shape) == (n_pad,), "qmm: scale shapes")
    _cuda.require(out_dtype in (torch.bfloat16, torch.float32), f"qmm: output dtype {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    fn = _cuda.function("qmm", "qmm_launch", _QMM_ARGS)
    err = fn(
        xq.data_ptr(), a_scale.data_ptr(), w.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, n_pad, k_pad, n, int(out_dtype == torch.bfloat16), _cuda.stream_ptr(xq),
    )
    _cuda.check("qmm", err)
    _cuda.LAUNCHES["qmm"] += 1
    return out


def q_matmul(x: torch.Tensor, w: BlockedQuantizedMatrix) -> torch.Tensor:
    """``x @ w`` in W8A8 for ``(..., K)`` activations: quantize per token,
    exact int8 product, fold scales into the output (x's dtype)."""
    k_pad = w.w.shape[-1]
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    xq, a_scale = quantize_activations(x2)
    if k_pad != k:
        xq = F.pad(xq, (0, k_pad - k))
    if _cuda.on_cuda(x):
        out = qmm_cuda(xq.contiguous(), a_scale, w.w, w.scale, w.n, x.dtype)
    else:
        out = qmm_plain(xq, a_scale, w.w, w.scale, w.n, x.dtype)
    return out.reshape(*lead, w.n)
