"""W8A8 quantized matmul (port of ``ops/qmm.py``).

* **Per-token activation quantization** (symmetric int8,
  :func:`quantize_activations`) is a plain PyTorch pass outside the
  kernel, so the kernel and its plain version consume identical operands.
  ``torch.round`` rounds half to even, as ``jnp.round`` does.
* **Blocked weights, made once at load**: :func:`block_matrix` turns a
  :class:`~generativeaiexamples_tpu_torch.ops.quant.QuantizedMatrix`
  into the kernel's Hopper layout: ``(N_pad, K_pad)`` int8, K-contiguous
  (the K-major operand the int8 ``wgmma`` takes, in 128-byte K rows that
  match the TMA's 128-byte swizzle), plus ``(N_pad,)`` f32 scales.
  ``BLOCK_EVENTS`` counts blockings so tests can show that no decode step
  re-tiles.
* **Exact integer product, one scale fold**: the int32 accumulator is
  exact, and both versions fold scales with the reference's expression
  ``((float)acc * a_scale) * w_scale``, rounded once to the output type.
  The kernel (``csrc/qmm.cu``) is therefore bit-identical to
  :func:`qmm_plain` and to the reference's ``_qmm_xla``.

* **Two designs, one launch** (:func:`qmm_plan`): at ``M <= 64`` the
  decode design streams the weight with a split-K cluster of blocks, above
  it the wide design tiles the output 128 x 256, 128 x 128 or 64 x 128;
  ``DESIGN_LAUNCHES`` counts each.

The wrapper launches the kernel for CUDA tensors and runs the plain
version only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops._cuda import SMS

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


# Geometry shared with csrc/qmm.cu.
BK = 128  # K bytes per pipeline step
TILE_N = 128  # output channels per block
DECODE_MAX_M = 64  # the decode design runs at M <= this
MAX_CLUSTER = 8  # portable thread-block cluster size
DECODE_STAGES = 4
# Wide design: the largest of 128 x 256, 128 x 128 and 64 x 128 output
# tiles whose grid fills at least WIDE_MIN_WAVE of a wave of blocks (else
# 64 x 128), and the ring depth of each shape; both chosen from timings of
# the four Llama-3-8B projections at M = 65-2048 on an H100 (PERF.md).
WIDE_TILES = ((128, 256), (128, 128), (64, 128))
WIDE_STAGES = {(128, 256): 4, (128, 128): 6, (64, 128): 4}
WIDE_MIN_WAVE = 0.7

# Launches per design: the decode and wide kernels of csrc/qmm.cu.
DESIGN_LAUNCHES = _cuda.QMM_DESIGN_LAUNCHES


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How one ``(m, n_pad, k_pad)`` product is launched.

    ``grid`` is (x, y) in blocks, y over the ``tile_n``-channel tiles.
    Decode: x is the split-K cluster, ``split`` <= 8 blocks along K, and
    ``tile_m`` (8/16/32/64) the token width of its wgmma.  Wide: x walks
    the ``tile_m``-token tiles, ``split`` is 1.  ``splits`` lists each
    split's K byte range, ``stages`` the TMA ring's depth and
    ``smem_bytes`` each block's dynamic shared memory."""

    design: str
    grid: tuple
    split: int
    stages: int
    tile_m: int
    tile_n: int
    splits: tuple
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _k_splits(k_steps: int, split: int) -> tuple:
    """Split r's K byte range: whole BK steps, the first ``k_steps % split``
    splits one step longer (the kernel's own arithmetic)."""
    base, rem = divmod(k_steps, split)
    out = []
    for r in range(split):
        kb = r * base + min(r, rem)
        out.append((kb * BK, (kb + base + (r < rem)) * BK))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def qmm_plan(m: int, n_pad: int, k_pad: int) -> QmmPlan:
    """The launch of ``csrc/qmm.cu`` for ``(m, k_pad) x (n_pad, k_pad)``.

    Decode (m <= 64): the fewest splits that give every SM a block
    (``n_tiles * split >= SMS``), with at least one K step each and at
    most 8 (one cluster).  Wide: one output tile per block, the largest of
    WIDE_TILES whose grid is at least WIDE_MIN_WAVE of a wave."""
    if k_pad % BK or n_pad % N_QUANTUM or m <= 0:
        raise ValueError(f"qmm_plan: bad shape m={m} n_pad={n_pad} k_pad={k_pad}")
    k_steps = k_pad // BK
    n_tiles = -(-n_pad // TILE_N)
    if m <= DECODE_MAX_M:
        split = max(1, min(-(-SMS // n_tiles), MAX_CLUSTER, k_steps))
        width = next(w for w in (8, 16, 32, 64) if m <= w)
        stage = TILE_N * BK + width * BK
        smem = max(DECODE_STAGES * stage, width * (TILE_N + 4) * 4) + 2 * 8 * DECODE_STAGES + 1024
        return QmmPlan("decode", (split, n_tiles), split, DECODE_STAGES, width, TILE_N,
                       _k_splits(k_steps, split), smem)
    for tile_m, tile_n in WIDE_TILES:
        grid = (-(-m // tile_m), -(-n_pad // tile_n))
        if grid[0] * grid[1] >= WIDE_MIN_WAVE * SMS:
            break
    stages = WIDE_STAGES[tile_m, tile_n]
    smem = stages * (tile_m + tile_n) * BK + 2 * 8 * stages + 1024
    return QmmPlan("wide", grid, 1, stages, tile_m, tile_n, _k_splits(k_steps, 1), smem)


def qmm_plain(xq, a_scale, w, w_scale, n: int, out_dtype):
    """Plain version of the kernel over the same operands.

    The integer product runs in float64, which holds every partial sum of
    int8 x int8 products exactly at these widths (|acc| < 2^31 << 2^53),
    so ``acc.float()`` is the correctly rounded int32 -> f32 conversion
    the kernel makes with ``__int2float_rn``.
    """
    acc = torch.matmul(xq.double(), w.double().transpose(-1, -2))
    return _fold(acc[:, :n], a_scale, w_scale[:n], out_dtype)


_QMM_ARGS = [_cuda.c_ptr] * 5 + [_cuda.c_int] * 9 + [_cuda.c_ptr]


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
    _cuda.require(w.shape[1] == k_pad and k_pad % BK == 0, f"qmm: K mismatch {tuple(xq.shape)} vs {tuple(w.shape)}")
    _cuda.require(n_pad % 64 == 0 and 0 < n <= n_pad, f"qmm: bad N {n} / {n_pad}")
    _cuda.require(tuple(a_scale.shape) == (m, 1) and tuple(w_scale.shape) == (n_pad,), "qmm: scale shapes")
    _cuda.require(out_dtype in (torch.bfloat16, torch.float32), f"qmm: output dtype {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0:
        return out
    plan = qmm_plan(m, n_pad, k_pad)
    fn = _cuda.function("qmm", "qmm_launch", _QMM_ARGS)
    err = fn(
        xq.data_ptr(), a_scale.data_ptr(), w.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, n_pad, k_pad, n, int(out_dtype == torch.bfloat16), plan.split, plan.stages, plan.tile_m, plan.tile_n,
        _cuda.stream_ptr(xq),
    )
    _cuda.check("qmm", err)
    _cuda.LAUNCHES["qmm"] += 1
    DESIGN_LAUNCHES[plan.design] += 1
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
