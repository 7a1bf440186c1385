// W8A8 matmul: out = fold(xq @ w^T) for int8 activations and weights.
//
// Replaces ops/qmm.py::_qmm_pallas (kernel _qmm_kernel) of the JAX package.
//
// Inputs: xq (M, K_pad) int8 row-major, a_scale (M,) f32 per-token scales,
// w (N_pad, K_pad) int8 K-contiguous (the port's Hopper layout, made once at
// load by ops/qmm.py::block_matrix), w_scale (N_pad,) f32 per-channel scales.
// Output (M, n_out) bf16 or f32.
//
// Bound on this card: at decode (M <= a few dozen) the kernel streams the
// int8 weight once and does little arithmetic per byte, so device-memory
// bandwidth bounds it; at prefill M (hundreds to thousands) the int8
// tensor-core rate does.  Design: one 64x64 output tile per block, four
// warps each owning 32x32, int8 mma.sync m16n8k32 (s8 x s8 -> s32; the
// int32 accumulator is exact), K streamed through shared memory in 64-byte
// steps with 16-byte loads.  The weight is read once per M tile, so at
// decode it is read once in all.  No cp.async/TMA pipelining and no wgmma:
// this is the simple first kernel; faster ones are later work.
//
// The epilogue is the reference's _fold expression,
// ((float)acc * a_scale) * w_scale rounded once to the output type, written
// with __int2float_rn and two __fmul_rn in that order, so the result is
// bit-identical to the plain PyTorch version.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
// Shared-memory row stride in bytes: 16-byte aligned rows whose 4-byte words
// fall on distinct banks for the fragment reads below.
constexpr int LDS = BK + 16;

template <bool BF16_OUT>
__global__ void __launch_bounds__(THREADS)
    qmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ a_scale,
               const int8_t* __restrict__ w, const float* __restrict__ w_scale,
               void* __restrict__ out, int M, int n_out, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 64 rows x 64 bytes per operand = 256 chunks of 16 bytes.
    for (int c = tid; c < BM * BK / 16; c += THREADS) {
      const int r = c >> 2, col = (c & 3) * 16;
      int4 va = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        va = *reinterpret_cast<const int4*>(xq + (size_t)(m0 + r) * K + k0 + col);
      *reinterpret_cast<int4*>(As + r * LDS + col) = va;
      // w has N_pad rows, a multiple of BN: every row of the tile exists.
      const int4 vb = *reinterpret_cast<const int4*>(w + (size_t)(n0 + r) * K + k0 + col);
      *reinterpret_cast<int4*>(Bs + r * LDS + col) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = As + (wm + i * 16 + g) * LDS + kk + t * 4;
        const int8_t* r1 = r0 + 8 * LDS;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bp = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8_16x8x32(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (row < M && col < n_out) {
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), a_scale[row]),
                                    w_scale[col]);
          if (BF16_OUT)
            reinterpret_cast<__nv_bfloat16*>(out)[(size_t)row * n_out + col] = __float2bfloat16_rn(v);
          else
            reinterpret_cast<float*>(out)[(size_t)row * n_out + col] = v;
        }
      }
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int qmm_launch(const void* xq, const void* a_scale, const void* w,
                          const void* w_scale, void* out, int M, int n_pad, int k_pad,
                          int n_out, int out_bf16, void* stream) {
  if (M <= 0) return 0;
  const dim3 grid(n_pad / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  if (out_bf16)
    qmm_kernel<true><<<grid, THREADS, 0, s>>>(x8, as, w8, ws, out, M, n_out, k_pad);
  else
    qmm_kernel<false><<<grid, THREADS, 0, s>>>(x8, as, w8, ws, out, M, n_out, k_pad);
  return static_cast<int>(cudaGetLastError());
}
