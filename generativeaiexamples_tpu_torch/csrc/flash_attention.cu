// Causal GQA prefill flash attention (bf16 in, bf16 out, f32 softmax).
//
// Replaces ops/flash_attention.py::flash_gqa_attention (kernel _flash_kernel)
// of the JAX package.
//
// Inputs: q (b, s, n_q, 128) bf16, k/v (b, t, n_kv, 128) bf16, q_positions
// (b, s) int32, kv_len (b,) int32.  Key slot j is visible to the query at
// position p iff j <= p and j < kv_len[b].  The mask is multiplicative on
// the exp-weights, so padded query rows (position -1) and rows with no
// visible key come out exactly 0, as in the reference (stock SDPA does not
// carry that contract).  GQA maps query head h to kv head h // (n_q/n_kv)
// without materialising the broadcast.
//
// Bound on this card: at the prefill shapes of the serving path (s = 256,
// head_dim 128) device-memory bandwidth bounds it: moving q, k, v and the
// output takes longer than the bf16 products at the tensor-core rate.  The
// tensor-core rate bounds it only at much longer prompts, where the work
// grows with s^2 and the bytes with s.  Design: the kv loop stops at
// min(max query position + 1, kv_len), so no block reads K/V slots that no
// query of its tile can see, and tiles wholly in the future are skipped.
// One block per (64-row query tile, query head, batch row), four warps of
// 16 query rows; Q stays in registers as mma fragments, K/V tiles of 64
// slots stream through shared memory, S = QK^T and O += PV run on bf16
// mma.sync m16n8k16 with f32 accumulation, and the score fragments are
// reused in registers as the PV operand.  The query heads of a GQA group
// and the query tiles of a row each read the row's K/V (the repeats mostly
// hit L2).  No cp.async/TMA, no wgmma, no warp specialisation: this is the
// simple first kernel.
#include "common.cuh"

namespace {

constexpr int HD = 128;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
// Shared-memory row stride in bf16 elements (272 bytes): 16-byte aligned,
// and fragment reads of 8 consecutive rows fall on distinct banks.
constexpr int LDK = HD + 8;

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
    flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out, int S,
                 int T, int n_q, int n_kv, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LDK];
  __shared__ int pos_s[BQ];
  __shared__ int maxpos_s;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (n_q / n_kv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int r = tid; r < BQ; r += THREADS) {
    const int i = qt * BQ + r;
    pos_s[r] = i < S ? qpos[(size_t)b * S + i] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int r = 0; r < BQ; ++r) mx = max(mx, pos_s[r]);
    maxpos_s = mx;
  }
  __syncthreads();
  const int len = min(kv_len[b], T);
  const int limit = min(maxpos_s + 1, len);

  // This warp's 16 query rows as A fragments over head_dim (8 k16 steps).
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int i0 = qt * BQ + r0, i1 = qt * BQ + r1;
  const int p0 = pos_s[r0], p1 = pos_s[r1];
  uint32_t qf[HD / 16][4];
  {
    const __nv_bfloat16* q0 = q + (((size_t)b * S + i0) * n_q + h) * HD;
    const __nv_bfloat16* q1 = q + (((size_t)b * S + i1) * n_q + h) * HD;
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      const int c = kd * 16 + t * 2;
      qf[kd][0] = i0 < S ? load_pair(q0 + c) : 0u;
      qf[kd][1] = i1 < S ? load_pair(q1 + c) : 0u;
      qf[kd][2] = i0 < S ? load_pair(q0 + c + 8) : 0u;
      qf[kd][3] = i1 < S ? load_pair(q1 + c + 8) : 0u;
    }
  }

  float m0 = GAIE_NEG_INF, m1 = GAIE_NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  for (int kv0 = 0; kv0 < limit; kv0 += BKV) {
    __syncthreads();
    for (int c = tid; c < BKV * (HD / 8); c += THREADS) {
      const int r = c / (HD / 8), cc = c % (HD / 8);
      int4 kvv = make_int4(0, 0, 0, 0), vvv = make_int4(0, 0, 0, 0);
      if (kv0 + r < T) {
        const size_t off = (((size_t)b * T + kv0 + r) * n_kv + kvh) * HD + cc * 8;
        kvv = *reinterpret_cast<const int4*>(k + off);
        vvv = *reinterpret_cast<const int4*>(v + off);
      }
      *reinterpret_cast<int4*>(Ks + r * LDK + cc * 8) = kvv;
      *reinterpret_cast<int4*>(Vs + r * LDK + cc * 8) = vvv;
    }
    __syncthreads();

    float sc[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LDK + t * 2;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        mma_bf16_16x8x16(sc[nt], qf[kd], load_pair(kr + kd * 16), load_pair(kr + kd * 16 + 8));
    }

    float mx0 = GAIE_NEG_INF, mx1 = GAIE_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + t * 2 + (e & 1);
        const int p = e < 2 ? p0 : p1;
        const bool vis = col <= p && col < len;
        const float s = vis ? sc[nt][e] * scale : GAIE_NEG_INF;
        sc[nt][e] = s;
        if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Masked slots hold exactly -1e30: weight 0 (the multiplicative mask).
        const float s = sc[nt][e];
        const float p = s == GAIE_NEG_INF ? 0.f : expf(s - (e < 2 ? mn0 : mn1));
        sc[nt][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= alpha0; o[d][1] *= alpha0;
      o[d][2] *= alpha1; o[d][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + t * 2) * LDK + g;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const __nv_bfloat16* vp = v0 + d * 8;
        const uint32_t b0 = pack_bf16x2(vp[0], vp[LDK]);
        const uint32_t b1 = pack_bf16x2(vp[8 * LDK], vp[9 * LDK]);
        mma_bf16_16x8x16(o[d], a, b0, b1);
      }
    }
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (i0 < S) {
      __nv_bfloat16* op = out + (((size_t)b * S + i0) * n_q + h) * HD + col;
      *reinterpret_cast<__nv_bfloat162*>(op) =
          __floats2bfloat162_rn(o[d][0] / den0, o[d][1] / den0);
    }
    if (i1 < S) {
      __nv_bfloat16* op = out + (((size_t)b * S + i1) * n_q + h) * HD + col;
      *reinterpret_cast<__nv_bfloat162*>(op) =
          __floats2bfloat162_rn(o[d][2] / den1, o[d][3] / den1);
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* qpos, const void* kv_len, void* out, int B,
                                      int S, int T, int n_q, int n_kv, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const dim3 grid((S + BQ - 1) / BQ, n_q, B);
  flash_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(out), S, T, n_q, n_kv,
      scale);
  return static_cast<int>(cudaGetLastError());
}
