// The mma.sync design of kernel K4 (causal GQA prefill flash attention),
// replaced in the port by the wgmma design of
// generativeaiexamples_tpu_torch/csrc/flash_attention.cu.  Kept only as the
// point of comparison of perf_torch/probe_flash_designs.py; nothing in the
// port builds or launches it.
//
// Inputs: q (b, s, n_q, 128) bf16, k/v (b, t, n_kv, 128) bf16, q_positions
// (b, s) int32, kv_len (b,) int32.  Key slot j is visible to the query at
// position p iff j <= p and j < kv_len[b].  The mask is multiplicative on
// the exp-weights, so padded query rows (position -1) and rows with no
// visible key come out exactly 0, as in the reference (stock SDPA does not
// carry that contract).  GQA maps query head h to kv head h / (n_q/n_kv)
// without materialising the broadcast.
//
// Bound on this card: at the prefill shapes of the serving path (s = 256,
// head_dim 128) device-memory bandwidth bounds it: moving q, k, v and the
// output (q and the output are 4x the K/V bytes at 32/8 heads) takes
// longer than the bf16 products at the tensor-core rate.  The tensor-core
// rate bounds it only at much longer prompts.
//
// What held the first kernel back: one block per (64-row tile, *query*
// head), so the G query heads of a group each read the same K/V again;
// synchronous K/V loads between two barriers; V's B fragments built from
// scalar 16-bit loads.  It ran at 1.36x SDPA's time (PERF.md).
//
// Design for Hopper:
// - GQA packing.  One block per (64-row tile, kv head, batch row): the G
//   query heads of a kv head are stacked along the rows (packed row R is
//   position R / G, head R % G), so each K/V tile leaves device memory once
//   per group and not once per query head.  The mask depends on a row's
//   position only, so packing leaves it as it is.  The query tile is the
//   slowest grid index and runs last tile first: the tiles that see the
//   most keys start in the first wave.
// - Asynchronous K/V ring.  64-slot K/V tiles arrive by cp.async into a
//   two-stage ring (the next tile loads while this one is in the tensor
//   cores); q arrives the same way, into the second stage before that
//   stage's first K/V tile, and moves to registers as mma fragments.  Rows
//   are padded to 272 bytes, so ldmatrix reads of 8 rows hit 8 distinct
//   16-byte bank groups and no swizzle is needed.
// - Tensor cores: S = QK^T and O += PV on bf16 mma.sync m16n8k16 with f32
//   accumulation; q and K fragments come from ldmatrix, V's from
//   ldmatrix.trans (the PV operand's B fragment is V transposed), and the
//   score fragments are reused in registers as P, the PV A operand.
// - Registers for 3 blocks an SM: the online softmax steps over half
//   tiles (32 slots), so only 16 score registers are live; a warp skips a
//   half tile none of its rows can see (its state would not change).
// - The softmax is online in f32, in base 2 (scale * log2 e folded into
//   the scores, one ex2 per weight); the multiplicative mask is kept.  The
//   kv loop stops at min(max query position of the tile + 1, kv_len), and
//   slots past that limit are zero-filled by the copy and masked.
// - The output leaves through shared memory as 16-byte row chunks.
#include "common.cuh"  // from generativeaiexamples_tpu_torch/csrc/ (the probe builds with -I there)
#include "sm90.cuh"

namespace {

constexpr int HD = 128;
constexpr int BM = 64;   // packed (position, head) rows per block, 16 per warp
constexpr int BKV = 64;  // key slots per tile
constexpr int SUB = 32;  // key slots per online-softmax step (a half tile)
constexpr int THREADS = BM * 2;
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM the registers are sized for
// Shared-memory row stride in bf16 elements (272 bytes): 16-byte aligned,
// and ldmatrix reads of 8 consecutive rows fall on distinct banks.
constexpr int LDK = HD + 8;
constexpr int TILE_ELEMS = BKV * LDK;
constexpr int STAGES = 2;
// Each stage holds a K tile then a V tile; q is staged in stage 1.
constexpr int SMEM_BYTES = STAGES * 2 * TILE_ELEMS * 2;
static_assert(BM * LDK <= 2 * TILE_ELEMS, "q staging fits in one stage");
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (flushes denormals; 2^-huge is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void issue_q(__nv_bfloat16* dst, const __nv_bfloat16* q, const int* row_q, int tid) {
  // BM rows x 16 chunks of 16 bytes.
#pragma unroll
  for (int i = 0; i < BM * (HD / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, cc = c & 15;
    const int off = row_q[r];
    cp_async_16(dst + r * LDK + cc * 8, q + (off < 0 ? 0 : (size_t)off * HD + cc * 8), off >= 0);
  }
}

__device__ __forceinline__ void issue_kv(__nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int b, int kvh, int T, int n_kv, int kv0,
                                         int limit, int tid) {
  // 64 slots x 16 chunks of K and of V.
#pragma unroll
  for (int i = 0; i < BKV * (HD / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, cc = c & 15;
    const bool ok = kv0 + r < limit;
    const size_t off = ok ? (((size_t)b * T + kv0 + r) * n_kv + kvh) * HD + cc * 8 : 0;
    cp_async_16(ks + r * LDK + cc * 8, k + off, ok);
    cp_async_16(vs + r * LDK + cc * 8, v + off, ok);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out, int S,
                 int T, int n_q, int n_kv, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ int pos_s[BM];
  __shared__ int row_q[BM];  // row's q/out offset in units of HD elements, -1 if padding
  __shared__ int maxpos_s;

  const int G = n_q / n_kv;
  // The query tile is the slowest grid index, last tiles (most keys) first.
  const int kvh = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(kv_len[b], T);

  if (tid == 0) maxpos_s = -1;
  __syncthreads();
  for (int r = tid; r < BM; r += THREADS) {
    const int R = qt * BM + r;
    const bool ok = R < S * G;
    const int i = ok ? R / G : 0, j = ok ? R % G : 0;
    const int p = ok ? qpos[(size_t)b * S + i] : -1;
    pos_s[r] = p;
    row_q[r] = ok ? ((b * S + i) * n_q + kvh * G + j) : -1;
    atomicMax(&maxpos_s, p);
  }
  __syncthreads();
  const int limit = min(maxpos_s + 1, len);
  const int n_tiles = limit > 0 ? (limit + BKV - 1) / BKV : 0;

  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int p0 = pos_s[r0], p1 = pos_s[r1];
  const float scale2 = scale * LOG2E;
  int warp_maxpos = max(p0, p1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) warp_maxpos = max(warp_maxpos, __shfl_xor_sync(0xffffffffu, warp_maxpos, off));

  float m0 = GAIE_NEG_INF, m1 = GAIE_NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  if (n_tiles > 0) {  // block-uniform
    __nv_bfloat16* qs = ring + 2 * TILE_ELEMS;  // stage 1
    issue_q(qs, q, row_q, tid);
    cp_async_commit();
    issue_kv(ring, ring + TILE_ELEMS, k, v, b, kvh, T, n_kv, 0, limit, tid);
    cp_async_commit();
    cp_async_wait<1>();  // q; tile 0 may still be in flight
    __syncthreads();

    // This warp's 16 rows as A fragments over head_dim (8 k16 steps):
    // matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15) of each step.
    uint32_t qf[HD / 16][4];
    {
      const __nv_bfloat16* qrow =
          qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK + (lane >> 4) * 8;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) ldmatrix_x4(qf[kd], qrow + kd * 16);
    }
    __syncthreads();  // q's space is stage 1's again
    if (n_tiles > 1) {
      issue_kv(ring + 2 * TILE_ELEMS, ring + 3 * TILE_ELEMS, k, v, b, kvh, T, n_kv, BKV, limit, tid);
      cp_async_commit();
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int kv0 = it * BKV;
      const __nv_bfloat16* Ks = ring + (it & 1) * 2 * TILE_ELEMS;
      const __nv_bfloat16* Vs = Ks + TILE_ELEMS;
      if (it + 1 < n_tiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();

#pragma unroll 1
      for (int sub = 0; sub < BKV / SUB; ++sub) {
        // A warp whose rows see none of these slots skips them: its state
        // would not change (weights 0, rescale 1).
        const int c0 = kv0 + sub * SUB;
        if (c0 > warp_maxpos || c0 >= len) continue;

        // S = Q K^T: per pair of k16 steps, one ldmatrix.x4 gives b0/b1 of
        // both steps for 8 slots (rows of K are the B operand's columns).
        float sc[SUB / 8][4];
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
          const __nv_bfloat16* krow = Ks + (sub * SUB + nt * 8 + (lane & 7)) * LDK + (lane >> 3) * 8;
#pragma unroll
          for (int kd = 0; kd < HD / 16; kd += 2) {
            uint32_t kf[4];
            ldmatrix_x4(kf, krow + kd * 16);
            mma_bf16_16x8x16(sc[nt], qf[kd], kf[0], kf[1]);
            mma_bf16_16x8x16(sc[nt], qf[kd + 1], kf[2], kf[3]);
          }
        }

        // Scores in base 2 (scale * log2 e folded in), so each weight is
        // one ex2; the running max is kept in the same base.
        float mx0 = GAIE_NEG_INF, mx1 = GAIE_NEG_INF;
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + nt * 8 + t * 2 + (e & 1);
            const int p = e < 2 ? p0 : p1;
            const bool vis = col <= p && col < len;
            const float s = vis ? sc[nt][e] * scale2 : GAIE_NEG_INF;
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
        const float alpha0 = exp2_approx(m0 - mn0), alpha1 = exp2_approx(m1 - mn1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // Masked slots hold exactly -1e30: weight 0 (the multiplicative mask).
            const float s = sc[nt][e];
            const float p = s == GAIE_NEG_INF ? 0.f : exp2_approx(s - (e < 2 ? mn0 : mn1));
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
        // O += P V: P from the score registers; per 16 slots and pair of
        // 8-column output tiles, one ldmatrix.x4.trans gives both B fragments.
        const __nv_bfloat16* vrow =
            Vs + (sub * SUB + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < SUB / 16; ++kk) {
          uint32_t a[4];
          a[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
          a[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
          a[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          a[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
          for (int d = 0; d < HD / 8; d += 2) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vrow + kk * 16 * LDK + d * 8);
            mma_bf16_16x8x16(o[d], a, vf[0], vf[1]);
            mma_bf16_16x8x16(o[d + 1], a, vf[2], vf[3]);
          }
        }
      }
      __syncthreads();  // this stage is free for tile it + 2
      if (it + 2 < n_tiles) {
        issue_kv(ring + (it & 1) * 2 * TILE_ELEMS, ring + (it & 1) * 2 * TILE_ELEMS + TILE_ELEMS, k, v, b, kvh, T,
                 n_kv, (it + 2) * BKV, limit, tid);
        cp_async_commit();
      }
    }
  }

  // The normalized rows go through shared memory (the ring is free once
  // every warp is past its last tile), then out as 16-byte row chunks.
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __syncthreads();
  __nv_bfloat16* os = ring;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + t * 2;
    *reinterpret_cast<__nv_bfloat162*>(os + r0 * LDK + col) = __floats2bfloat162_rn(o[d][0] / den0, o[d][1] / den0);
    *reinterpret_cast<__nv_bfloat162*>(os + r1 * LDK + col) = __floats2bfloat162_rn(o[d][2] / den1, o[d][3] / den1);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM * (HD / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, cc = c & 15;
    if (row_q[r] >= 0)
      *reinterpret_cast<int4*>(out + (size_t)row_q[r] * HD + cc * 8) = *reinterpret_cast<const int4*>(os + r * LDK + cc * 8);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* qpos, const void* kv_len, void* out, int B,
                                      int S, int T, int n_q, int n_kv, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  // Once: allow the ring's dynamic shared memory (above the 48 KB default).
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int G = n_q / n_kv;
  const dim3 grid(n_kv, B, (S * G + BM - 1) / BM);
  flash_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(out), S, T, n_q, n_kv,
      scale);
  return static_cast<int>(cudaGetLastError());
}
