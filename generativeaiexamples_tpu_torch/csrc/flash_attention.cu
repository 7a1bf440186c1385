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
// carry that contract).  GQA maps query head h to kv head h / (n_q/n_kv)
// without materialising the broadcast.
//
// Bound on this card: at the prefill shapes of the serving path (s = 256,
// head_dim 128) device-memory bandwidth bounds it: moving q, k, v and the
// output (q and the output are 4x the K/V bytes at 32/8 heads) takes
// longer than the bf16 products at the tensor-core rate.  The tensor-core
// rate bounds it only at much longer prompts.  So what counts is how many
// bytes each SM keeps in flight: the blocks an SM holds at once.
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
// - Tensor cores the Hopper way: one warpgroup per block runs bf16 wgmma.
//   S = Q K^T reads both operands from shared memory (Q and K K-major);
//   O += P V takes P from the score registers as the A operand and reads V
//   MN-major (transposed) from shared memory, so nothing is reshuffled.
//   Every tile is in the 128-byte swizzled layout wgmma reads (two halves
//   of 64 head dims, 16-byte chunk c of row r at chunk c ^ (r % 8)).
// - Four blocks an SM: Q stays in shared memory (no fragment registers)
//   and K/V arrive in 32-slot tiles, so a block holds 48 KB of shared
//   memory and 114 registers a thread.  Against an mma.sync version of the
//   same packing (ldmatrix fragments, q in registers, 64-slot tiles, 3
//   blocks an SM), this is 1.4x faster at check_flash's shape (PERF.md,
//   perf_torch/probe_flash_designs.py).
// - Asynchronous K/V ring.  K/V tiles arrive by cp.async (zero-filled past
//   the kv limit) into a two-stage ring: the next tile loads while this one
//   is in the tensor cores.  q arrives the same way, first.  An async-proxy
//   fence orders the copies before wgmma reads them.
// - The softmax is online in f32, in base 2 (scale * log2 e folded into
//   the scores, one ex2 per weight); the multiplicative mask is kept.  The
//   kv loop stops at min(max query position of the tile + 1, kv_len).
// - The output leaves through shared memory as 16-byte row chunks.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int HD = 128;
constexpr int BM = 64;   // packed (position, head) rows per block, 16 per warp
constexpr int BKV = 32;  // key slots per tile
constexpr int THREADS = 128;  // one warpgroup
constexpr int MIN_BLOCKS = 4;  // resident blocks per SM the registers are sized for
// A tile of R rows x 128 head dims is two halves of R rows x 128 bytes.
constexpr int Q_HALF = BM * 64;  // elements
constexpr int KV_HALF = BKV * 64;
constexpr int KV_TILE = 2 * KV_HALF;
constexpr int STAGES = 2;
// q, then each stage's K tile and V tile; slack to align the base to 1024.
constexpr int SMEM_BYTES = (2 * Q_HALF + STAGES * 2 * KV_TILE) * 2 + 1024;
constexpr int LDO = HD + 8;  // output staging row stride (elements)
static_assert(BM * LDO <= STAGES * 2 * KV_TILE, "output staging fits in the ring");
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (flushes denormals; 2^-huge is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of 16-byte chunk cc (0..15) of row r in a swizzled tile
// whose halves are `half` elements apart.
template <int half>
__device__ __forceinline__ int swz(int r, int cc) {
  return (cc >> 3) * half + r * 64 + (((cc & 7) ^ (r & 7)) << 3);
}

// Makes this thread's completed cp.async writes visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void issue_q(__nv_bfloat16* dst, const __nv_bfloat16* q, const int* row_q, int tid) {
  // BM rows x 16 chunks of 16 bytes.
#pragma unroll
  for (int i = 0; i < BM * (HD / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, cc = c & 15;
    const int off = row_q[r];
    cp_async_16(dst + swz<Q_HALF>(r, cc), q + (off < 0 ? 0 : (size_t)off * HD + cc * 8), off >= 0);
  }
}

__device__ __forceinline__ void issue_kv(__nv_bfloat16* ks, const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         int b, int kvh, int T, int n_kv, int kv0, int limit, int tid) {
  // BKV slots x 16 chunks of K and of V; V's tile follows K's.
#pragma unroll
  for (int i = 0; i < BKV * (HD / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, cc = c & 15;
    const bool ok = kv0 + r < limit;
    const size_t off = ok ? (((size_t)b * T + kv0 + r) * n_kv + kvh) * HD + cc * 8 : 0;
    cp_async_16(ks + swz<KV_HALF>(r, cc), k + off, ok);
    cp_async_16(ks + KV_TILE + swz<KV_HALF>(r, cc), v + off, ok);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out, int S,
                 int T, int n_q, int n_kv, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The swizzle is on address bits, so tiles start 1024-byte aligned.
  __nv_bfloat16* qs =
      reinterpret_cast<__nv_bfloat16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ring = qs + 2 * Q_HALF;
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

  // This thread's two rows of the warpgroup's accumulators.
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int p0 = pos_s[r0], p1 = pos_s[r1];
  const float scale2 = scale * LOG2E;

  float m0 = GAIE_NEG_INF, m1 = GAIE_NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[HD / 2];  // o[4d + e]: columns 8d + 2t + (e & 1) of rows r0 (e < 2) and r1
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  if (n_tiles > 0) {  // block-uniform
    issue_q(qs, q, row_q, tid);
    issue_kv(ring, k, v, b, kvh, T, n_kv, 0, limit, tid);
    cp_async_commit();
    if (n_tiles > 1) {
      issue_kv(ring + 2 * KV_TILE, k, v, b, kvh, T, n_kv, BKV, limit, tid);
      cp_async_commit();
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int c0 = it * BKV;
      const __nv_bfloat16* Ks = ring + (it & 1) * 2 * KV_TILE;
      const __nv_bfloat16* Vs = Ks + KV_TILE;
      if (it + 1 < n_tiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();

      // S = Q K^T over head_dim in 8 k16 steps; step kd is 32 bytes into
      // half kd / 4 of both swizzled tiles.
      float sc[BKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        wgmma_bf16_m64n32_ss(sc, wgmma_desc_sw128(qs + (kd >> 2) * Q_HALF, (kd & 3) * 32),
                             wgmma_desc_sw128(Ks + (kd >> 2) * KV_HALF, (kd & 3) * 32), kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(sc);

      // Scores in base 2 (scale * log2 e folded in), so each weight is
      // one ex2; the running max is kept in the same base.  sc[4n + e] is
      // column 8n + 2t + (e & 1) of row r0 (e < 2) or r1.
      float mx0 = GAIE_NEG_INF, mx1 = GAIE_NEG_INF;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int col = c0 + (i >> 2) * 8 + t * 2 + (i & 1);
        const int p = (i & 2) ? p1 : p0;
        const float s = col <= p && col < len ? sc[i] * scale2 : GAIE_NEG_INF;
        sc[i] = s;
        if (i & 2) mx1 = fmaxf(mx1, s); else mx0 = fmaxf(mx0, s);
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
      for (int i = 0; i < BKV / 2; ++i) {
        // Masked slots hold exactly -1e30: weight 0 (the multiplicative mask).
        const float s = sc[i];
        const float p = s == GAIE_NEG_INF ? 0.f : exp2_approx(s - ((i & 2) ? mn1 : mn0));
        sc[i] = p;
        if (i & 2) sum1 += p; else sum0 += p;
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
        o[4 * d] *= alpha0; o[4 * d + 1] *= alpha0;
        o[4 * d + 2] *= alpha1; o[4 * d + 3] *= alpha1;
      }

      // O += P V: the weights, packed to bf16, are the A fragments of the
      // two k16 steps over this tile's slots; V is read transposed, 16
      // slots (2048 bytes) a step, its second 64 head dims KV_HALF on.
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16x2(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      wgmma_fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_bf16_m64n128_rs_mn(o, pa[kk], wgmma_desc_sw128_mn(Vs + kk * 16 * 64, KV_HALF * 2, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(o);

      __syncthreads();  // this stage is free for tile it + 2
      if (it + 2 < n_tiles) {
        issue_kv(ring + (it & 1) * 2 * KV_TILE, k, v, b, kvh, T, n_kv, (it + 2) * BKV, limit, tid);
        cp_async_commit();
      }
    }
  }

  // The normalized rows go through shared memory (the ring is free once
  // the last tile's products are done), then out as 16-byte row chunks.
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __syncthreads();
  __nv_bfloat16* os = ring;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + t * 2;
    *reinterpret_cast<__nv_bfloat162*>(os + r0 * LDO + col) =
        __floats2bfloat162_rn(o[4 * d] / den0, o[4 * d + 1] / den0);
    *reinterpret_cast<__nv_bfloat162*>(os + r1 * LDO + col) =
        __floats2bfloat162_rn(o[4 * d + 2] / den1, o[4 * d + 3] / den1);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM * (HD / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, cc = c & 15;
    if (row_q[r] >= 0)
      *reinterpret_cast<int4*>(out + (size_t)row_q[r] * HD + cc * 8) = *reinterpret_cast<const int4*>(os + r * LDO + cc * 8);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* qpos, const void* kv_len, void* out, int B,
                                      int S, int T, int n_q, int n_kv, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  // Once: allow the dynamic shared memory (above the 48 KB default).
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
