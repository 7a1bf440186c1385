// Tile math shared by the two decode-attention kernels (contiguous cache,
// decode_attention.cu; paged pool, paged_decode_attention.cu): one block
// per (row, kv-head), one warp per query head, the row's int8 K/V staged
// through shared memory in 64-slot logical tiles, online softmax in f32.
// Both kernels stage the same logical slots in the same order and run the
// same update, so on the same content they give the same bits.
#pragma once

#include "common.cuh"

namespace decode_tile {

constexpr int HD = 128;
constexpr int TILE = 64;
constexpr int MAX_G = 8;
// Words per shared-memory row: 32 words of data + 1 so that lanes reading
// the same word of different rows hit different banks.
constexpr int ROWW = HD / 4 + 1;

struct Smem {
  int k[TILE * ROWW];
  int v[TILE * ROWW];
  float kscale[TILE];
  float vscale[TILE];
  float q[MAX_G][HD];
  float pv[MAX_G][TILE];
};

// Stage n (<= TILE) slots into shared memory.  slot_of(r) gives the
// element offset, in slots, of tile row r from the bases kp/vp (values,
// HD bytes per slot) and ksp/vsp (scales).  Loads are 16-byte vectors
// within one slot's 128 contiguous bytes.
template <typename SlotOf>
__device__ __forceinline__ void stage(Smem& sm, const int8_t* kp, const int8_t* vp,
                                      const __nv_bfloat16* ksp, const __nv_bfloat16* vsp,
                                      int n, SlotOf slot_of) {
  for (int c = threadIdx.x; c < n * (HD / 16); c += blockDim.x) {
    const int r = c / (HD / 16), cc = c % (HD / 16);
    const size_t off = slot_of(r) * HD + cc * 16;
    const int4 kv = *reinterpret_cast<const int4*>(kp + off);
    const int4 vv = *reinterpret_cast<const int4*>(vp + off);
    int* kd = sm.k + r * ROWW + cc * 4;
    int* vd = sm.v + r * ROWW + cc * 4;
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const size_t s = slot_of(r);
    sm.kscale[r] = __bfloat162float(ksp[s]);
    sm.vscale[r] = __bfloat162float(vsp[s]);
  }
}

// One online-softmax step over n (<= TILE) staged slots for this warp's head.
__device__ __forceinline__ void online_update(Smem& sm, int n, float scale, float& m,
                                              float& l, float (&acc)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = sm.q[warp];
  float s[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = lane + 32 * jj;
    s[jj] = GAIE_NEG_INF;
    if (j < n) {
      const int* kr = sm.k + j * ROWW;
      float dot = 0.f;
#pragma unroll 8
      for (int w = 0; w < HD / 4; ++w) {
        const int word = kr[w];
        dot += q[4 * w + 0] * (float)(int8_t)(word & 0xff);
        dot += q[4 * w + 1] * (float)(int8_t)((word >> 8) & 0xff);
        dot += q[4 * w + 2] * (float)(int8_t)((word >> 16) & 0xff);
        dot += q[4 * w + 3] * (float)(int8_t)((word >> 24) & 0xff);
      }
      s[jj] = (dot * scale) * sm.kscale[j];
    }
  }
  const float m_new = fmaxf(m, warp_max(fmaxf(s[0], s[1])));
  const float alpha = expf(m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = lane + 32 * jj;
    float pv = 0.f;
    if (j < n) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      pv = __bfloat162float(__float2bfloat16_rn(p * sm.vscale[j]));
    }
    sm.pv[warp][j] = pv;
  }
  l = l * alpha + warp_sum(psum);
  __syncwarp();
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    const float p = sm.pv[warp][j];
    const int word = sm.v[j * ROWW + lane];
    part[0] += p * (float)(int8_t)(word & 0xff);
    part[1] += p * (float)(int8_t)((word >> 8) & 0xff);
    part[2] += p * (float)(int8_t)((word >> 16) & 0xff);
    part[3] += p * (float)(int8_t)((word >> 24) & 0xff);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = acc[i] * alpha + part[i];
  m = m_new;
  __syncwarp();
}

// Load this warp's query head (bf16 -> f32) into shared memory.
__device__ __forceinline__ void load_q(Smem& sm, const __nv_bfloat16* qp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) sm.q[warp][lane * 4 + i] = __bfloat162float(qp[lane * 4 + i]);
}

// Fold the append buffer (count valid slots of one (layer, head, row)
// slab) into the running softmax, then write this warp's output head.
__device__ __forceinline__ void finish(Smem& sm, const int8_t* kab, const int8_t* vab,
                                       const __nv_bfloat16* ksab, const __nv_bfloat16* vsab,
                                       size_t ab_row, int C, int count, float scale, float& m,
                                       float& l, float (&acc)[4], __nv_bfloat16* op) {
  if (kab != nullptr && count > 0) {
    __syncthreads();
    stage(sm, kab + ab_row * C * HD, vab + ab_row * C * HD, ksab + ab_row * C,
          vsab + ab_row * C, count, [](int r) { return (size_t)r; });
    __syncthreads();
    online_update(sm, count, scale, m, l, acc);
  }
  const int lane = threadIdx.x & 31;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) op[lane * 4 + i] = __float2bfloat16_rn(acc[i] / denom);
}

}  // namespace decode_tile
