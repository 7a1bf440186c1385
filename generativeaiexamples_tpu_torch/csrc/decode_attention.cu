// One-token GQA decode attention over layer `layer` of the stacked int8 KV
// cache, plus the decode chunk's append buffer.
//
// Replaces ops/decode_attention.py::decode_gqa_attention (kernels
// _decode_kernel and _online_update) of the JAX package.
//
// Inputs: q (B, KH*G, 128) bf16; k8/v8 (L, KH, B, T, 128) int8 with scales
// ks/vs (L, KH, B, T) bf16; kv_len (B,) int32; optional append buffer
// kab/vab (L, KH, B, C, 128) int8 with scales (L, KH, B, C) bf16, of which
// slots [0, count) are valid.  Row b attends cache slots
// [0, min(kv_len[b], window)), then append slots [0, count).  Lanes the
// scheduler pins at max_len - 1 therefore read only `window` slots, as the
// reference does.  Scales fold into the scores and the softmax weights,
// never into a dequantized copy; p * vscale is rounded to bf16 before the
// PV product, as the reference rounds it to the query dtype.  A row with no
// visible slot gives exact zeros.
//
// Bound on this card: device-memory bandwidth (each cached int8 K/V byte is
// used for G = 4 multiply-adds).  Design: one block per (row, kv-head) so
// each K/V byte is read from device memory once for all G query heads of
// the group; one warp per query head; the row's K/V stream through shared
// memory in 64-slot tiles with 16-byte loads; online softmax in f32.  No
// multi-stage pipelining and no split over T: this is the simple first
// kernel, and rows with long contexts are not split across SMs yet.
#include "common.cuh"

namespace {

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

__device__ __forceinline__ void stage(Smem& sm, const int8_t* kp, const int8_t* vp,
                                      const __nv_bfloat16* ksp, const __nv_bfloat16* vsp,
                                      int n) {
  for (int c = threadIdx.x; c < n * (HD / 16); c += blockDim.x) {
    const int r = c / (HD / 16), cc = c % (HD / 16);
    const int4 kv = *reinterpret_cast<const int4*>(kp + (size_t)r * HD + cc * 16);
    const int4 vv = *reinterpret_cast<const int4*>(vp + (size_t)r * HD + cc * 16);
    int* kd = sm.k + r * ROWW + cc * 4;
    int* vd = sm.v + r * ROWW + cc * 4;
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    sm.kscale[r] = __bfloat162float(ksp[r]);
    sm.vscale[r] = __bfloat162float(vsp[r]);
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

__global__ void __launch_bounds__(MAX_G * 32)
    decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8, const __nv_bfloat16* __restrict__ ks,
                  const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                  const int8_t* __restrict__ kab, const int8_t* __restrict__ vab,
                  const __nv_bfloat16* __restrict__ ksab, const __nv_bfloat16* __restrict__ vsab,
                  __nv_bfloat16* __restrict__ out, int layer, int KH, int B, int T, int C,
                  int count, int window, float scale) {
  __shared__ __align__(16) Smem sm;
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_q = KH * G;
  const int head = h * G + warp;
  const __nv_bfloat16* qp = q + ((size_t)b * n_q + head) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) sm.q[warp][lane * 4 + i] = __bfloat162float(qp[lane * 4 + i]);

  float m = GAIE_NEG_INF, l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int n_cache = max(0, min(kv_len[b], window));
  const size_t row = ((size_t)layer * KH + h) * B + b;  // (layer, head, b) slab
  const int8_t* kb = k8 + row * T * HD;
  const int8_t* vb = v8 + row * T * HD;
  const __nv_bfloat16* ksb = ks + row * T;
  const __nv_bfloat16* vsb = vs + row * T;
  for (int t0 = 0; t0 < n_cache; t0 += TILE) {
    const int n = min(TILE, n_cache - t0);
    __syncthreads();
    stage(sm, kb + (size_t)t0 * HD, vb + (size_t)t0 * HD, ksb + t0, vsb + t0, n);
    __syncthreads();
    online_update(sm, n, scale, m, l, acc);
  }
  if (kab != nullptr && count > 0) {
    __syncthreads();
    stage(sm, kab + row * C * HD, vab + row * C * HD, ksab + row * C, vsab + row * C, count);
    __syncthreads();
    online_update(sm, count, scale, m, l, acc);
  }
  const float denom = fmaxf(l, 1e-30f);
  __nv_bfloat16* op = out + ((size_t)b * n_q + head) * HD + lane * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) op[i] = __float2bfloat16_rn(acc[i] / denom);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  kab == nullptr means
// no append buffer.
extern "C" int decode_attention_launch(const void* q, const void* k8, const void* v8,
                                       const void* ks, const void* vs, const void* kv_len,
                                       const void* kab, const void* vab, const void* ksab,
                                       const void* vsab, void* out, int layer, int B, int KH,
                                       int G, int T, int C, int count, int window,
                                       float scale, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid(B, KH);
  decode_kernel<<<grid, G * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_len),
      static_cast<const int8_t*>(kab), static_cast<const int8_t*>(vab),
      static_cast<const __nv_bfloat16*>(ksab), static_cast<const __nv_bfloat16*>(vsab),
      static_cast<__nv_bfloat16*>(out), layer, KH, B, T, C, count, window, scale);
  return static_cast<int>(cudaGetLastError());
}
