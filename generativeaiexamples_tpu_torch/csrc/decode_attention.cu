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
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

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
  const int warp = threadIdx.x >> 5;
  const int n_q = KH * G;
  const int head = h * G + warp;
  load_q(sm, q + ((size_t)b * n_q + head) * HD);

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
    stage(sm, kb, vb, ksb, vsb, n, [t0](int r) { return (size_t)(t0 + r); });
    __syncthreads();
    online_update(sm, n, scale, m, l, acc);
  }
  finish(sm, kab, vab, ksab, vsab, row, C, count, scale, m, l, acc,
         out + ((size_t)b * n_q + head) * HD);
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
