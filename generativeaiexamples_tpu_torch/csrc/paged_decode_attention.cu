// One-token GQA decode attention over layer `layer` of the paged int8 KV
// pool, read through a page table, plus the decode chunk's append buffer.
//
// Replaces ops/decode_attention.py::paged_decode_gqa_attention (kernel
// _paged_decode_kernel) of the JAX package.
//
// Inputs: q (B, KH*G, 128) bf16; pool values k8/v8 (L, KH, P, 128) int8
// with scales ks/vs (L, KH, P) bf16, P = total_pages * pt; table
// (B, NP) int32 mapping row b's logical page j to pool page table[b, j];
// kv_len (B,) int32; optional append buffer kab/vab (L, KH, B, C, 128)
// int8 with scales (L, KH, B, C) bf16, of which slots [0, count) are valid.
// Row b attends logical slots [0, min(kv_len[b], window)), logical slot t
// read at pool slot table[b, t / pt] * pt + t % pt, then append slots
// [0, count).  The window cap is what the plain version and K2 do; the TPU
// kernel walks ceil(len / pt) pages instead, which is the same for every
// live lane (the caller's window covers it) and keeps lanes pinned at
// max_len - 1 from walking the whole table.  Unowned table entries are 0,
// the garbage page; pages may be shared between rows, so the kernel only
// reads.  Every pool offset is size_t: one leaf passes 2^31 bytes at
// Llama-3-8B width with 32 slots of 2048 tokens.
//
// Bound on this card: device-memory bandwidth, as K2.  Design: K2's grid
// and tile math (decode_tile.cuh) over 64-slot logical tiles; only the
// staging address goes through the table, so each tile holds the same
// slots in the same order as K2's and the result is K2's bit for bit at
// every page size.  Each slot's 128 bytes are contiguous in a page, so the
// loads stay 16-byte vectors.  No cp.async double buffer (the TPU kernel's
// ping-pong page DMA) and no split over T yet.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

__global__ void __launch_bounds__(MAX_G * 32)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8, const __nv_bfloat16* __restrict__ ks,
                        const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                        const int* __restrict__ table, const int8_t* __restrict__ kab,
                        const int8_t* __restrict__ vab, const __nv_bfloat16* __restrict__ ksab,
                        const __nv_bfloat16* __restrict__ vsab, __nv_bfloat16* __restrict__ out,
                        int layer, int KH, int B, int P, int NP, int pt, int C, int count,
                        int window, float scale) {
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
  const size_t slab = (size_t)layer * KH + h;  // (layer, head) pool slab
  const int8_t* kb = k8 + slab * P * HD;
  const int8_t* vb = v8 + slab * P * HD;
  const __nv_bfloat16* ksb = ks + slab * P;
  const __nv_bfloat16* vsb = vs + slab * P;
  const int* tab = table + (size_t)b * NP;
  for (int t0 = 0; t0 < n_cache; t0 += TILE) {
    const int n = min(TILE, n_cache - t0);
    __syncthreads();
    stage(sm, kb, vb, ksb, vsb, n, [t0, tab, pt](int r) {
      const int t = t0 + r;
      return (size_t)tab[t / pt] * pt + t % pt;
    });
    __syncthreads();
    online_update(sm, n, scale, m, l, acc);
  }
  finish(sm, kab, vab, ksab, vsab, slab * B + b, C, count, scale, m, l, acc,
         out + ((size_t)b * n_q + head) * HD);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  kab == nullptr means
// no append buffer.
extern "C" int paged_decode_attention_launch(const void* q, const void* k8, const void* v8,
                                             const void* ks, const void* vs,
                                             const void* kv_len, const void* table,
                                             const void* kab, const void* vab,
                                             const void* ksab, const void* vsab, void* out,
                                             int layer, int B, int KH, int G, int P, int NP,
                                             int pt, int C, int count, int window, float scale,
                                             void* stream) {
  if (B <= 0) return 0;
  const dim3 grid(B, KH);
  paged_decode_kernel<<<grid, G * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_len),
      static_cast<const int*>(table), static_cast<const int8_t*>(kab),
      static_cast<const int8_t*>(vab), static_cast<const __nv_bfloat16*>(ksab),
      static_cast<const __nv_bfloat16*>(vsab), static_cast<__nv_bfloat16*>(out), layer, KH, B,
      P, NP, pt, C, count, window, scale);
  return static_cast<int>(cudaGetLastError());
}
