// One-token GQA decode attention over layer `layer` of the stacked int8 KV
// cache, plus the decode chunk's append buffer.
//
// Replaces ops/decode_attention.py::decode_gqa_attention (kernels
// _decode_kernel and _online_update) of the JAX package.
//
// Inputs: q (B, KH*G, HD) bf16; k8/v8 (L, KH, B, T, HD) int8 with scales
// ks/vs (L, KH, B, T) bf16; kv_len (B,) int32; optional append buffer
// kab/vab (L, KH, B, C, HD) int8 with scales (L, KH, B, C) bf16, of which
// slots [0, count) are valid.  Row b attends cache slots
// [0, min(kv_len[b], window)), then append slots [0, count).  Lanes the
// scheduler pins at max_len - 1 therefore read only `window` slots, as the
// reference does.  Scales fold into the scores and the softmax weights,
// never into a dequantized copy; p * vscale is rounded to bf16 before the
// PV product, as the reference rounds it to the query dtype.  A row with no
// visible slot gives exact zeros.
//
// Bound on this card: device-memory bandwidth (each cached int8 K/V byte is
// used for G multiply-adds, 1 to 12 at the served shapes).  Design:
// decode_tile.cuh (a split over T in clusters of blocks, a cp.async ring,
// tensor-core products that unpack each byte once per block, a combine
// through distributed shared memory), at three (HD, MAX_G) instances:
// (128, 8), (128, 16) and (256, 8).  This file only says where logical
// slot t of a row lives: at slot t of the row's (layer, head, b) slab.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

template <int HD, int MAX_G, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8, const __nv_bfloat16* __restrict__ ks,
                  const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                  const int8_t* __restrict__ kab, const int8_t* __restrict__ vab,
                  const __nv_bfloat16* __restrict__ ksab, const __nv_bfloat16* __restrict__ vsab,
                  __nv_bfloat16* __restrict__ out, int layer, int KH, int B, int T, int G, int C,
                  int count, int window, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int n_q = KH * G;
  const int n_cache = max(0, min(kv_len[b], window));
  const size_t row = ((size_t)layer * KH + h) * B + b;  // (layer, head, b) slab
  const bool ab = kab != nullptr;
  run_block<HD, MAX_G>(q + ((size_t)b * n_q + h * G) * HD, G, k8 + row * T * HD, v8 + row * T * HD,
                       ks + row * T, vs + row * T, ContiguousSlots{}, n_cache,
                       ab ? kab + row * C * HD : nullptr, ab ? vab + row * C * HD : nullptr,
                       ab ? ksab + row * C : nullptr, ab ? vsab + row * C : nullptr, count, scale,
                       out + ((size_t)b * n_q + h * G) * HD);
}

template <int HD, int MAX_G, int MIN_BLOCKS>
int launch_instance(const void* q, const void* k8, const void* v8, const void* ks, const void* vs,
                    const void* kv_len, const void* kab, const void* vab, const void* ksab, const void* vsab,
                    void* out, int layer, int B, int KH, int G, int T, int C, int count, int window, int splits,
                    float scale, void* stream) {
  constexpr int DYN = Geo<HD, MAX_G>::DYNAMIC_SMEM;
  auto kernel = decode_kernel<HD, MAX_G, MIN_BLOCKS>;
  static const int attr = allow_dynamic_smem(kernel, DYN);
  if (attr != 0) return attr;
  return launch(kernel, B, KH, splits, DYN, stream, static_cast<const __nv_bfloat16*>(q),
                static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8),
                static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
                static_cast<const int*>(kv_len), static_cast<const int8_t*>(kab),
                static_cast<const int8_t*>(vab), static_cast<const __nv_bfloat16*>(ksab),
                static_cast<const __nv_bfloat16*>(vsab), static_cast<__nv_bfloat16*>(out), layer, KH, B, T,
                G, C, count, window, scale);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  kab == nullptr means
// no append buffer; `splits` (1..8) is ops/decode_attention.py's plan.
// The instance follows (hd, G) (decode_tile.cuh's with_instance); any
// other shape is cudaErrorInvalidValue.
extern "C" int decode_attention_launch(const void* q, const void* k8, const void* v8,
                                       const void* ks, const void* vs, const void* kv_len,
                                       const void* kab, const void* vab, const void* ksab,
                                       const void* vsab, void* out, int layer, int B, int KH,
                                       int G, int hd, int T, int C, int count, int window, int splits,
                                       float scale, void* stream) {
  if (B <= 0) return 0;
  if (splits < 1 || splits > decode_tile::MAX_SPLITS || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  return decode_tile::with_instance(hd, G, [&](auto inst) {
    using I = decltype(inst);
    return launch_instance<I::HD, I::MAX_G, I::MIN_BLOCKS>(q, k8, v8, ks, vs, kv_len, kab, vab, ksab, vsab, out,
                                                           layer, B, KH, G, T, C, count, window, splits, scale,
                                                           stream);
  });
}
