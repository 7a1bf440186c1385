// One-token GQA decode attention over layer `layer` of the paged int8 KV
// pool, read through a page table, plus the decode chunk's append buffer.
//
// Replaces ops/decode_attention.py::paged_decode_gqa_attention (kernel
// _paged_decode_kernel) of the JAX package.
//
// Inputs: q (B, KH*G, HD) bf16; pool values k8/v8 (L, KH, P, HD) int8
// with scales ks/vs (L, KH, P) bf16, P = total_pages * pt; table
// (B, NP) int32 mapping row b's logical page j to pool page table[b, j];
// kv_len (B,) int32; optional append buffer kab/vab (L, KH, B, C, HD)
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
// Bound on this card: device-memory bandwidth, as K2.  Design: K2's core
// (decode_tile.cuh: split over T in clusters, cp.async ring, tensor-core
// products, combine through distributed shared memory) over the same
// 64-slot logical tiles dealt to the same splits; only a slot's address
// goes through the table, read a tile ahead of the tile's copy (the TPU
// kernel's ping-pong page DMA becomes the ring), with shifts and masks: a
// page is a power of two of slots, as the scheduler requires.  So the
// result is K2's bit for bit at every page size, at each of K2's three
// (HD, MAX_G) instances.  Each slot's HD bytes are contiguous in a page, so
// the copies stay 16-byte vectors.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

// Logical slot t of a row at pool slot table[t >> shift] << shift | (t &
// mask): pages are 2^shift slots (the scheduler only makes such pages).
struct PagedSlots {
  const int* tab;
  int shift;
  __device__ __forceinline__ int key(int t) const { return tab[t >> shift]; }
  __device__ __forceinline__ size_t slot(int page, int t) const {
    return ((size_t)page << shift) | (size_t)(t & ((1 << shift) - 1));
  }
};

template <int HD, int MAX_G, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8, const __nv_bfloat16* __restrict__ ks,
                        const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                        const int* __restrict__ table, const int8_t* __restrict__ kab,
                        const int8_t* __restrict__ vab, const __nv_bfloat16* __restrict__ ksab,
                        const __nv_bfloat16* __restrict__ vsab, __nv_bfloat16* __restrict__ out,
                        int layer, int KH, int B, int P, int NP, int pt_shift, int G, int C,
                        int count, int window, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int n_q = KH * G;
  const int n_cache = max(0, min(kv_len[b], window));
  const size_t slab = (size_t)layer * KH + h;  // (layer, head) pool slab
  const size_t ab_row = slab * B + b;
  const int* tab = table + (size_t)b * NP;
  const bool ab = kab != nullptr;
  run_block<HD, MAX_G>(q + ((size_t)b * n_q + h * G) * HD, G, k8 + slab * P * HD, v8 + slab * P * HD,
                       ks + slab * P, vs + slab * P, PagedSlots{tab, pt_shift}, n_cache,
                       ab ? kab + ab_row * C * HD : nullptr, ab ? vab + ab_row * C * HD : nullptr,
                       ab ? ksab + ab_row * C : nullptr, ab ? vsab + ab_row * C : nullptr, count, scale,
                       out + ((size_t)b * n_q + h * G) * HD);
}

template <int HD, int MAX_G, int MIN_BLOCKS>
int launch_instance(const void* q, const void* k8, const void* v8, const void* ks, const void* vs,
                    const void* kv_len, const void* table, const void* kab, const void* vab, const void* ksab,
                    const void* vsab, void* out, int layer, int B, int KH, int G, int P, int NP, int pt_shift,
                    int C, int count, int window, int splits, float scale, void* stream) {
  constexpr int DYN = Geo<HD, MAX_G>::DYNAMIC_SMEM;
  auto kernel = paged_decode_kernel<HD, MAX_G, MIN_BLOCKS>;
  static const int attr = allow_dynamic_smem(kernel, DYN);
  if (attr != 0) return attr;
  return launch(kernel, B, KH, splits, DYN, stream, static_cast<const __nv_bfloat16*>(q),
                static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8),
                static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
                static_cast<const int*>(kv_len), static_cast<const int*>(table),
                static_cast<const int8_t*>(kab), static_cast<const int8_t*>(vab),
                static_cast<const __nv_bfloat16*>(ksab), static_cast<const __nv_bfloat16*>(vsab),
                static_cast<__nv_bfloat16*>(out), layer, KH, B, P, NP, pt_shift, G, C, count, window, scale);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).  kab == nullptr means
// no append buffer; `splits` (1..8) is ops/decode_attention.py's plan;
// pt, the page's slot count, must be a power of two.  The instance follows
// (hd, G) as K2's does; any other shape is cudaErrorInvalidValue.
extern "C" int paged_decode_attention_launch(const void* q, const void* k8, const void* v8,
                                             const void* ks, const void* vs,
                                             const void* kv_len, const void* table,
                                             const void* kab, const void* vab,
                                             const void* ksab, const void* vsab, void* out,
                                             int layer, int B, int KH, int G, int hd, int P, int NP,
                                             int pt, int C, int count, int window,
                                             int splits, float scale, void* stream) {
  if (B <= 0) return 0;
  if (splits < 1 || splits > decode_tile::MAX_SPLITS || G < 1 || pt < 1 || (pt & (pt - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pt_shift = __builtin_ctz(static_cast<unsigned>(pt));
  return decode_tile::with_instance(hd, G, [&](auto inst) {
    using I = decltype(inst);
    return launch_instance<I::HD, I::MAX_G, I::MIN_BLOCKS>(q, k8, v8, ks, vs, kv_len, table, kab, vab, ksab, vsab,
                                                           out, layer, B, KH, G, P, NP, pt_shift, C, count, window,
                                                           splits, scale, stream);
  });
}
