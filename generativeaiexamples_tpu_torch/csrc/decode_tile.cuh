// The core shared by the two decode-attention kernels (contiguous cache,
// decode_attention.cu; paged pool, paged_decode_attention.cu): everything
// but the address of a logical slot.  Together they replace the JAX
// package's ops/decode_attention.py decode kernels (_decode_kernel with
// _online_update, and _paged_decode_kernel), whose T axis is a sequential
// grid dimension with a ping-pong page DMA.
//
// Bound on this card: device-memory bandwidth.  Each int8 K/V byte is used
// for G (= 4) multiply-adds, far below the ~295 operations per byte at
// which the tensor cores would bound it.  What held the first kernel back
// was not the bytes: a grid of (row, kv head) blocks, under two 4-warp
// blocks per SM at the serving shape, each walking up to 1024 slots in
// order; synchronous staging; and every int8 byte unpacked to float by
// each of the G warps.  This design:
//
// - Split over T.  The grid is (B, KH, splits), one thread-block cluster
//   of `splits` blocks per (row, kv head).  A row's logical slots
//   [0, min(kv_len, window)) are cut into 64-slot tiles dealt round-robin:
//   split z takes tiles z, z + splits, ...  The append buffer is logical
//   tile n_cache_tiles of the same sequence, so exactly one split folds it
//   in.  Round-robin keeps the splits' work within one tile of each other
//   at every length.  ops/decode_attention.py::decode_plan picks `splits`
//   from (B, KH) only: the split count fixes the order of a row's sums, so
//   it must not move with the window (a prompt decodes alike alone and in
//   a batch).  Registers are sized for 4 blocks an SM, so the serving
//   shape's 32 x 8 x 2 blocks run in one wave.
// - Asynchronous staging.  Tiles arrive by cp.async (16-byte vectors of a
//   slot's 128 contiguous bytes) into a two-stage ring: the next tile
//   loads while this one is computed.  Scales are loaded a tile ahead into
//   registers.  The paged kernel reads the page table for a tile's copy
//   one tile ahead of issuing it, so the lookup overlaps the math.
// - Each byte is unpacked once per block.  The 4 warps share a tile: warp
//   w takes its slots [16w, 16w + 16) and keeps its own online softmax.
//   Both products run on bf16 mma.sync m16n8k16: S = QK^T with the G query
//   heads as rows (padded to 16), and the output transposed, O^T = V^T P^T,
//   with head_dim as rows and the heads as columns (padded to 8), so the
//   score registers are P^T's fragment as they stand and no accumulator
//   row is padding.  int8 -> bf16 is exact, bf16 x bf16 products are exact
//   in f32, and p·vscale is rounded to bf16 before the PV product as
//   before, so only the order of the f32 sums differs from the plain
//   version.  The head_dim order is permuted in both products (a thread
//   owns 32 contiguous K bytes and 16 contiguous V bytes of a slot) and
//   put back when the partials are written.
// - Combine.  The warps' (m, l, acc) partials combine in warp order in
//   shared memory, then the splits' in split order through distributed
//   shared memory after a cluster barrier: no workspace outlives the
//   launch.  Each block of the cluster writes a slice of the outputs.
//
// Semantics kept from the first kernel: a row reads slots
// [0, min(kv_len, window)), then append slots [0, count); scores are
// (dot * scale) * kscale; p * vscale is rounded to bf16 before the PV
// product; an empty row gives exact zeros; pool offsets are size_t; the
// paged kernel only reads the pool.  Both kernels deal the same logical
// tiles to the same splits and combine in the same order, so on the same
// content they give the same bits at every page size.
//
// Instances.  The core is a template over (HD, MAX_G): head_dim and the
// most query heads a kv head has.  Each instance has its own occupancy,
// so the Llama instance keeps its shape:
// - (128, 8, 4 blocks an SM): Llama-3 (G = 4), Mixtral (G = 4), the 1B
//   draft's kv heads at 128.  The query heads are the rows g < 8 of the
//   score product (rows g + 8 are zero) and the 8 columns of O^T.
// - (128, 16, 2 blocks an SM): StarCoder2-3B (G = 12).  The score product
//   uses rows g + 8 for heads 8..15, and O^T gets a second 8-head column
//   tile: the accumulators double, so the registers are sized for 2 blocks.
// - (256, 8, 2 blocks an SM): Gemma-2B (G = 8) and Gemma-7B (G = 1).  A
//   thread takes 64 K bytes and 32 V bytes of a slot, the accumulators
//   double, and the two-stage ring of 64-slot tiles is 70 KB, above the
//   48 KB of static shared memory: that instance's blocks take it as
//   dynamic shared memory (launch sets the limit), 3 blocks an SM at most.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace decode_tile {

constexpr int TILE = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SPLITS = 8;  // portable cluster size
constexpr int STAGES = 2;
constexpr int STATIC_SMEM = 48 * 1024;  // the most static shared memory a block may hold

// One instance's geometry: head_dim HD (a multiple of 128) and at most
// MAX_G (8 or 16) query heads a kv head.
template <int HD_, int MAX_G_>
struct Geo {
  static constexpr int HD = HD_;
  static constexpr int MAX_G = MAX_G_;
  static_assert(HD % 128 == 0 && (MAX_G == 8 || MAX_G == 16), "head_dim 128k, groups up to 8 or 16");
  static constexpr int HB = MAX_G / 8;  // 8-head halves: score rows g and g + 8, O^T column tiles
  static constexpr int KD = HD / 16;    // k16 steps of S = QK^T, and 16-row head_dim tiles of O^T
  static constexpr int KB = HD / 4;     // K bytes of a slot a thread multiplies (its quarter t)
  static constexpr int VB = HD / 8;     // V bytes of a slot a thread multiplies (its eighth g)
  // Shared-memory row stride in bytes: 16-byte aligned, and at HD 128 the
  // 16-byte reads of 8 lanes (2 slots x 4 column groups) fall on distinct
  // banks.
  static constexpr int ROWB = HD + 16;
  static constexpr int CH = HD / 16;  // 16-byte chunks of a slot
  static constexpr int COPY_ROWS = TILE * CH / THREADS;  // 16-byte copies of K (and of V) a thread

  struct Stage {
    int8_t k[TILE * ROWB];
    int8_t v[TILE * ROWB];
    float kscale[TILE];
    float vscale[TILE];
  };

  // Partials, written once the ring is drained (they share its space).
  struct Partials {
    float acc[WARPS][MAX_G][HD];
    float m[WARPS][MAX_G];
    float l[WARPS][MAX_G];
    float block_acc[MAX_G][HD];  // this block's combined partial, read by the cluster
    float block_m[MAX_G];
    float block_l[MAX_G];
  };

  union __align__(16) Smem {
    Stage ring[STAGES];
    Partials fin;
  };

  // Dynamic shared memory a block needs (0: it fits as static).
  static constexpr int DYNAMIC_SMEM = sizeof(Smem) <= STATIC_SMEM ? 0 : (int)sizeof(Smem);
};

// The block's shared memory: static when it fits in 48 KB, else the
// dynamic shared memory the launch gives it.
template <int HD, int MAX_G>
__device__ __forceinline__ typename Geo<HD, MAX_G>::Smem& block_smem() {
  using Smem = typename Geo<HD, MAX_G>::Smem;
  if constexpr (Geo<HD, MAX_G>::DYNAMIC_SMEM == 0) {
    __shared__ Smem sm;
    return sm;
  } else {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    return *reinterpret_cast<Smem*>(dyn_smem);
  }
}

// int8 byte i of a word already XORed with 0x80808080 (so the byte holds
// x + 128), as an exact float: 2^23 + (x + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) - 8388736.f;
}

// Where a row's logical slot t lives, in two steps: key(t) is the memory
// read it needs (the page-table entry; none for the contiguous cache), and
// slot(key, t) the arithmetic on it.  The keys of a tile are read a tile
// ahead of its copy, so the copy never waits on a lookup.
struct ContiguousSlots {
  __device__ __forceinline__ int key(int) const { return 0; }
  __device__ __forceinline__ size_t slot(int, int t) const { return (size_t)t; }
};

// Where this thread's part of a tile comes from: the keys of its copy rows
// (tid / CH + (THREADS / CH) i) and of its scale row (tid % TILE).
template <int COPY_ROWS>
struct TileSrc {
  int key[COPY_ROWS];
  int scale_key;
  int t0;       // the tile's first logical slot
  int n;        // valid slots in the tile
  bool append;  // from the append buffer, not the cache
};

template <class G, typename Slots>
__device__ __forceinline__ TileSrc<G::COPY_ROWS> tile_src(const Slots& slots, int t0, int n, bool append) {
  const int tid = threadIdx.x;
  TileSrc<G::COPY_ROWS> src;
#pragma unroll
  for (int i = 0; i < G::COPY_ROWS; ++i) {
    const int r = tid / G::CH + i * (THREADS / G::CH);
    src.key[i] = r < n && !append ? slots.key(t0 + r) : 0;
  }
  const int r = tid & (TILE - 1);
  src.scale_key = r < n && !append ? slots.key(t0 + r) : 0;
  src.t0 = t0;
  src.n = n;
  src.append = append;
  return src;
}

// Stage a tile into `st` by cp.async from bases kp/vp (HD bytes a slot);
// rows >= n are zero-filled.  Returns this thread's scale for the tile
// (thread tid < TILE: kscale of row tid, else vscale of row tid - TILE;
// 0 past n), which the caller stores a tile later.
template <class G, typename Slots>
__device__ __forceinline__ float issue_tile(typename G::Stage& st, const TileSrc<G::COPY_ROWS>& src,
                                            const Slots& slots, const int8_t* kp, const int8_t* vp,
                                            const __nv_bfloat16* ksp, const __nv_bfloat16* vsp) {
  const int tid = threadIdx.x;
  auto slot = [&](int key, int r) { return src.append ? (size_t)r : slots.slot(key, src.t0 + r); };
#pragma unroll
  for (int i = 0; i < G::COPY_ROWS; ++i) {
    const int r = tid / G::CH + i * (THREADS / G::CH), cc = tid % G::CH;
    const bool ok = r < src.n;
    const size_t off = ok ? slot(src.key[i], r) * G::HD + cc * 16 : 0;
    cp_async_16(st.k + r * G::ROWB + cc * 16, kp + off, ok);
    cp_async_16(st.v + r * G::ROWB + cc * 16, vp + off, ok);
  }
  const int r = tid & (TILE - 1);
  if (r >= src.n) return 0.f;
  const size_t s = slot(src.scale_key, r);
  return __bfloat162float(tid < TILE ? ksp[s] : vsp[s]);
}

// One online-softmax step of this warp over its 16 slots of a staged tile
// of n valid slots.  qa holds the query heads' A fragments: qa[kd][2hb],
// qa[kd][2hb + 1] are head g + 8hb's (a thread's word kd covers head_dim
// KB t + 4kd .. + 3); m[hb] and l[hb] are head g + 8hb's.  The output is
// kept transposed, O^T = V^T P^T (head_dim as rows, heads as columns, so
// no accumulator row is padding): acc[i][hb] holds rows VB g + i and
// VB g + KD + i of head_dim, columns (heads) 8hb + 2t and 8hb + 2t + 1.
template <class G>
__device__ __forceinline__ void online_tile(const typename G::Stage& st, int n,
                                            const uint32_t (&qa)[G::KD][2 * G::HB], float scale,
                                            float (&m)[G::HB], float (&l)[G::HB],
                                            float (&acc)[G::KD][G::HB][4]) {
  constexpr int KD = G::KD, HB = G::HB, KB = G::KB, VB = G::VB, ROWB = G::ROWB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int base = warp * 16;
  if (base >= n) return;  // warp-uniform: none of this warp's slots is valid

  // S = Q K^T over two 8-slot column tiles; the thread with group g gives
  // slot base + 8nt + g's bytes KB t .. KB t + KB - 1 as the B fragments.
  // Rows g are heads g, rows g + 8 heads g + 8 (zero when MAX_G is 8).
  float sc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int8_t* kr = st.k + (base + nt * 8 + g) * ROWB + KB * t;
    uint32_t words[KD];
#pragma unroll
    for (int j = 0; j < KB / 16; ++j) {
      const int4 x = *reinterpret_cast<const int4*>(kr + 16 * j);
      words[4 * j] = (uint32_t)x.x;
      words[4 * j + 1] = (uint32_t)x.y;
      words[4 * j + 2] = (uint32_t)x.z;
      words[4 * j + 3] = (uint32_t)x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t u = words[kd] ^ 0x80808080u;
      uint32_t a[4];
      if constexpr (HB == 1) {
        a[0] = qa[kd][0], a[1] = 0u, a[2] = qa[kd][1], a[3] = 0u;
      } else {
        a[0] = qa[kd][0], a[1] = qa[kd][2], a[2] = qa[kd][1], a[3] = qa[kd][3];
      }
      mma_bf16_16x8x16(sc[nt], a, pack_bf16x2(i8f(u, 0), i8f(u, 1)), pack_bf16x2(i8f(u, 2), i8f(u, 3)));
    }
  }

  // Head g + 8hb's scores at slots base + 8nt + 2t + e (e = 0, 1).
  uint32_t b0[HB], b1[HB];
  float alpha0[HB], alpha1[HB];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) {
    float s[2][2];
    float mx = GAIE_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = base + nt * 8 + 2 * t + e;
        s[nt][e] = j < n ? (sc[nt][2 * hb + e] * scale) * st.kscale[j] : GAIE_NEG_INF;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hb], mx);
    const float alpha = expf(m[hb] - m_new);
    float psum = 0.f, pv[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = base + nt * 8 + 2 * t + e;
        const float p = j < n ? expf(s[nt][e] - m_new) : 0.f;
        psum += p;
        pv[nt][e] = j < n ? p * st.vscale[j] : 0.f;  // rounded to bf16 by the pack below
      }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l[hb] = l[hb] * alpha + psum;
    m[hb] = m_new;
    // P^T's B fragment is this thread's own scores (head g + 8hb, slots
    // 2t, 2t+1 and 2t+8, 2t+9 of the warp's 16); the heads' rescale
    // factors come from the lanes that hold heads 8hb + 2t and 8hb + 2t + 1.
    b0[hb] = pack_bf16x2(pv[0][0], pv[0][1]);
    b1[hb] = pack_bf16x2(pv[1][0], pv[1][1]);
    alpha0[hb] = __shfl_sync(0xffffffffu, alpha, 8 * t);
    alpha1[hb] = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
  }

  // O^T += V^T P^T.  V^T's A fragment for row tile i is bytes VB g + i and
  // VB g + KD + i of slots 2t, 2t+1, 2t+8, 2t+9, so a thread reads VB
  // contiguous bytes of each.
  constexpr int VW = VB / 4;  // words of a slot's VB bytes
  const int8_t* vr = st.v + (base + 2 * t) * ROWB + VB * g;
  uint32_t w[4][VW];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int8_t* row = vr + ((r & 1) + 8 * (r >> 1)) * ROWB;  // slots 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
    for (int j = 0; j < VB / 16; ++j) {
      const int4 x = *reinterpret_cast<const int4*>(row + 16 * j);
      w[r][4 * j] = (uint32_t)x.x ^ 0x80808080u;
      w[r][4 * j + 1] = (uint32_t)x.y ^ 0x80808080u;
      w[r][4 * j + 2] = (uint32_t)x.z ^ 0x80808080u;
      w[r][4 * j + 3] = (uint32_t)x.w ^ 0x80808080u;
    }
  }
#pragma unroll
  for (int i = 0; i < KD; ++i) {
    // Byte i of the first VB / 2 (row VB g + i) and of the next (row VB g + KD + i).
    const int lo = i >> 2, hi = (KD + i) >> 2, e = i & 3;
    uint32_t a[4];
    a[0] = pack_bf16x2(i8f(w[0][lo], e), i8f(w[1][lo], e));
    a[1] = pack_bf16x2(i8f(w[0][hi], e), i8f(w[1][hi], e));
    a[2] = pack_bf16x2(i8f(w[2][lo], e), i8f(w[3][lo], e));
    a[3] = pack_bf16x2(i8f(w[2][hi], e), i8f(w[3][hi], e));
#pragma unroll
    for (int hb = 0; hb < HB; ++hb) {
      acc[i][hb][0] *= alpha0[hb];
      acc[i][hb][1] *= alpha1[hb];
      acc[i][hb][2] *= alpha0[hb];
      acc[i][hb][3] *= alpha1[hb];
      mma_bf16_16x8x16(acc[i][hb], a, b0[hb], b1[hb]);
    }
  }
}

// The whole block: this split's tiles of one (row, kv head), then the
// cluster's combine.  q: the group's G query heads (G x HD bf16); kb/vb,
// ksb/vsb: the row's cache bases, logical slot t at offset slots.slot(..);
// kab/vab/ksab/vsab: the row's append slab (nullptr: none), count valid;
// out: the group's G output heads.
template <int HD, int MAX_G, typename Slots>
__device__ __forceinline__ void run_block(const __nv_bfloat16* q, int G, const int8_t* kb, const int8_t* vb,
                                          const __nv_bfloat16* ksb, const __nv_bfloat16* vsb, const Slots& slots,
                                          int n_cache, const int8_t* kab, const int8_t* vab,
                                          const __nv_bfloat16* ksab, const __nv_bfloat16* vsab, int count,
                                          float scale, __nv_bfloat16* out) {
  using Gm = Geo<HD, MAX_G>;
  constexpr int KD = Gm::KD, HB = Gm::HB, KB = Gm::KB, VB = Gm::VB;
  typename Gm::Smem& sm = block_smem<HD, MAX_G>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.z, splits = gridDim.z;

  // Query heads as A fragments (rows g + 8hb < G; the others are zero).
  uint32_t qa[KD][2 * HB];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) {
    const int row = g + 8 * hb;
    const int4* qr = reinterpret_cast<const int4*>(q + row * HD + KB * t);
#pragma unroll
    for (int i = 0; i < KB / 8; ++i) {
      const int4 x = row < G ? qr[i] : make_int4(0, 0, 0, 0);
      qa[2 * i][2 * hb] = x.x;
      qa[2 * i][2 * hb + 1] = x.y;
      qa[2 * i + 1][2 * hb] = x.z;
      qa[2 * i + 1][2 * hb + 1] = x.w;
    }
  }

  // This split's tiles: logical tiles split, split + splits, ... of the
  // cache's n_ct tiles and then the append buffer (logical tile n_ct).
  const int n_ct = (n_cache + TILE - 1) / TILE;
  const int total = n_ct + (kab != nullptr && count > 0 ? 1 : 0);
  const int n_mine = total > split ? (total - split + splits - 1) / splits : 0;
  auto src_of = [&](int it) {
    const int gi = split + it * splits;
    return gi < n_ct ? tile_src<Gm>(slots, gi * TILE, min(TILE, n_cache - gi * TILE), false)
                     : tile_src<Gm>(slots, 0, count, true);
  };
  auto issue = [&](const TileSrc<Gm::COPY_ROWS>& src, typename Gm::Stage& st) {
    return src.append ? issue_tile<Gm>(st, src, slots, kab, vab, ksab, vsab)
                      : issue_tile<Gm>(st, src, slots, kb, vb, ksb, vsb);
  };

  float m[HB], l[HB];
  float acc[KD][HB][4];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) {
    m[hb] = GAIE_NEG_INF;
    l[hb] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int hb = 0; hb < HB; ++hb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][hb][i] = 0.f;

  float s_cur = 0.f, s_nxt = 0.f;
  int n_cur = 0, n_nxt = 0;
  if (n_mine > 0) {
    const TileSrc<Gm::COPY_ROWS> src = src_of(0);
    s_cur = issue(src, sm.ring[0]);
    n_cur = src.n;
    cp_async_commit();
  }
  if (n_mine > 1) {
    const TileSrc<Gm::COPY_ROWS> src = src_of(1);
    s_nxt = issue(src, sm.ring[1]);
    n_nxt = src.n;
    cp_async_commit();
  }
  for (int it = 0; it < n_mine; ++it) {
    typename Gm::Stage& st = sm.ring[it & 1];
    // Tile it + 2's addresses (page-table reads) are in flight during
    // this tile's math.
    TileSrc<Gm::COPY_ROWS> ahead;
    if (it + 2 < n_mine) ahead = src_of(it + 2);
    // The stage's previous tile was done at the end of iteration it - 2.
    (tid < TILE ? st.kscale[tid] : st.vscale[tid - TILE]) = s_cur;
    s_cur = s_nxt;
    const int n = n_cur;
    n_cur = n_nxt;
    if (it + 1 < n_mine)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    online_tile<Gm>(st, n, qa, scale, m, l, acc);
    __syncthreads();
    if (it + 2 < n_mine) {
      s_nxt = issue(ahead, st);
      n_nxt = ahead.n;
      cp_async_commit();
    }
  }

  // Warp partials (the ring is drained and every warp is past it).
  typename Gm::Partials& P = sm.fin;
#pragma unroll
  for (int hb = 0; hb < HB; ++hb)
    if (g + 8 * hb < G && t == 0) {
      P.m[warp][g + 8 * hb] = m[hb];
      P.l[warp][g + 8 * hb] = l[hb];
    }
#pragma unroll
  for (int hb = 0; hb < HB; ++hb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = 8 * hb + 2 * t + e;
      if (h < G) {
#pragma unroll
        for (int i = 0; i < KD; ++i) {
          P.acc[warp][h][VB * g + i] = acc[i][hb][e];
          P.acc[warp][h][VB * g + KD + i] = acc[i][hb][2 + e];
        }
      }
    }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += THREADS) {
    const int h = idx / HD, d = idx % HD;
    float M = GAIE_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, P.m[w][h]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(P.m[w][h] - M);
      a += P.acc[w][h][d] * f;
      L += P.l[w][h] * f;
    }
    P.block_acc[h][d] = a;
    if (d == 0) {
      P.block_m[h] = M;
      P.block_l[h] = L;
    }
  }
  cluster_sync();

  // The cluster's blocks are this row's splits (cluster rank = split); each
  // writes a slice of the outputs, combining the splits in split order.
  const uint32_t acc_local = smem_u32(&P.block_acc[0][0]);
  const uint32_t m_local = smem_u32(&P.block_m[0]);
  const uint32_t l_local = smem_u32(&P.block_l[0]);
  for (int idx = split * THREADS + tid; idx < G * HD; idx += splits * THREADS) {
    const int h = idx / HD;
    float M = GAIE_NEG_INF;
    for (int z = 0; z < splits; ++z) M = fmaxf(M, ld_cluster_f32(cluster_map(m_local + h * 4, z)));
    float a = 0.f, L = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float f = expf(ld_cluster_f32(cluster_map(m_local + h * 4, z)) - M);
      a += ld_cluster_f32(cluster_map(acc_local + idx * 4, z)) * f;
      L += ld_cluster_f32(cluster_map(l_local + h * 4, z)) * f;
    }
    out[idx] = __float2bfloat16_rn(a / fmaxf(L, 1e-30f));
  }
  // No block leaves while another may still read its shared memory.
  cluster_sync();
}

// Launches `kernel` on (B, KH, splits) blocks of THREADS threads, each
// (row, kv head)'s splits one cluster, with `dyn_smem` bytes of dynamic
// shared memory (the caller has raised the kernel's limit to it).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int B, int KH, int splits, int dyn_smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, KH, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn_smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = splits;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` (once per
// instance: the static lives in each instantiation of the caller's
// template) and returns the cudaError_t of doing so.
template <typename... Params>
int allow_dynamic_smem(void (*kernel)(Params...), int bytes) {
  if (bytes == 0) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// An instance: its geometry and the blocks an SM its kernels are bounded for.
template <int HD_, int MAX_G_, int MIN_BLOCKS_>
struct Instance {
  static constexpr int HD = HD_, MAX_G = MAX_G_, MIN_BLOCKS = MIN_BLOCKS_;
};

// Returns f(Instance<...>{}) for the instance that serves head_dim `hd` at
// G query heads a kv head (the smallest that holds it), or
// cudaErrorInvalidValue when none does.  ops/_cuda.py::DECODE_INSTANCES
// lists the same (HD, MAX_G) pairs.
template <typename F>
int with_instance(int hd, int G, F&& f) {
  if (hd == 128 && G <= 8) return f(Instance<128, 8, 4>{});
  if (hd == 128 && G <= 16) return f(Instance<128, 16, 2>{});
  if (hd == 256 && G <= 8) return f(Instance<256, 8, 2>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode_tile
