// W8A8 matmul: out = fold(xq @ w^T) for int8 activations and weights.
//
// Replaces ops/qmm.py::_qmm_pallas (kernel _qmm_kernel) of the JAX package.
//
// Inputs: xq (M, K_pad) int8 row-major, a_scale (M,) f32 per-token scales,
// w (N_pad, K_pad) int8 K-contiguous (the port's Hopper layout, made once at
// load by ops/qmm.py::block_matrix; K_pad a multiple of 128, N_pad of 64),
// w_scale (N_pad,) f32 per-channel scales.  Output (M, n_out) bf16 or f32.
//
// Two designs behind the one entry point, chosen by M:
//
// * Decode (M <= 64) is bound by device-memory bytes: it streams the int8
//   weight once and does little arithmetic per byte.  A and B are swapped:
//   a block owns 128 output channels, which are wgmma's 64-row operand
//   (two m64 products), and the M tokens are its narrow N side, rounded up
//   to 8/16/32/64.  One producer warp keeps a ring of 128-byte K steps
//   (weight tile + token tile) in flight with TMA (128-byte swizzle,
//   mbarriers); one consumer warpgroup runs wgmma s8 on each step.  Split-K
//   fills the card: the K steps are shared among a thread-block cluster of
//   `split` blocks (<= 8, ops/qmm.py::qmm_plan picks it so every Llama-3-8B
//   projection launches at least 132 blocks).  Each block leaves its int32
//   partial tile in its shared memory; after a cluster barrier each block
//   sums a slice of the tile over the cluster's shared memory and folds it.
//   No state outlives the launch.
// * Wide (M > 64) is bound by the int8 tensor-core rate at prefill M.  A
//   block owns a 128 x BN output tile (BN = 256 where those tiles fill the
//   card, else 128): one producer warp feeds a TMA ring (4 or 6 stages) of
//   128-byte K steps of the activation and weight tiles, two consumer
//   warpgroups each run wgmma m64nBNk32 s8 on 64 rows, one wgmma group in
//   flight behind the next.  Blocks walk M fastest, so the blocks in flight
//   share each weight tile through L2 and the weight is read from memory
//   once.
//
// Ragged edges (M rows, N_pad not a multiple of 128) come in as zeros from
// the TMA box's out-of-bounds fill and are masked at the store.
//
// The int32 accumulator is exact in any order (|acc| <= 127^2 * K < 2^31),
// so wgmma chains and the split-K sum give the integer the plain version
// gives.  The epilogue applies the reference's _fold expression once, after
// the whole K reduction: ((float)acc * a_scale) * w_scale rounded once to
// the output type, written with __int2float_rn and two __fmul_rn in that
// order, so the result is bit-identical to the plain PyTorch version.
#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BK = 128;           // K bytes per pipeline step: one 128-byte swizzle row
constexpr int TILE_N = 128;       // output channels per block (both designs)
constexpr int TILE_BYTES = 128 * BK;
constexpr int DECODE_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int WIDE_THREADS = 288;    // up to two consumer warpgroups + one producer warp
constexpr int PART_STRIDE = TILE_N + 4;  // int32 row stride of the split-K partial tile

template <bool BF16_OUT>
__device__ __forceinline__ void store_folded(void* out, size_t idx, int acc, float as, float ws) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), as), ws);
  if (BF16_OUT)
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[idx] = v;
}

__device__ __forceinline__ uint8_t* align_smem_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int NX, bool BF16_OUT>
__global__ void __launch_bounds__(DECODE_THREADS, 1)
    qmm_decode(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
               const float* __restrict__ a_scale, const float* __restrict__ w_scale, void* __restrict__ out,
               int M, int n_out, int k_steps, int stages) {
  constexpr int STAGE = TILE_BYTES + NX * BK;
  constexpr int REGS = NX / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem_1024(smem_raw);
  const int ring = max(stages * STAGE, NX * PART_STRIDE * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring);
  uint64_t* empty = full + stages;

  const int split = gridDim.x, r = blockIdx.x;
  const int n0 = blockIdx.y * TILE_N;
  const int base = k_steps / split, rem = k_steps % split;
  const int kb = r * base + min(r, rem);
  const int nsteps = base + (r < rem ? 1 : 0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // Producer warp: one thread issues every load of this block's K range.
    if (tid == 128) {
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_2d(st, &wmap, &full[s], (kb + i) * BK, n0);
        tma_load_2d(st + TILE_BYTES, &xmap, &full[s], (kb + i) * BK, 0);
      }
    }
    __syncwarp();
  } else {
    // Consumer warpgroup: D(128 channels x NX tokens) as two m64 halves.
    int acc[2][REGS];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < REGS; ++i) acc[h][i] = 0;
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* st = smem + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        const uint64_t bx = wgmma_desc_sw128(st + TILE_BYTES, kk);
#pragma unroll
        for (int h = 0; h < 2; ++h) WgmmaS8<NX>::mma(acc[h], wgmma_desc_sw128(st + h * 64 * BK, kk), bx);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) wgmma_fence_operands(acc[h]);
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    // Every wgmma of the warpgroup has read its tiles: the ring becomes the
    // partial tile, [token][channel] with a padded row.
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    int* part = reinterpret_cast<int*>(smem);
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < REGS; ++i) {
        const int ch = h * 64 + warp * 16 + (lane >> 2) + ((i & 2) ? 8 : 0);
        const int tok = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        part[tok * PART_STRIDE + ch] = acc[h][i];
      }
  }
  cluster_sync();

  if (tid < 128) {
    // This block folds its slice of the tile, summing the cluster's partials.
    const uint32_t part_local = smem_u32(smem);
    constexpr int NVEC = NX * TILE_N / 4;
    const int v1 = (r + 1) * NVEC / split;
    for (int v = r * NVEC / split + tid; v < v1; v += 128) {
      const int tok = v / (TILE_N / 4), c4 = (v % (TILE_N / 4)) * 4;
      if (tok >= M) continue;
      const uint32_t off = part_local + (tok * PART_STRIDE + c4) * 4;
      int4 sum = make_int4(0, 0, 0, 0);
      for (int q = 0; q < split; ++q) {
        const int4 t = ld_cluster_v4(cluster_map(off, q));
        sum.x += t.x;
        sum.y += t.y;
        sum.z += t.z;
        sum.w += t.w;
      }
      const float as = a_scale[tok];
      const int sums[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + c4 + e;
        if (col < n_out) store_folded<BF16_OUT>(out, (size_t)tok * n_out + col, sums[e], as, w_scale[col]);
      }
    }
  }
  // No block leaves while another may still read its shared memory.
  cluster_sync();
}

template <int BM, int BN, bool BF16_OUT>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    qmm_wide(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
             const float* __restrict__ a_scale, const float* __restrict__ w_scale, void* __restrict__ out, int M,
             int n_out, int k_steps, int stages) {
  constexpr int WG = BM / 64;  // consumer warpgroups, 64 rows each
  constexpr int STAGE = (BM + BN) * BK;  // activation tile, then weight tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= WG * 128) {
    if (tid == WG * 128) {
      for (int i = 0; i < k_steps; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_2d(st, &xmap, &full[s], i * BK, m0);
        tma_load_2d(st + BM * BK, &wmap, &full[s], i * BK, n0);
      }
    }
  } else {
    const int g = tid >> 7;  // consumer warpgroup: rows 64g .. 64g + 63 of the tile
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < k_steps; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* st = smem + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32)
        WgmmaS8<BN>::mma(acc, wgmma_desc_sw128(st + g * 64 * BK, kk), wgmma_desc_sw128(st + BM * BK, kk));
      wgmma_commit();
      // The previous step's group is done: release its stage.
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      if (i > 0 && (tid & 127) == 0) mbar_arrive(&empty[(i - 1) % stages]);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + g * 64 + warp * 16 + (lane >> 2) + half * 8;
      if (row >= M) continue;
      const float as = a_scale[row];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + j * 8 + (lane & 3) * 2 + e;
          if (col < n_out)
            store_folded<BF16_OUT>(out, (size_t)row * n_out + col, acc[j * 4 + half * 2 + e], as, w_scale[col]);
        }
    }
  }
}

// ---- host side --------------------------------------------------------------

// Tensor maps by (base, rows, row bytes, box rows).  A map holds only the
// address and shape, so it stays valid for any tensor later placed there;
// weights live for the process, activations recur at the allocator's
// addresses.
std::mutex g_map_mu;
std::map<std::tuple<uintptr_t, int, int, int>, CUtensorMap> g_maps;

int tensor_map(const void* base, int rows, int cols, int box_rows, CUtensorMap* out) {
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(base), rows, cols, box_rows);
  std::lock_guard<std::mutex> lock(g_map_mu);
  auto it = g_maps.find(key);
  if (it != g_maps.end()) {
    *out = it->second;
    return 0;
  }
  if (g_maps.size() >= 4096) g_maps.clear();
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols};
  cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  g_maps.emplace(key, *out);
  return 0;
}

// The launch arguments after the kernel's shape: the same for every kernel.
struct Args {
  CUtensorMap wmap, xmap;
  const float* as;
  const float* ws;
  void* out;
  int M, n_out, k_steps, stages;
};

template <auto KERNEL>
int launch(dim3 grid, int threads, int smem, int cluster, cudaStream_t stream, Args a) {
  // Once per kernel: allow the largest dynamic shared memory.
  static const cudaError_t attr =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  void* args[] = {&a.wmap, &a.xmap, &a.as, &a.ws, &a.out, &a.M, &a.n_out, &a.k_steps, &a.stages};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(KERNEL), args);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int NX>
int launch_decode(bool bf16, dim3 grid, int smem, int split, cudaStream_t s, const Args& a) {
  return bf16 ? launch<qmm_decode<NX, true>>(grid, DECODE_THREADS, smem, split, s, a)
              : launch<qmm_decode<NX, false>>(grid, DECODE_THREADS, smem, split, s, a);
}

template <int BM, int BN>
int launch_wide(bool bf16, dim3 grid, int smem, cudaStream_t s, const Args& a) {
  constexpr int threads = BM / 64 * 128 + 32;
  return bf16 ? launch<qmm_wide<BM, BN, true>>(grid, threads, smem, 1, s, a)
              : launch<qmm_wide<BM, BN, false>>(grid, threads, smem, 1, s, a);
}

}  // namespace

// Tokens at or below which the decode design runs (ops/qmm.py DECODE_MAX_M).
#define QMM_DECODE_MAX_M 64

// Returns the launch's cudaError_t (0 = launched).  `split` (decode: the
// cluster of blocks sharing K), `stages` (ring depth), `tile_m` (tokens per
// block: decode 8/16/32/64 >= M, wide 64 or 128) and `tile_n` (wide: output
// channels per block, 128 or 256) come from ops/qmm.py::qmm_plan.
extern "C" int qmm_launch(const void* xq, const void* a_scale, const void* w, const void* w_scale, void* out, int M,
                          int n_pad, int k_pad, int n_out, int out_bf16, int split, int stages, int tile_m,
                          int tile_n, void* stream) {
  if (M <= 0) return 0;
  const int k_steps = k_pad / BK;
  if (k_pad % BK != 0 || n_pad % 64 != 0 || stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = {{}, {}, static_cast<const float*>(a_scale), static_cast<const float*>(w_scale), out, M, n_out, k_steps,
            stages};
  const int barriers = 2 * stages * 8 + 1024;  // mbarriers + alignment slack
  const bool bf16 = out_bf16 != 0;
  int err;
  if (M <= QMM_DECODE_MAX_M) {
    if (split < 1 || split > 8 || split > k_steps || tile_m < M) return static_cast<int>(cudaErrorInvalidValue);
    if ((err = tensor_map(w, n_pad, k_pad, TILE_N, &a.wmap)) || (err = tensor_map(xq, M, k_pad, tile_m, &a.xmap)))
      return err;
    const int smem = std::max(stages * (TILE_BYTES + tile_m * BK), tile_m * PART_STRIDE * 4) + barriers;
    const dim3 grid(split, (n_pad + TILE_N - 1) / TILE_N);
    switch (tile_m) {
      case 8: return launch_decode<8>(bf16, grid, smem, split, s, a);
      case 16: return launch_decode<16>(bf16, grid, smem, split, s, a);
      case 32: return launch_decode<32>(bf16, grid, smem, split, s, a);
      case 64: return launch_decode<64>(bf16, grid, smem, split, s, a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if ((err = tensor_map(w, n_pad, k_pad, tile_n, &a.wmap)) || (err = tensor_map(xq, M, k_pad, tile_m, &a.xmap)))
    return err;
  const int smem = stages * (tile_m + tile_n) * BK + barriers;
  const dim3 grid((M + tile_m - 1) / tile_m, (n_pad + tile_n - 1) / tile_n);
  if (tile_m == 64 && tile_n == 128) return launch_wide<64, 128>(bf16, grid, smem, s, a);
  if (tile_m == 128 && tile_n == 128) return launch_wide<128, 128>(bf16, grid, smem, s, a);
  if (tile_m == 128 && tile_n == 256) return launch_wide<128, 256>(bf16, grid, smem, s, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
