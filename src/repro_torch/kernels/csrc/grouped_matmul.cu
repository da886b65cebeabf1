// Grouped (per-expert) matmul on Hopper's tensor cores (sm_90a): wgmma + TMA.
//
// Replaces the TPU kernel `grouped_matmul_kernel`
// (src/repro/kernels/grouped_matmul/kernel.py, body `_gmm_kernel`).
//
// What it computes: rows x (T, D) bf16 sorted by group, group g holding
// sizes[g] consecutive rows (or `uniform` rows each when sizes is NULL),
// times the weight slab of the group's expert e = g % E, w (E, D, F) bf16:
//   y[r, :] = x[r, :] @ w[e(r)]            (bf16 products summed in f32)
// y is (T, F) f32.  Rows past the last group are written as 0 without being
// read; an empty group has no rows.  With n_groups == E this is the
// reference's grouped matmul; the capacity-bucket layout of a batch
// (B, E, C, D) is n_groups = B * E groups of C rows each.
//
// What bounds it on the H100: device-memory bytes.  At the main path's
// shapes (granite-moe, the 1023-token admission: T = 40 * 256 rows, D x F =
// 1536 x 512 or 512 x 1536) a launch does 16.1 GFLOP against ~115-136 MB
// of operands, ~120-140 flop/byte, below the card's ~295 (bound ~34-41 us).
// The weights, 63 MB, are most of the bytes and do not fit the 50 MB L2.
// What the design does about it:
//  - output tiles of 128 x kBN of ONE group, walked by persistent CTAs
//    (CTA b takes tiles b, b + grid, ...), two an SM, or one an SM with a
//    deeper ring where that fills the last round of tiles better: two
//    consumer warpgroups of 64 rows each issue `wgmma.mma_async` m64nNk16
//    with both
//    operands in shared memory (A = x rows, K-major; B = w[e] stored K rows
//    by F contiguous, an MN-major operand read through the transpose bit)
//    and keep the f32 accumulators in registers until the epilogue writes
//    them straight to y;
//  - one producer warp keeps a ring of kStages 64-deep K steps in flight
//    with TMA (cp.async.bulk.tensor, 128-byte swizzle, completion on
//    mbarriers), one ring across the CTA's tiles, so the next tile's loads
//    go out during this one's last steps and epilogue (a fresh CTA waited
//    ~3 us for its first data); the consumers keep one step's wgmmas in
//    flight while the next is issued, and two CTAs share an SM;
//  - tiles are numbered group by group, and inside a group column tile by
//    column tile with the row tiles innermost: the row tiles that share one
//    (expert, column tile) weight slab run side by side, so the slab comes
//    from DRAM once, and a group's x rows stay in L2 while its column tiles
//    pass;
//  - no group is padded: the A operand comes through a 3-D tensor map, (G,
//    C, D) for the bucket layout, where rows >= C of a group read as zeros,
//    or (1, T, D) for ragged sizes, where a box that starts inside a group
//    may read the next group's rows (bytes, never stored); rows past T and
//    columns past D or F are TMA's zero fill.  The epilogue masks each row
//    against its group's end and T, each column against F.
// Each thread finds a tile's (group, column tile, row tile) from its index:
// a division for the bucket layout, a scan over the group sizes (<= a few
// hundred ints) for ragged sizes, where the tiles past all groups write
// their rows as 0.
//
// Requirements (checked by the wrapper): D % 8 == 0, F % 8 == 0, x and w
// 16-byte aligned and contiguous (TMA's 16-byte strides and base).

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                 // output rows per CTA
constexpr int kBN = 128;                 // output columns per CTA: 64, 128, 256
constexpr int kBK = 64;                  // K per stage: one 128-byte row
constexpr int kConsumers = 256;          // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 32;     // + one producer warp
constexpr int kAcc = kBN / 2;                 // f32 accumulators a thread
constexpr int kPanelBytes = 64 * kBK * 2;     // 64 rows x 128 bytes, swizzled
constexpr int kABytes = kBM * kBK * 2;        // 16 KB: 128 x rows
constexpr int kBBytes = kBK * kBN * 2;        // kBN / 64 64-column panels
constexpr int kStageBytes = kABytes + kBBytes;

// A kernel instance: a TMA ring of S K steps per CTA, for M CTAs an SM
// (registers capped to fit them); the barriers follow the ring.
template <int S, int M>
struct Ring {
  static constexpr int kStages = S, kMinBlocks = M;
  static constexpr int kBar = S * kStageBytes;
  static constexpr int kSmemBytes = kBar + 16 * S + 1024;  // + alignment
};
using TwoPerSm = Ring<3, 2>;   // one CTA's epilogue beside the other's loads
using OnePerSm = Ring<4, 1>;   // a deeper ring where one CTA an SM fills
                               // the last round of tiles better

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem,
// MN-major: the transpose bit)
#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define WG_OUT8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_OUT8(d, 0), WG_OUT8(d, 8), WG_OUT8(d, 16), WG_OUT8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem,
// MN-major: the transpose bit)
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : WG_OUT8(d, 0), WG_OUT8(d, 8), WG_OUT8(d, 16), WG_OUT8(d, 24),
        WG_OUT8(d, 32), WG_OUT8(d, 40), WG_OUT8(d, 48), WG_OUT8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

// One 16-deep k-slice of the warpgroup's 64 x kBN tile: A at da, B's
// k-slice at b (kBN / 64 panels kPanelBytes apart).
__device__ __forceinline__ void mma_k16(float (&acc)[kAcc], uint64_t da,
                                        uint32_t b) {
  if constexpr (kBN == 64) {
    wgmma_n64(*reinterpret_cast<float(*)[32]>(acc), da,
              sw128_desc(b, kPanelBytes));
  } else {
#pragma unroll
    for (int ni = 0; ni < kBN / 128; ++ni)
      wgmma_n128(*reinterpret_cast<float(*)[64]>(acc + 64 * ni), da,
                 sw128_desc(b + 2 * ni * kPanelBytes, kPanelBytes));
  }
}

// Keeps the compiler from touching the accumulators across an async wgmma.
__device__ __forceinline__ void reg_fence(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One 3-D box: (c0, r0, g) of a (g, rows, columns) bf16 tensor map.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int r0,
                                            int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
        "r"(g), "r"(bar) : "memory");
}

// Which output tile CTA `idx` computes.  expert >= 0: rows [r0, r1) of y
// (one group's), their A box at (row a_row, group a_grp) of the x map;
// expert == -1: rows [r0, r1) past all groups, written as 0; -2: no tile.
struct Tile {
  int expert, r0, r1, a_row, a_grp, n0;
};

__device__ Tile find_tile(int idx, const int* __restrict__ sizes, int T,
                          int E, int n_groups, int uniform, int n_cols) {
  Tile t{-2, 0, 0, 0, 0, 0};
  if (sizes == nullptr) {            // bucket layout: n_groups x uniform rows
    const int nt = (uniform + kBM - 1) / kBM;
    const int g = idx / (nt * n_cols), rem = idx % (nt * n_cols);
    const int m = rem % nt;
    t.expert = g % E;
    t.n0 = (rem / nt) * kBN;
    t.r0 = g * uniform + m * kBM;
    t.r1 = min(t.r0 + kBM, (g + 1) * uniform);
    t.a_row = m * kBM;
    t.a_grp = g;
    return t;
  }
  int off = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int s = max(sizes[g], 0);
    const int n = ((s + kBM - 1) / kBM) * n_cols;
    if (idx < n) {
      const int nt = n / n_cols, m = idx % nt;
      t.expert = g % E;
      t.n0 = (idx / nt) * kBN;
      t.r0 = min(off + m * kBM, T);
      t.r1 = min(min(off + m * kBM + kBM, off + s), T);
      t.a_row = t.r0;
      return t;
    }
    idx -= n;
    off += s;
  }
  const int nt = off < T ? (T - off + kBM - 1) / kBM : 0;   // rows past all
  if (idx < nt * n_cols) {                                   // groups
    t.expert = -1;
    t.n0 = (idx / nt) * kBN;
    t.r0 = off + (idx % nt) * kBM;
    t.r1 = min(t.r0 + kBM, T);
  }
  return t;
}

template <class Ring>
__global__ void __launch_bounds__(kThreads, Ring::kMinBlocks)
grouped_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const int* __restrict__ sizes, float* __restrict__ y,
                      int T, int D, int F, int E, int n_groups, int uniform,
                      int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  constexpr int kStages = Ring::kStages;
  auto bar_full = [&](int s) { return s_base + Ring::kBar + 8 * s; };
  auto bar_empty = [&](int s) {
    return s_base + Ring::kBar + 8 * (kStages + s);
  };

  const int tid = threadIdx.x;
  const int n_cols = (F + kBN - 1) / kBN;
  const int nk = (D + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // every thread walks the CTA's tiles blockIdx.x, + gridDim.x, ... and
  // finds each itself; a tile's K steps are loaded iff it has rows of a group
  auto tile_of = [&](int idx) {
    return find_tile(idx, sizes, T, E, n_groups, uniform, n_cols);
  };

  if (tid >= kConsumers) {
    // ---- producer: every tile's K steps in order, one ring across tiles,
    // so the next tile's loads start while this one's epilogue runs ----
    if (tid == kConsumers) {
      int it = 0;                      // K steps issued so far
      for (int idx = blockIdx.x; idx < n_tiles; idx += gridDim.x) {
        const Tile t = tile_of(idx);
        if (t.expert < 0 || t.r0 >= t.r1) continue;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(bar_empty(s), (it / kStages - 1) & 1);
          mbar_expect_tx(bar_full(s), kStageBytes);
          const uint32_t st = s_base + s * kStageBytes;
          tma_load_3d(st, &tm_x, bar_full(s), kt * kBK, t.a_row, t.a_grp);
          for (int p = 0; p < kBN / 64; ++p)
            tma_load_3d(st + kABytes + p * kPanelBytes, &tm_w, bar_full(s),
                        t.n0 + 64 * p, kt * kBK, t.expert);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ----
  const int wg = tid / 128, lane = tid % 32;
  int it = 0;                          // K steps consumed so far
  for (int idx = blockIdx.x; idx < n_tiles; idx += gridDim.x) {
    const Tile t = tile_of(idx);
    if (t.expert == -2 || t.r0 >= t.r1) continue;
    if (t.expert < 0) {                // rows past all groups: zeros, unread
      const int cols = min(kBN, F - t.n0) / 4;
      for (int i = tid; i < (t.r1 - t.r0) * cols; i += kConsumers) {
        const int r = t.r0 + i / cols, c = t.n0 + 4 * (i % cols);
        *reinterpret_cast<float4*>(y + (size_t)r * F + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full(s), (it / kStages) & 1);
      const uint32_t a = s_base + s * kStageBytes + wg * kPanelBytes;
      const uint32_t b = s_base + s * kStageBytes + kABytes;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma_k16(acc, sw128_desc(a + 32 * kk, 16), b + kk * 16 * 128);
      wgmma_commit();
      wgmma_wait1();                   // the previous step's products are
      reg_fence(acc);                  // done: its stage goes back
      if (kt > 0) mbar_arrive(bar_empty((it - 1) % kStages));
    }
    wgmma_wait0();
    reg_fence(acc);
    if (nk > 0) mbar_arrive(bar_empty((it - 1) % kStages));

    // epilogue: the fragment's rows r and r + 8, column pairs, masked to
    // the group's rows and to F
    const int row = t.r0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int col = t.n0 + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= t.r1) continue;
      float* yr = y + (size_t)r * F;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = col + 8 * j;
        if (c < F)
          *reinterpret_cast<float2*>(yr + c) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

// A 3-D bf16 map (groups, rows, cols), boxes of 64 columns x box_rows rows of
// one group, 128-byte swizzle; out-of-range rows and columns read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int groups, int rows,
              int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device, read once per device.
cudaError_t sm_count(int* n) {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *n = counts[dev & 63].load(std::memory_order_relaxed);
  if (*n > 0) return cudaSuccess;
  e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) counts[dev & 63].store(*n, std::memory_order_relaxed);
  return e;
}

// Dynamic shared memory above 48 KB is opted into once per device.
template <class Ring>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(grouped_matmul_kernel<Ring>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Ring::kSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <class Ring>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const void* sizes,
           void* y, int T, int D, int F, int E, int n_groups, int uniform,
           long long tiles, long long ctas, void* stream) {
  cudaError_t e = allow_smem<Ring>();
  if (e != cudaSuccess) return (int)e;
  grouped_matmul_kernel<Ring><<<(unsigned)ctas, kThreads, Ring::kSmemBytes,
                                (cudaStream_t)stream>>>(
      tx, tw, (const int*)sizes, (float*)y, T, D, F, E, n_groups, uniform,
      (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// sizes == NULL: n_groups groups of `uniform` rows each (T == n_groups *
// uniform).  Otherwise sizes (n_groups,) int32 on the device; their sum may
// be below T (the rest is written as 0).
extern "C" int grouped_matmul_bf16(const void* x, const void* w,
                                   const void* sizes, void* y, int T, int D,
                                   int F, int E, int n_groups, int uniform,
                                   void* stream) {
  if (T <= 0 || F <= 0) return 0;    // no rows or no columns: no launch
  const long long n_cols = (F + kBN - 1) / kBN;
  // every row tile: sum over groups of ceil(size / kBM), plus the tiles of
  // the rows past all groups, is at most ceil(T / kBM) + n_groups + 1
  const long long tiles =
      n_cols * (sizes ? (long long)(T + kBM - 1) / kBM + n_groups + 1
                      : (long long)n_groups * ((uniform + kBM - 1) / kBM));
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tx, tw;
  const bool ok = sizes ? make_map(&tx, x, 1, T, D, kBM)
                        : make_map(&tx, x, n_groups, uniform, D, kBM);
  if (!ok || !make_map(&tw, w, E, D, F, kBK)) return (int)cudaErrorInvalidValue;
  int n_sm = 0;
  const cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return (int)e;
  // persistent CTAs, each walking tiles blockIdx.x, + gridDim.x, ...: two
  // an SM, or one an SM with a deeper ring where that leaves the last
  // round of tiles fuller (320 tiles: 2.4 rounds of 132 beat 1.2 of 264)
  auto fill = [&](long long w) {
    return (double)tiles / ((double)((tiles + w - 1) / w) * w);
  };
  const long long two = 2LL * n_sm;
  if (fill(n_sm) > fill(two) + 0.05)
    return launch<OnePerSm>(tx, tw, sizes, y, T, D, F, E, n_groups, uniform,
                            tiles, n_sm < tiles ? n_sm : tiles, stream);
  return launch<TwoPerSm>(tx, tw, sizes, y, T, D, F, E, n_groups, uniform,
                          tiles, two < tiles ? two : tiles, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
