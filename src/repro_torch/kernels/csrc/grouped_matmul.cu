// Grouped (per-expert) matmul for Hopper (sm_90a): the MoE expert FFN.
//
// Replaces the TPU kernel `grouped_matmul_kernel`
// (src/repro/kernels/grouped_matmul/kernel.py, body `_gmm_kernel`).
//
// What it computes: rows x (T, D) bf16 sorted by group, group g holding
// sizes[g] consecutive rows (or `uniform` rows each when sizes is NULL),
// times the weight slab of the group's expert e = g % E, w (E, D, F) bf16:
//   y[r, :] = x[r, :] @ w[e(r)]            (bf16 products summed in f32)
// y is (T, F) f32.  Rows past the last group are written as 0; an empty
// group has no rows.  With n_groups == E this is the reference's grouped
// matmul; the capacity-bucket layout of a batch (B, E, C, D) is
// n_groups = B * E groups of C rows each.
//
// What bounds it on the H100: at the main path's shapes (granite-moe, the
// 1023-token admission: T = 40 * 256 rows, D x F = 1536 x 512 or 512 x
// 1536) a launch does 16.1 GFLOP against ~115-136 MB of operands, ~120-140
// flop/byte, below the card's ~295: device-memory bytes bound it (~34-41
// us), and the bf16 tensor cores are the only way to come near that.  What
// the design does about it: the products run on the tensor cores through
// `nvcuda::wmma` (bf16 16x16x16 fragments, f32 accumulators), each block
// computes a 64 x 64 output tile of ONE group, so its weight slab is read
// once per row tile and each x row once per column tile, and the operand
// tiles reach shared memory through a two-stage `cp.async` pipeline (the
// next K step's loads overlap this step's products).  Not the TPU grid:
// the Pallas kernel takes a host-built row-tile -> expert map and needs
// every group padded to its tile height; here each block finds its own
// (group, row tile) by a scan over the group sizes (<= a few hundred ints,
// from L1/L2), and a ragged group end is masked, so the tile height does
// not have to divide the capacity C (24, 40, 72, 136 on the main path).
// `wgmma`, TMA and a persistent schedule are later work.
//
// Requirements (checked by the wrapper): D % 8 == 0, F % 8 == 0, all
// pointers 16-byte aligned and tensors contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;            // output rows per block
constexpr int kBN = 64;            // output columns per block
constexpr int kBK = 32;            // reduction depth per pipeline stage
constexpr int kThreads = 128;      // 4 warps, each a 32 x 32 sub-tile
constexpr int kLdA = kBK + 8;      // padded smem strides (bf16 / f32
constexpr int kLdB = kBN + 8;      // elements), multiples of 8 and 4 as
constexpr int kLdC = kBN + 4;      // wmma requires

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading global memory
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void grouped_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ sizes, float* __restrict__ y, int T, int D, int F,
    int E, int n_groups, int uniform) {
  __shared__ __align__(128) __nv_bfloat16 a_s[2][kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 b_s[2][kBK * kLdB];
  __shared__ __align__(128) float c_s[kBM * kLdC];
  __shared__ int tile[3];            // expert (-1: rows past all groups), r0, r1

  const int tid = threadIdx.x;
  if (tid == 0) {
    // which (group, row tile) this block is: walk the groups' tile counts
    int t = blockIdx.x, off = 0, expert = -1, r0 = 0, r1 = 0;
    for (int g = 0; g < n_groups; ++g) {
      const int s = sizes ? max(sizes[g], 0) : uniform;
      const int nt = (s + kBM - 1) / kBM;
      if (t < nt) {
        expert = g % E;
        r0 = off + t * kBM;
        r1 = min(r0 + kBM, off + s);
        break;
      }
      t -= nt;
      off += s;
    }
    if (expert < 0) {                // a tile of the rows past all groups
      r0 = off + t * kBM;
      r1 = r0 + kBM;
    }
    tile[0] = expert;
    tile[1] = min(r0, T);
    tile[2] = min(r1, T);
  }
  __syncthreads();
  const int expert = tile[0], r0 = tile[1], r1 = tile[2];
  const int n0 = blockIdx.y * kBN;
  if (r0 >= r1) return;

  if (expert < 0) {
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = r0 + i / kBN, c = n0 + i % kBN;
      if (r < r1 && c < F) y[(size_t)r * F + c] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* wb = w + (size_t)expert * D * F;
  auto load = [&](int stage, int k0) {
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = r0 + r < r1 && k0 + c < D;
      cp_async16(&a_s[stage][r * kLdA + c],
                 ok ? x + (size_t)(r0 + r) * D + k0 + c : x, ok);
    }
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < D && n0 + c < F;
      cp_async16(&b_s[stage][r * kLdB + c],
                 ok ? wb + (size_t)(k0 + r) * F + n0 + c : w, ok);
    }
    cp_async_commit();
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (D + kBK - 1) / kBK;
  if (nk > 0) load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait<1>();            // stage kt has landed, kt+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = a_s[kt & 1];
    const __nv_bfloat16* bs = b_s[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kLdB + wn + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();                 // the next load overwrites this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm + i * 16) * kLdC + wn + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    if (r0 + r < r1 && n0 + c < F)
      y[(size_t)(r0 + r) * F + n0 + c] = c_s[r * kLdC + c];
  }
}

}  // namespace

// sizes == NULL: n_groups groups of `uniform` rows each (T == n_groups *
// uniform).  Otherwise sizes (n_groups,) int32 on the device; their sum may
// be below T (the rest is written as 0).
extern "C" int grouped_matmul_bf16(const void* x, const void* w,
                                   const void* sizes, void* y, int T, int D,
                                   int F, int E, int n_groups, int uniform,
                                   void* stream) {
  // every row tile: sum over groups of ceil(size / kBM), plus the tiles of
  // the rows past all groups, is at most ceil(T / kBM) + n_groups + 1
  const long long tiles =
      sizes ? (long long)(T + kBM - 1) / kBM + n_groups + 1
            : (long long)n_groups * ((uniform + kBM - 1) / kBM);
  if (tiles == 0 || F == 0) return 0;  // no rows or no columns: no launch
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, (F + kBN - 1) / kBN);
  grouped_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)sizes,
      (float*)y, T, D, F, E, n_groups, uniform);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
