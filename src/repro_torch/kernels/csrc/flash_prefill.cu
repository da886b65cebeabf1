// Flash attention (prefill) on Hopper's tensor cores (sm_90a): wgmma + TMA.
//
// Replaces the TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_attn_kernel`).
//
// What it computes: causal, sliding-window or non-causal GQA attention
//   out[b,i,h] = softmax_t(q[b,i,h] . k[b,t,kh] * scale) @ v[b,t,kh]
// with kh = h / G, query i at absolute position q_offset + i, and the mask
//   t < t_total  &&  (!causal || t <= pos)  &&  (window <= 0 || t > pos - window).
// Same rounding points as the Pallas body: q, k, p and v are bf16, Q.K and
// P.V are summed in f32, the online softmax is f32 (the unrounded p is
// summed into the normaliser, P.V takes p rounded to bf16), masked scores
// are -1e30 (not -inf) and the normaliser is clamped at 1e-30, so a row
// that sees no key in a tile averages that tile's V until a real score
// rescales it away.  The output is cast to bf16.
//
// What bounds it on the H100: operations.  A causal prefill of S tokens
// does about 2 * S^2 * H * Dh flops against 2 * S * (H + 2K) * Dh bytes; at
// S = 1023 that is ~500 flop/byte, above the card's ~295, so only the bf16
// tensor cores come near the bound.  What the design does about it
// (FlashAttention-3 in miniature):
//  - one CTA per (batch, query head, 64-row query tile), launched last
//    q-tile first (the heaviest causal tiles start first); the G heads of a
//    group share K/V through the L2 cache, not through one CTA;
//  - two consumer warpgroups per CTA take alternate 64-key tiles of the
//    tile's key range, each with its own online softmax, and merge their
//    (m, l, O) at the end: the longest causal chain (16 tiles at S = 1023)
//    is halved, and one warpgroup's softmax overlaps the other's products;
//  - each warpgroup issues `wgmma.mma_async` m64n64k16: S = Q.K^T with both
//    operands in shared memory and S in f32 registers; scale, mask and the
//    online softmax run on that fragment (row max and row sum are two
//    __shfl_xor steps inside a quad); P is packed to bf16 in registers and
//    fed as the register A operand of O += P.V, with V read K-by-N through
//    the B operand's transpose bit; O stays in registers until the merge;
//  - the per-score instructions of the softmax, not the products, set the
//    pace (4096 exponentials per 64 x 64 tile against 8 wgmmas), so scores
//    are kept in log2 units and each p is one FFMA and one `ex2.approx` (an
//    interior tile folds the scale into that FFMA); at Dh = 64 registers
//    are capped so that two CTAs share an SM;
//  - one producer warp keeps a ring of K/V tiles in flight (two per
//    warpgroup; one at Dh = 256) with TMA (cp.async.bulk.tensor, 128-byte
//    swizzle, completion on mbarriers); TMA's out-of-bounds zero fill
//    covers ragged S and T, the position mask still decides validity;
//  - the key loop starts at the window's first tile and stops at the causal
//    bound of the tile's last row; only tiles that cross a bound evaluate
//    the mask.
// Head widths 64, 128 and 256 are instances (one 64-column swizzled panel
// per 64 of Dh); the wrapper zero-pads any other width up to the next one.
//
// Layouts (all contiguous, 16-byte aligned): q (B, S, H, Dh), k/v (B, T, K,
// Dh), out like q, all bf16, Dh one of 64, 128, 256.

#include <cuda_bf16.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64;                 // query rows per CTA (one wgmma M)
constexpr int kBN = 64;                 // keys per K/V tile
constexpr int kWarpgroups = 2;          // consumer warpgroups, alternate tiles
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kPanelBytes = 64 * 64 * 2;    // 64 rows x 64 bf16, 128B swizzle

template <int DH>
struct Smem {
  static constexpr int kPanels = DH / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;   // one Q/K/V tile
  // K/V ring: two tiles in flight per consumer warpgroup (one at Dh = 256,
  // for room); stage s always serves warpgroup s % 2
  static constexpr int kStages = DH <= 128 ? 4 : 2;
  // two CTAs per SM at Dh = 64 (ptxas caps the registers to fit them)
  static constexpr int kMinBlocks = DH == 64 ? 2 : 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;     // 8-byte barriers
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + align
  // after the key loop the ring holds warpgroup 1's O, m and l for the merge
  static constexpr int kXchFloats = 32 * kPanels + 4;
  static_assert(kXchFloats * 4 * 128 <= 2 * kStages * kTileBytes, "merge");
};

// ---- TMA -------------------------------------------------------------------

// One 64 x 64 bf16 box of a (B, rows, heads, Dh) tensor: columns c0..c0+63 of
// head `head`, rows r0..r0+63 of batch b (rows past the end read as zero).
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int head, int r0,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(head),
        "r"(r0), "r"(b), "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {    // 2^x, one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the kernel -------------------------------------------------------------

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// One CTA: the producer warp streams Q and the K/V tiles; consumer
// warpgroup w takes tiles w, w + 2, ... with its own online softmax (m, l,
// O), and warpgroup 0 merges warpgroup 1's state into its own at the end.
// Splitting the key range halves the longest causal tile's chain.
// QK_ONLY: write the raw f32 Q.K^T accumulator of the CTA's first K tile to
// `out` ((rows, 64) f32) and stop; the card test holds the TMA swizzle and
// the wgmma descriptors to torch with it before any softmax runs.
template <int DH, bool QK_ONLY>
__global__ void __launch_bounds__(kThreads, Smem<DH>::kMinBlocks)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     void* __restrict__ out, int S, int H, int K, int causal,
                     int window, int q_offset, int t_total, float scale) {
  using L = Smem<DH>;
  constexpr int P = L::kPanels;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + L::kBar;
  auto bar_full = [&](int s) { return s_base + L::kBar + 8 * (1 + s); };
  auto bar_empty = [&](int s) {
    return s_base + L::kBar + 8 * (1 + kStages + s);
  };

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heaviest tile first
  const int last_i = min(S, q0 + kBM) - 1;
  const int pos_first = q_offset + q0, pos_last = q_offset + last_i;
  int kv_hi = t_total;
  if (causal) kv_hi = min(kv_hi, pos_last + 1);
  const int tile_lo = window > 0 ? max(0, pos_first - window + 1) / kBN : 0;
  int n_tiles = kv_hi > 0 ? (kv_hi + kBN - 1) / kBN - tile_lo : 0;
  if constexpr (QK_ONLY) n_tiles = min(n_tiles, 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: Q once, then the K/V ring in key order ----
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, L::kTileBytes);
      for (int p = 0; p < P; ++p)
        tma_box(s_base + L::kQ + p * kPanelBytes, &tm_q, bar_q, 64 * p, h, q0,
                b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty(s), (j / kStages - 1) & 1);
        mbar_expect_tx(bar_full(s), 2 * L::kTileBytes);
        const int t0 = (tile_lo + j) * kBN;
        for (int p = 0; p < P; ++p) {
          tma_box(s_base + L::kK + s * L::kTileBytes + p * kPanelBytes, &tm_k,
                  bar_full(s), 64 * p, kh, t0, b);
          tma_box(s_base + L::kV + s * L::kTileBytes + p * kPanelBytes, &tm_v,
                  bar_full(s), 64 * p, kh, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;      // this thread's rows r0, r0+8
  const int c_lane = 2 * (lane % 4);            // + 8 * (n8 block) + {0, 1}
  float o[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;   // scores in log2 units: p = 2^(x - m)

  mbar_wait(bar_q, 0);
  for (int j = wg; j < n_tiles; j += kWarpgroups) {
    const int s = j % kStages;
    const int t0 = (tile_lo + j) * kBN;
    mbar_wait(bar_full(s), (j / kStages) & 1);
    const uint32_t k_tile = s_base + L::kK + s * L::kTileBytes;
    const uint32_t v_tile = s_base + L::kV + s * L::kTileBytes;

    // S = Q . K^T over Dh in 16-wide k-slices
    float sc[32];
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(s_base + L::kQ + off, 16),
               sw128_desc(k_tile + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);

    if constexpr (QK_ONLY) {
      float* o32 = static_cast<float*>(out);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = r0 + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + c_lane + (i & 1);
        if (q0 + r < S) o32[(size_t)(q0 + r) * kBN + c] = sc[i];
      }
      return;
    }

    // online softmax in log2 units; only a tile that crosses a bound is
    // masked, an interior tile folds the scale into the exponent's FFMA
    const bool interior = t0 + kBN <= t_total &&
                          (!causal || t0 + kBN - 1 <= pos_first) &&
                          (window <= 0 || t0 > pos_last - window);
    float alpha[2];
    if (interior) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == half) mx = fmaxf(mx, sc[i]);
        mx = fmaxf(m_row[half], quad_max(mx) * scale2);
        alpha[half] = ex2(m_row[half] - mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == half) {
            sc[i] = ex2(fmaf(sc[i], scale2, -mx));
            sum += sc[i];
          }
        l_row[half] = l_row[half] * alpha[half] + sum;   // partial, per quad
        m_row[half] = mx;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int pos = pos_first + r0 + 8 * ((i >> 1) & 1);
        const int key = t0 + 8 * (i >> 2) + c_lane + (i & 1);
        bool valid = key < t_total;
        if (causal) valid = valid && key <= pos;
        if (window > 0) valid = valid && key > pos - window;
        sc[i] = valid ? sc[i] * scale2 : kNegInf;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = m_row[half];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == half) mx = fmaxf(mx, sc[i]);
        mx = quad_max(mx);
        alpha[half] = ex2(m_row[half] - mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == half) {
            sc[i] = ex2(sc[i] - mx);
            sum += sc[i];
          }
        l_row[half] = l_row[half] * alpha[half] + sum;
        m_row[half] = mx;
      }
    }
    // P as the register A operand: k-slice kk holds keys 16kk..16kk+15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      reg_fence(o[p]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p)
        wgmma_rs(o[p], pa[kk],
                 sw128_desc(v_tile + p * kPanelBytes + kk * 16 * 128,
                            kPanelBytes));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int p = 0; p < P; ++p) reg_fence(o[p]);
    mbar_arrive(bar_empty(s));
  }

  if constexpr (!QK_ONLY) {
    // merge warpgroup 1's (m, l, O) into warpgroup 0's through the ring,
    // which every tile has left once both warpgroups are past their loops
    float* xch = reinterpret_cast<float*>(smem + L::kK);
    consumers_sync();
    if (wg == 1) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) xch[(32 * p + i) * 128 + t] = o[p][i];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        xch[(32 * P + half) * 128 + t] = m_row[half];
        xch[(32 * P + 2 + half) * 128 + t] = l_row[half];
      }
    }
    consumers_sync();
    if (wg == 1) return;
    float a1[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m1 = xch[(32 * P + half) * 128 + t];
      const float mx = fmaxf(m_row[half], m1);
      const float a0 = ex2(m_row[half] - mx);
      a1[half] = ex2(m1 - mx);
      l_row[half] = l_row[half] * a0 +
                    xch[(32 * P + 2 + half) * 128 + t] * a1[half];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == half) o[p][i] *= a0;
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[p][i] += xch[(32 * p + i) * 128 + t] * a1[(i >> 1) & 1];

    // epilogue: O / max(l, 1e-30) in bf16, rows past S dropped
    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      inv[half] = 1.f / fmaxf(quad_sum(l_row[half]), 1e-30f);
    __nv_bfloat16* o16 = static_cast<__nv_bfloat16*>(out);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + r0 + 8 * half;
      if (i >= S) continue;
      __nv_bfloat16* row = o16 + (((size_t)b * S + i) * H + h) * DH;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int e = 4 * n8 + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * p + 8 * n8 + c_lane) =
              __floats2bfloat162_rn(o[p][e] * inv[half],
                                    o[p][e + 1] * inv[half]);
        }
    }
  }
}

// ---- host side --------------------------------------------------------------

// (B, rows, heads, dh) bf16 -> boxes of 64 columns x 64 rows, 128B swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
              int dh) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)rows * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory above 48 KB is opted into once per device.
template <int DH, bool QK_ONLY>
cudaError_t allow_smem() {
  constexpr int bytes = Smem<DH>::kBytes;
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_prefill_kernel<DH, QK_ONLY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int DH, bool QK_ONLY>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T, int H, int K, int causal, int window, int q_offset,
           int t_total, float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, DH) || !make_map(&tk, k, B, T, K, DH) ||
      !make_map(&tv, v, B, T, K, DH))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem<DH, QK_ONLY>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_prefill_kernel<DH, QK_ONLY>
      <<<grid, kThreads, Smem<DH>::kBytes, (cudaStream_t)stream>>>(
          tq, tk, tv, out, S, H, K, causal, window, q_offset, t_total, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The head widths that are instances; the wrapper pads others up to one.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int S, int T, int H, int K,
                                  int Dh, int causal, int window, int q_offset,
                                  int t_total, float scale, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  switch (Dh) {
    case 64:
      return launch<64, false>(q, k, v, out, B, S, T, H, K, causal, window,
                               q_offset, t_total, scale, stream);
    case 128:
      return launch<128, false>(q, k, v, out, B, S, T, H, K, causal, window,
                                q_offset, t_total, scale, stream);
    case 256:
      return launch<256, false>(q, k, v, out, B, S, T, H, K, causal, window,
                                q_offset, t_total, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Q.K^T (raw f32 sums) of the first 64-key tile for each 64-row query tile
// of batch 0, head 0, Dh = 64: out (S, 64) f32.  For the card test only.
extern "C" int flash_prefill_qk_tile_bf16(const void* q, const void* k,
                                          void* out, int S, int T,
                                          void* stream) {
  return launch<64, true>(q, k, k, out, 1, S, T, 1, 1, 0, 0, 0, T, 1.f,
                          stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
