// Mamba-2 SSD chunked scan on Hopper's tensor cores (sm_90a): the SSM
// mixer's prefill.
//
// Replaces the TPU kernel `ssd_scan_kernel`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`).
//
// What it computes, per (batch b, head h), over chunks of Q steps (A_h < 0,
// dt >= 0, so cum falls within a chunk):
//   dA = dt * A_h ;  cum = inclusive cumsum(dA) ;  total = cum[last]
//   y[q]  = sum_{j <= q} (C_q . B_j) exp(cum_q - cum_j) dt_j x_j
//         + exp(cum_q) C_q . state                 (the state BEFORE the chunk)
//   state = exp(total) state + sum_j B_j (x) x_j dt_j exp(total - cum_j)
// x (b,S,H,P), y (b,S,H,P) in T (bf16 or f32); dt (b,S,H) f32; A (H,) f32;
// B, C (b,S,G,N) in T, group g = h / (H/G) serving head h; the final state
// (b,H,N,P) f32.  The last chunk may hold fewer than Q steps: its missing
// rows are taken as dt = 0, x = B = C = 0, which is what the reference's
// padding computes (exp(0) = 1 and no contribution, so the carried state is
// exact).
//
// What bounds it on the H100: operations.  At the main path's shape
// (mamba2-370m's 1023-token admission: H = 32, P = 64, N = 128, G = 1,
// Q = 256, 4 chunks) the chunked form needs ~1.6 GFLOP (C.B^T over the
// causal pairs once per group; per head its product with x dt, the carry-in
// and the state update) against ~10 MB of operands, ~160 flop/byte: on
// f32 FMAs (67 TFLOP/s) that is ~25 us, on the bf16 tensor cores a few.
// What the design does about it:
//  - chunk-parallel, by state passing (arXiv:2405.21060), three launches:
//    `chunk_state_kernel`, one CTA per (b, h, chunk, 64 columns of P): the
//    chunk's own end state S_c = B^T (x dt exp(total - cum)), (N, P) f32,
//    and its total into a workspace; `state_pass_kernel`, one thread per 4
//    state entries: the state entering each chunk, s_c = exp(total_{c-1})
//    s_{c-1} + S_{c-1}, as bf16 hi + lo tiles, and the final state;
//    `chunk_out_kernel`, one CTA per (b, one or two heads of one group,
//    chunk, 64-row q tile, 64 columns of P), heaviest tiles first: the
//    carry-in exp(cum_q) C_q . s_c, the causal intra-chunk term over the j
//    tiles up to the diagonal, y written once.  At the main shape, on the
//    wrapper's chunks of 128 steps, that is 256 + 256 + 256 CTAs where a
//    chunk-serial kernel has 32 (b, h) chains;
//  - every product on the tensor cores.  In `chunk_out_kernel` (one
//    warpgroup, 64 q rows: one wgmma M) C.B^T and M.x are `wgmma`
//    m64n64k16 bf16 -> f32 (HGMMA): C, B and x staged in the 128-byte
//    swizzle (`hopper.cuh`'s descriptors), the masked decay tile
//    M = (C.B^T) exp(cum_q - cum_j) dt_j built in the registers that hold
//    C.B^T and fed as wgmma's register A operand, as flash attention feeds
//    P.  The carry-in and `chunk_state_kernel`'s products are `mma.sync`
//    m16n8k16 (HMMA), each warp owning 16 rows, from padded shared tiles
//    (272- or 144-byte rows: `ldmatrix` conflict-free, with `.trans` where
//    a product reads a tile along its rows);
//  - f32 accuracy without f32 FMAs: x, B and C are bf16 on the serve path,
//    so every product has one exact bf16 operand.  The f32 operand (M, the
//    entering state, x dt exp(total - cum)) is split into bf16 hi + lo and
//    multiplied twice (~16 significant bits; C.B^T is exact in one pass).
//    The f32 instance also splits x, B and C: three passes (hi.hi, hi.lo,
//    lo.hi), well inside the 1e-3 f32 tolerance;
//  - C.B^T once per head pair: it depends on the group, not the head, so a
//    CTA of two heads computes each (q tile, j tile) of it once and applies
//    it to both with each head's decay mask and x; two heads a CTA where
//    that still gives a CTA per SM (the main shape: 256 CTAs), else one
//    (the C entry's `heads` forces either: chip_smoke.py times both);
//  - loads are 16-byte `cp.async` copies (8 values a thread; f32 and
//    scaled inputs through registers) into the shared tiles, the next j
//    tile or stage in flight while this one's products run, item loops
//    over power-of-two widths (no integer division); rows at or past the
//    chunk's end and columns past N or P are staged as 0;
//  - masking: j > q is masked BEFORE the exponent (above the diagonal cum_q
//    - cum_j > 0 and exp may overflow; inf * 0 would be NaN).
// Every CTA runs a chain of dependent steps (loads, cumsum, products of a
// few warps); latency, not the tensor cores' rate, sets its time.
//
// Requirements (checked here and by the wrapper): N <= 128, H % G == 0,
// tensors contiguous; the workspace holds `ssd_scan_workspace_floats` f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kT = 64;             // rows of a q tile, a j tile, a stage
constexpr int kPT = 64;            // P columns per CTA
constexpr int kMaxN = 128;         // state rows
constexpr int kLdN = kMaxN + 8;    // bf16 stride of a (rows, N) tile: 272 B
constexpr int kLdP = kPT + 8;      // bf16 stride of a (rows, P) tile: 144 B
constexpr int kTileN = kT * kLdN;  // bf16 elements of a (64, N) tile
constexpr int kTileP = kT * kLdP;  // bf16 elements of a (64, P) tile
constexpr int kStateP = kMaxN * kLdP;
constexpr int kThreadsA = 256;     // chunk_state_kernel: 8 warps x 16 rows
constexpr int kThreadsB = 128;     // chunk_out_kernel: 4 warps x 16 q rows
constexpr float kLog2e = 1.4426950408889634f;

// x, B and C carry a lo part (f32 inputs only)
template <typename T>
constexpr bool kSplitIn = std::is_same<T, float>::value;

// ---- tensor cores -----------------------------------------------------------

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses for lane `l` (i = l / 8 picks the 8x8 matrix) in a
// tile stored [k][m] (ldsm_t): the A operand (16 x 16 at m0, k0) ...
__device__ __forceinline__ const bf16* a_km(const bf16* t, int ld, int m0,
                                            int k0, int l) {
  return t + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8;
}
// ... and the B operands of two n-tiles (16 k x 16 n at k0, n0; registers
// 0-1 the first tile's, 2-3 the second's).
__device__ __forceinline__ const bf16* b_kn(const bf16* t, int ld, int n0,
                                            int k0, int l) {
  return t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8;
}

// The offset of row r, column c (a multiple of 8) of a 64-row tile stored
// as 64-column panels in the 128-byte swizzle that wgmma reads: the 16-byte
// piece c/8 of a row sits at piece (c/8 ^ r) % 8 of its 128-byte line.
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * (kT * 64) + r * 64 + ((((c >> 3) ^ r) & 7) << 3);
}
// The A operand's fragment addresses (16 x 16 at m0, k0; ldsm) in such a
// tile stored [m][k].
__device__ __forceinline__ const bf16* a_mk_sw(const bf16* t, int m0, int k0,
                                               int l) {
  return t + sw_off(m0 + (l & 7) + ((l >> 3) & 1) * 8, k0 + (l >> 4) * 8);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) ~ hi + lo as bf16 pairs, a in the low half.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// The 16 x 8 f32 fragment i of a 64 x 64 accumulator (mma's layout).
__device__ __forceinline__ float (&frag(float (&d)[32], int i))[4] {
  return *reinterpret_cast<float(*)[4]>(&d[4 * i]);
}

__device__ __forceinline__ float ex2(float x) {    // 2^x, one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- staging ----------------------------------------------------------------

__device__ __forceinline__ void load8(const float* s, bool vec, int nc,
                                      float (&v)[8]) {
  if (vec && nc >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < nc ? s[k] : 0.f;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// All but this thread's `kPending` latest groups of copies have landed (a
// __syncthreads then shows them to every thread).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows 0..kT-1 of a row-major slice (row stride rs elements) into bf16
// shared tiles t[r * ld + c]: hi, and lo (v ~ hi + lo) where the input is
// f32 or rows are scaled by scale[r] (kScaled).  Rows at or past nr and
// columns at or past nc are 0.  W, the tile width (64 or 128), and the
// thread count are compile-time, so each thread's items are unrolled with
// their loads in flight together (bf16 as it is goes by cp.async: the
// caller commits and waits) and the item loop divides by shifts.
template <typename T, int W, bool kScaled, int kThreads, bool kSw = false>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t rs,
                                      int nr, int nc, const float* scale,
                                      bf16* hi, bf16* lo, int ld, int tid) {
  // kSw: the 128-byte swizzle of sw_off (ld unused)
  const auto at = [&](int r, int c) { return kSw ? sw_off(r, c) : r * ld + c; };
  constexpr int kC = W / 8;                   // 8-value pieces a row
  constexpr int kIt = kT * kC / kThreads;     // pieces a thread
  static_assert(kT * kC % kThreads == 0, "pieces");
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | (rs * sizeof(T))) & 15) == 0;
  if constexpr (!kSplitIn<T> && !kScaled) {   // bf16 as it is
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kC, c = (i % kC) * 8;
      const T* s = src + r * rs + c;
      uint4* d = reinterpret_cast<uint4*>(hi + at(r, c));
      if (r < nr && vec && nc - c >= 8) {
        cp_async16(d, s);
      } else {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (r < nr && c + k < nc) e[k] = s[k];
        *d = u;
      }
    }
  } else {
    constexpr int kGrp = kIt < 4 ? kIt : 4;   // pieces loaded together
#pragma unroll
    for (int g0 = 0; g0 < kIt; g0 += kGrp) {
      float v[kGrp][8];
#pragma unroll
      for (int u = 0; u < kGrp; ++u) {
        const int i = tid + (g0 + u) * kThreads;
        const int r = i / kC, c = (i % kC) * 8;
        if (r < nr) {
          load8(src + r * rs + c, vec, nc - c, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kGrp; ++u) {
        const int i = tid + (g0 + u) * kThreads;
        const int r = i / kC, c = (i % kC) * 8;
        const float f = kScaled && r < nr ? scale[r] : 1.f;
        uint4 h, w;
        split(v[u][0] * f, v[u][1] * f, h.x, w.x);
        split(v[u][2] * f, v[u][3] * f, h.y, w.y);
        split(v[u][4] * f, v[u][5] * f, h.z, w.z);
        split(v[u][6] * f, v[u][7] * f, h.w, w.w);
        *reinterpret_cast<uint4*>(hi + at(r, c)) = h;
        *reinterpret_cast<uint4*>(lo + at(r, c)) = w;
      }
    }
  }
}

// A raw bf16 (64, 64) tile that this thread staged with `stage` (the same
// pieces), rows scaled by scale[r] (rows at or past nr are 0) and split
// into hi + lo tiles.
template <int kThreads>
__device__ __forceinline__ void scale_split(const bf16* raw,
                                            const float* scale, int nr,
                                            bf16* hi, bf16* lo, int tid) {
  constexpr int kC = kPT / 8;
  constexpr int kIt = kT * kC / kThreads;
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kC, c = (i % kC) * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(raw + r * kLdP + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float f = r < nr ? scale[r] : 0.f;
    uint32_t h[4], w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(p[k]);
      split(v.x * f, v.y * f, h[k], w[k]);
    }
    *reinterpret_cast<uint4*>(hi + r * kLdP + c) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * kLdP + c) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dt of rows 0..rows-1 of a chunk into d (rows at or past qv: 0), all
// loads in flight at once.
template <int kThreads>
__device__ __forceinline__ void load_dt(const float* __restrict__ dt,
                                        size_t stride, int rows, int qv,
                                        float* d, int tid) {
  for (int r = tid; r < rows; r += 2 * kThreads) {
    const int r2 = r + kThreads;
    const float a = r < qv ? dt[r * stride] : 0.f;
    const float b = r2 < qv ? dt[r2 * stride] : 0.f;
    d[r] = a;
    if (r2 < rows) d[r2] = b;
  }
}

// Inclusive cumsum of d * a over rows 0..rows-1 (one warp; rows a multiple
// of 32), in log2 units into cl.  Returns cum (natural units) at the last
// row.
__device__ __forceinline__ float chunk_cumsum(const float* d, int rows,
                                              float a, float* cl, int lane) {
  float carry = 0.f;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int r = r0 + lane;
    float v = d[r] * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    cl[r] = v * kLog2e;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  return carry;
}

// ---- launch 1: the chunks' own end states -----------------------------------

// S_c[n][p] = sum_j B[j][n] w[j] x[j][p], w = dt exp(total - cum): A = B^T
// read through ldmatrix.trans, B = (w x) split into hi + lo.  Warp w owns
// state rows 16w..16w+15.
template <typename T>
struct StateSmem {                      // offsets in bf16 elements
  static constexpr int kNT = kSplitIn<T> ? 2 : 1;   // tiles per input
  static constexpr int kB = 0;                      // B, two stages
  static constexpr int kXr = 2 * kNT * kTileN;      // raw x, two stages
  static constexpr int kX = kXr + (kSplitIn<T> ? 0 : 2 * kTileP);  // w x
  static constexpr int kEnd = kX + 2 * kTileP;                     // hi, lo
  // + cum (log2 units) and w, (Qp) f32 each
  static size_t bytes(int Qp) { return 2 * (size_t)kEnd + 8 * (size_t)Qp; }
};

// S_c[n][p] = sum_j B[j][n] w[j] x[j][p], w = dt exp(total - cum): A = B^T
// read through ldmatrix.trans, B = (w x) split into hi + lo.  Warp w owns
// state rows 16w..16w+15.  64-row stages of B and x are double-buffered:
// the next stage's copies fly while this one's products run (bf16; the f32
// instance stages synchronously).
template <typename T>
__global__ void __launch_bounds__(kThreadsA)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ ws_S, float* __restrict__ ws_tot,
                   float* __restrict__ ws_cum, int S, int H, int P, int G,
                   int N, int Q, int Qp, int n_chunks, int p_tiles) {
  using L = StateSmem<T>;
  constexpr bool kSp = kSplitIn<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  bf16* sX = sm + L::kX;                          // (64, P) hi, lo of w x
  float* s_cl = reinterpret_cast<float*>(sm + L::kEnd);      // (Qp)
  float* s_w = s_cl + Qp;                                    // (Qp)

  const int c = blockIdx.x, bi = blockIdx.z;
  const int h = blockIdx.y / p_tiles, pt = blockIdx.y % p_tiles;
  const int p0 = pt * kPT, g = h / (H / G), Ppad = p_tiles * kPT;
  const int t0 = c * Q, qv = min(Q, S - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)bi * S + t0;
  const int n_st = (qv + kT - 1) / kT;

  // stage s's B (and raw x) into buffer s & 1
  const auto issue = [&](int s) {
    const int j0 = s * kT;
    bf16* b = sm + L::kB + (s & 1) * L::kNT * kTileN;
    stage<T, kMaxN, false, kThreadsA>(Bm + ((row0 + j0) * G + g) * N,
                                      (size_t)G * N, qv - j0, N, nullptr, b,
                                      b + kTileN, kLdN, tid);
    if constexpr (!kSp)
      stage<T, kPT, false, kThreadsA>(x + ((row0 + j0) * H + h) * P + p0,
                                      (size_t)H * P, qv - j0, P - p0, nullptr,
                                      sm + L::kXr + (s & 1) * kTileP, nullptr,
                                      kLdP, tid);
  };
  load_dt<kThreadsA>(dt + row0 * H + h, H, Qp, qv, s_w, tid);
  issue(0);
  cp_async_commit();
  __syncthreads();
  const size_t bhc = ((size_t)bi * H + h) * n_chunks + c;
  if (warp == 0) {
    const float tot = chunk_cumsum(s_w, Qp, A[h], s_cl, lane);
    if (lane == 0 && pt == 0) ws_tot[bhc] = tot;
  }
  __syncthreads();
  // cum and dt of every row for chunk_out_kernel; w = dt exp(total - cum)
  const float total = s_cl[qv - 1];
  float* wc = ws_cum + bhc * 2 * Qp;
  for (int r = tid; r < Qp; r += kThreadsA) {
    const float d = s_w[r];
    if (pt == 0) {
      wc[r] = s_cl[r];
      wc[Qp + r] = d;
    }
    if (r < qv) s_w[r] = d * ex2(total - s_cl[r]);
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  const int m0 = warp * 16;
  for (int s = 0; s < n_st; ++s) {
    const int j0 = s * kT;
    if (s + 1 < n_st) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();               // stage s has landed
    if constexpr (kSp)
      stage<T, kPT, true, kThreadsA>(x + ((row0 + j0) * H + h) * P + p0,
                                     (size_t)H * P, qv - j0, P - p0,
                                     s_w + j0, sX, sX + kTileP, kLdP, tid);
    else
      scale_split<kThreadsA>(sm + L::kXr + (s & 1) * kTileP, s_w + j0,
                             qv - j0, sX, sX + kTileP, tid);
    __syncthreads();
    const bf16* sB = sm + L::kB + (s & 1) * L::kNT * kTileN;
    if (m0 < N) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t a[4], al[4];
        ldsm_t(a, a_km(sB, kLdN, m0, 16 * kk, lane));
        if constexpr (kSp)
          ldsm_t(al, a_km(sB + kTileN, kLdN, m0, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bh[4], bl[4];
          ldsm_t(bh, b_kn(sX, kLdP, 16 * np, 16 * kk, lane));
          ldsm_t(bl, b_kn(sX + kTileP, kLdP, 16 * np, 16 * kk, lane));
          mma(acc[2 * np], a, bh[0], bh[1]);
          mma(acc[2 * np + 1], a, bh[2], bh[3]);
          mma(acc[2 * np], a, bl[0], bl[1]);
          mma(acc[2 * np + 1], a, bl[2], bl[3]);
          if constexpr (kSp) {
            mma(acc[2 * np], al, bh[0], bh[1]);
            mma(acc[2 * np + 1], al, bh[2], bh[3]);
          }
        }
      }
    }
    __syncthreads();                  // sX and buffer s & 1 are rewritten
  }

  float* out = ws_S + bhc * N * Ppad + p0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = m0 + lane / 4 + 8 * half;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(out + (size_t)n * Ppad + 8 * nt +
                                 2 * (lane % 4)) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// ---- launch 2: the state entering each chunk --------------------------------

// For every chunk c the state entering it, s_c = exp(total_{c-1}) s_{c-1}
// + S_{c-1} (s_0 = 0), as the bf16 hi + lo tiles [n][kLdP] that
// chunk_out_kernel copies as they are; and the state after the last
// chunk, f32, into state_out.  One thread per 4 columns of a state row
// (rows up to N rounded to 16; those past N stay 0), the chunks in order,
// their own states loaded 4 at a time.
__global__ void __launch_bounds__(256)
state_pass_kernel(const float* __restrict__ ws_S,
                  const float* __restrict__ ws_tot, bf16* __restrict__ ws_in,
                  float* __restrict__ state_out, int H, int P, int N,
                  int n_chunks, int p_tiles) {
  const int h = blockIdx.x / p_tiles, pt = blockIdx.x % p_tiles;
  const int n = blockIdx.y * 16 + threadIdx.x / 16;
  const int p = (threadIdx.x % 16) * 4, p0 = pt * kPT;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int Ppad = p_tiles * kPT;
  const float* Sh =
      ws_S + bh * n_chunks * N * Ppad + (size_t)n * Ppad + p0 + p;
  const float* toth = ws_tot + bh * n_chunks;
  bf16* in =
      ws_in + (bh * p_tiles + pt) * n_chunks * 2 * kStateP + n * kLdP + p;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n_chunks; c0 += 4) {
    float4 v[4];
    float f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      f[u] = 1.f;
      if (c < n_chunks) {
        if (n < N)
          v[u] = *reinterpret_cast<const float4*>(Sh + (size_t)c * N * Ppad);
        f[u] = expf(toth[c]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u;
      if (c >= n_chunks) break;
      uint2 hi, lo;
      split(s.x, s.y, hi.x, lo.x);
      split(s.z, s.w, hi.y, lo.y);
      bf16* d = in + (size_t)c * 2 * kStateP;
      *reinterpret_cast<uint2*>(d) = hi;
      *reinterpret_cast<uint2*>(d + kStateP) = lo;
      s.x = fmaf(f[u], s.x, v[u].x);
      s.y = fmaf(f[u], s.y, v[u].y);
      s.z = fmaf(f[u], s.z, v[u].z);
      s.w = fmaf(f[u], s.w, v[u].w);
    }
  }
  if (n >= N) return;
  float* d = state_out + (bh * N + n) * P + p0 + p;
  const float o[4] = {s.x, s.y, s.z, s.w};
  if ((P & 3) == 0 && p0 + p + 4 <= P) {
    *reinterpret_cast<float4*>(d) = s;
  } else {
    for (int k = 0; k < 4 && p0 + p + k < P; ++k) d[k] = o[k];
  }
}

// ---- launch 3: y ------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, int valid);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b,
                                              int valid) {
  if (valid >= 2 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (valid >= 1) p[0] = a;
    if (valid >= 2) p[1] = b;
  }
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b,
                                             int valid) {
  if (valid >= 2 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (valid >= 1) p[0] = __float2bfloat16(a);
    if (valid >= 2) p[1] = __float2bfloat16(b);
  }
}

template <typename T, int HB>
struct OutSmem {                        // offsets in bf16 elements
  static constexpr int kNT = kSplitIn<T> ? 2 : 1;   // tiles per input
  // (64, N) and (64, P) tiles in the 128-byte swizzle of sw_off
  static constexpr int kTN = kT * kMaxN;
  static constexpr int kTP = kT * kPT;
  static constexpr int kC = 0;                      // C_q (64, N)
  // a j stage: B_j (64, N), then x_j (64, P) per head
  static constexpr int kStage = kNT * kTN + HB * kNT * kTP;
  static constexpr int kBuf0 = kNT * kTN;
  static constexpr int kBuf1 = kBuf0 + kStage;      // also the folded state
  static constexpr int kStEnd = kBuf1 + 2 * kStateP;          // hi, lo
  static constexpr int kEnd =
      kBuf1 + kStage > kStEnd ? kBuf1 + kStage : kStEnd;
  // + cum (log2 units) and dt of each head, (HB, Qp) f32 each, + the
  // swizzle's 1024-byte alignment
  static size_t bytes(int Qp) {
    return 2 * (size_t)kEnd + 8 * (size_t)HB * Qp + 1024;
  }
};

// One CTA, one warpgroup: heads h0..h0+HB-1 (one group), chunk c, q rows
// q0..q0+63, columns p0..p0+63; warp w owns q rows q0+16w..q0+16w+15.
// C.B^T and M.x are wgmma m64n64k16 (C, B, x from the swizzled tiles; M
// from registers); the carry-in C.state is mma.sync (the state tiles come
// from the workspace as state_pass_kernel wrote them).
template <typename T, int HB>
__global__ void __launch_bounds__(kThreadsB)
chunk_out_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 const float* __restrict__ ws_cum,
                 const bf16* __restrict__ ws_in, int S, int H, int P, int G,
                 int N, int Q, int Qp, int n_chunks, int p_tiles) {
  using L = OutSmem<T, HB>;
  constexpr bool kSp = kSplitIn<T>;
  constexpr uint32_t kPanel = kT * 64 * 2;          // bytes of a 64 x 64 panel
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sC = sm + L::kC;
  bf16* sSt = sm + L::kBuf1;
  float* s_cl = reinterpret_cast<float*>(sm + L::kEnd);
  float* s_dt = s_cl + HB * Qp;

  // heaviest first: the last q tiles of the last chunks start first
  const int tiles = Qp / kT;
  const int qt = tiles - 1 - (int)blockIdx.x / n_chunks;
  const int c = n_chunks - 1 - (int)blockIdx.x % n_chunks;
  const int h0 = blockIdx.y / p_tiles * HB, pt = blockIdx.y % p_tiles;
  const int bi = blockIdx.z, p0 = pt * kPT, g = h0 / (H / G);
  const int t0 = c * Q, qv = min(Q, S - t0), q0 = qt * kT;
  if (q0 >= qv) return;                   // past a short last chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = warp * 16;
  const int n_k = (N + 15) / 16;          // 16-wide slices of the state dim
  const size_t row0 = (size_t)bi * S + t0;

  // j tile jt's B and x into buffer jt & 1 (the second one also holds the
  // entering state until the j loop starts)
  const auto issue = [&](int jt) {
    const int j0 = jt * kT;
    bf16* buf = sm + (jt & 1 ? L::kBuf1 : L::kBuf0);
    stage<T, kMaxN, false, kThreadsB, true>(
        Bm + ((row0 + j0) * G + g) * N, (size_t)G * N, qv - j0, N, nullptr,
        buf, buf + L::kTN, 0, tid);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      bf16* xh = buf + L::kNT * L::kTN + hh * L::kNT * L::kTP;
      stage<T, kPT, false, kThreadsB, true>(
          x + ((row0 + j0) * H + h0 + hh) * P + p0, (size_t)H * P, qv - j0,
          P - p0, nullptr, xh, xh + L::kTP, 0, tid);
    }
  };
  // the entering state of head hh (bf16 hi, lo) into the state tiles
  const int st_pieces = ((N + 15) & ~15) * kLdP / 8;   // 16 B a piece
  const auto copy_state = [&](int hh) {
    const bf16* src = ws_in + (((size_t)bi * H + h0 + hh) * p_tiles + pt) *
                                  n_chunks * 2 * kStateP +
                      (size_t)c * 2 * kStateP;
    for (int i = tid; i < 2 * st_pieces; i += kThreadsB) {
      const int lo = i >= st_pieces, j = (i - lo * st_pieces) * 8;
      cp_async16(sSt + lo * kStateP + j, src + lo * kStateP + j);
    }
  };
  // cum and dt of rows 0..q0+63 of each head, from chunk_state_kernel
  const int cum_pieces = (q0 + kT) / 4;     // 16 B a piece
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const float* src =
        ws_cum + (((size_t)bi * H + h0 + hh) * n_chunks + c) * 2 * Qp;
    for (int i = tid; i < 2 * cum_pieces; i += kThreadsB) {
      const int d = i >= cum_pieces, j = (i - d * cum_pieces) * 4;
      cp_async16((d ? s_dt : s_cl) + hh * Qp + j, src + d * Qp + j);
    }
  }
  stage<T, kMaxN, false, kThreadsB, true>(Cm + ((row0 + q0) * G + g) * N,
                                          (size_t)G * N, qv - q0, N, nullptr,
                                          sC, sC + L::kTN, 0, tid);
  if (c > 0) copy_state(0);
  cp_async_commit();
  issue(0);                               // flies during the carry-in
  cp_async_commit();
  cp_async_wait<1>();                     // cum, C_q and the first state
  __syncthreads();

  float acc[HB][32];                      // y of each head, wgmma's layout
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;
  const int qa = q0 + m0 + lane / 4, qb = qa + 8;   // this thread's rows

  // carry-in exp(cum_q) C_q . state, the state of each head in turn
  if (c > 0) {
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh > 0) {
        copy_state(hh);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      for (int kk = 0; kk < n_k; ++kk) {
        uint32_t a[4], al[4];
        ldsm(a, a_mk_sw(sC, m0, 16 * kk, lane));
        if constexpr (kSp) ldsm(al, a_mk_sw(sC + L::kTN, m0, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t sh[4], sl[4];
          ldsm_t(sh, b_kn(sSt, kLdP, 16 * np, 16 * kk, lane));
          ldsm_t(sl, b_kn(sSt + kStateP, kLdP, 16 * np, 16 * kk, lane));
          mma(frag(acc[hh], 2 * np), a, sh[0], sh[1]);
          mma(frag(acc[hh], 2 * np + 1), a, sh[2], sh[3]);
          mma(frag(acc[hh], 2 * np), a, sl[0], sl[1]);
          mma(frag(acc[hh], 2 * np + 1), a, sl[2], sl[3]);
          if constexpr (kSp) {
            mma(frag(acc[hh], 2 * np), al, sh[0], sh[1]);
            mma(frag(acc[hh], 2 * np + 1), al, sh[2], sh[3]);
          }
        }
      }
      const float fa = ex2(s_cl[hh * Qp + qa]), fb = ex2(s_cl[hh * Qp + qb]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] *= (i & 2) ? fb : fa;
      __syncthreads();                    // the state tile is rewritten next
    }
  }

  const uint32_t c_s = smem_u32(sC);
  // the intra-chunk term, j tiles up to the diagonal
  for (int jt = 0; jt <= qt; ++jt) {
    const int j0 = jt * kT;
    const bool diag = jt == qt;
    if (jt < qt) issue(jt + 1);           // flies during this tile's products
    cp_async_commit();
    cp_async_wait<1>();                   // tile jt has landed
    // shown to wgmma's async proxy, then to the warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const bf16* sB = sm + (jt & 1 ? L::kBuf1 : L::kBuf0);
    const uint32_t b_s = smem_u32(sB);
    const uint32_t x_s = b_s + 2 * L::kNT * L::kTN;

    // G = C_q . B_j^T over the state dim in 16-wide slices (f32 inputs:
    // hi.hi + hi.lo + lo.hi)
    float gm[32];
    reg_fence(gm);
    wgmma_fence();
    for (int kk = 0; kk < n_k; ++kk) {
      const uint32_t off = (kk / 4) * kPanel + (kk % 4) * 32;
      const uint64_t dc = sw128_desc(c_s + off, 16);
      const uint64_t db = sw128_desc(b_s + off, 16);
      wgmma_ss(gm, dc, db, kk > 0);
      if constexpr (kSp) {
        wgmma_ss(gm, dc, sw128_desc(b_s + 2 * L::kTN + off, 16), 1);
        wgmma_ss(gm, sw128_desc(c_s + 2 * L::kTN + off, 16), db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(gm);

#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const float* cl = s_cl + hh * Qp;
      const float* dj = s_dt + hh * Qp;
      const float ca = cl[qa], cb = cl[qb];
      // M = G exp(cum_q - cum_j) dt_j, j > q masked before the exponent,
      // split hi + lo into the A operand's registers, every 16-wide j slice
      // before the products (wgmma reads them until its wait)
      uint32_t mh[4][4], ml[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 16 * kk + 8 * e + 2 * (lane % 4);
          const float* gv = frag(gm, 2 * kk + e);
          const float c0 = cl[j], c1 = cl[j + 1], d0 = dj[j], d1 = dj[j + 1];
          float la0 = ca - c0, la1 = ca - c1, lb0 = cb - c0, lb1 = cb - c1;
          if (diag) {
            if (j > qa) la0 = -INFINITY;
            if (j + 1 > qa) la1 = -INFINITY;
            if (j > qb) lb0 = -INFINITY;
            if (j + 1 > qb) lb1 = -INFINITY;
          }
          split(gv[0] * ex2(la0) * d0, gv[1] * ex2(la1) * d1, mh[kk][2 * e],
                ml[kk][2 * e]);
          split(gv[2] * ex2(lb0) * d0, gv[3] * ex2(lb1) * d1,
                mh[kk][2 * e + 1], ml[kk][2 * e + 1]);
        }
      // y += M . x_j: hi and lo of M (f32 inputs: also hi of M . lo of x)
      const uint32_t xh = x_s + 2 * hh * L::kNT * L::kTP;
      reg_fence(acc[hh]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = kk * 16 * 128;          // 16 rows of 128 bytes
        const uint64_t dx = sw128_desc(xh + off, kPanel);
        wgmma_rs(acc[hh], mh[kk], dx);
        wgmma_rs(acc[hh], ml[kk], dx);
        if constexpr (kSp)
          wgmma_rs(acc[hh], mh[kk],
                   sw128_desc(xh + 2 * L::kTP + off, kPanel));
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc[hh]);
    }
    __syncthreads();                      // buffer jt & 1 is refilled next
  }

#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    T* yh = y + row0 * H * P + (size_t)(h0 + hh) * P + p0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = half ? qb : qa;
      if (q >= qv) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * (lane % 4);
        if (p0 + p < P)
          store2<T>(yh + (size_t)q * H * P + p, acc[hh][4 * nt + 2 * half],
                    acc[hh][4 * nt + 2 * half + 1], P - p0 - p);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

// The workspace, in f32 units from its start, per (b, h, chunk): the
// chunk's own end state (N, P rounded up to kPT) f32; its total f32 (the
// array padded to 16 bytes); cum and dt of its Qp rows f32; per kPT
// columns of P, the state entering it as bf16 hi and lo (kMaxN, kLdP)
// tiles.  `ssd_scan_workspace_floats` exports its size to the wrapper.
struct Workspace {
  size_t S, tot, cum, in, floats;
  Workspace(int b, int S_len, int H, int P, int N, int Q) {
    const size_t bhc = (size_t)b * H * ((S_len + Q - 1) / Q);
    const size_t p_tiles = (P + kPT - 1) / kPT, Qp = (Q + kT - 1) / kT * kT;
    S = 0;
    tot = S + bhc * N * p_tiles * kPT;
    cum = tot + ((bhc + 3) & ~(size_t)3);
    in = cum + bhc * 2 * Qp;
    floats = in + bhc * p_tiles * kStateP;   // 2 kStateP bf16 a tile pair
  }
};

struct DeviceInfo {
  int sms = 0, smem_optin = 0;
};

DeviceInfo device_info(int dev) {
  static DeviceInfo info[64];
  static std::atomic<unsigned long long> known{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(known.load(std::memory_order_acquire) & bit)) {
    DeviceInfo d;
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    info[dev & 63] = d;
    known.fetch_or(bit, std::memory_order_release);
  }
  return info[dev & 63];
}

// Dynamic shared memory above 48 KB, opted into once per device and kernel
// (up to the card's limit, so that any chunk length fits).
template <typename Tag>
cudaError_t allow_smem(const void* fn, int dev, int optin) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}
template <typename T, int HB> struct Tag {};

template <typename T, int HB>
cudaError_t launch_out(const DeviceInfo& info, int dev, dim3 grid,
                       cudaStream_t st, const T* x, const T* B, const T* C,
                       T* y, const float* ws_cum, const bf16* ws_in, int S,
                       int H, int P, int G, int N, int Q, int Qp, int n_chunks,
                       int p_tiles) {
  const size_t smem = OutSmem<T, HB>::bytes(Qp);
  if (smem > (size_t)info.smem_optin) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<Tag<T, HB>>(
      reinterpret_cast<const void*>(chunk_out_kernel<T, HB>), dev,
      info.smem_optin);
  if (e != cudaSuccess) return e;
  chunk_out_kernel<T, HB><<<grid, kThreadsB, smem, st>>>(
      x, B, C, y, ws_cum, ws_in, S, H, P, G, N, Q, Qp, n_chunks, p_tiles);
  return cudaGetLastError();
}

// heads: C.B^T tiles shared by 1 or 2 heads a CTA, or 0 for the rule below.
template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, void* ws, int b, int S, int H,
           int P, int G, int N, int Q, int heads, void* stream) {
  if (b == 0 || H == 0 || P == 0) return 0;  // nothing to compute
  if (S <= 0 || Q <= 0 || N <= 0 || N > kMaxN || G <= 0 || H % G ||
      b > 65535 || heads < 0 || heads > 2 || (heads == 2 && (H / G) % 2))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + Q - 1) / Q, tiles = (Q + kT - 1) / kT;
  const int p_tiles = (P + kPT - 1) / kPT, Qp = tiles * kT;
  const int rep = H / G;
  if ((long long)H * p_tiles > 65535 ||
      (long long)n_chunks * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const DeviceInfo info = device_info(dev);
  // two heads a CTA (C.B^T computed once for both) where that still gives
  // a CTA per SM, else one
  const bool two =
      heads ? heads == 2
            : rep % 2 == 0 &&
                  (long long)n_chunks * tiles * (H / 2) * p_tiles * b >=
                      info.sms;
  const cudaStream_t st = (cudaStream_t)stream;
  const Workspace w(b, S, H, P, N, Q);
  float* wS = static_cast<float*>(ws) + w.S;
  float* wT = static_cast<float*>(ws) + w.tot;
  float* wC = static_cast<float*>(ws) + w.cum;
  bf16* wIn = reinterpret_cast<bf16*>(static_cast<float*>(ws) + w.in);

  const size_t smem_a = StateSmem<T>::bytes(Qp);
  if (smem_a > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;
  e = allow_smem<Tag<T, 0>>(reinterpret_cast<const void*>(
                                chunk_state_kernel<T>),
                            dev, info.smem_optin);
  if (e != cudaSuccess) return (int)e;
  chunk_state_kernel<T><<<dim3(n_chunks, H * p_tiles, b), kThreadsA, smem_a,
                          st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B, wS, wT, wC,
      S, H, P, G, N, Q, Qp, n_chunks, p_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  state_pass_kernel<<<dim3(H * p_tiles, (N + 15) / 16, b), 256, 0, st>>>(
      wS, wT, wIn, (float*)state, H, P, N, n_chunks, p_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  using Out = cudaError_t (*)(const DeviceInfo&, int, dim3, cudaStream_t,
                              const T*, const T*, const T*, T*, const float*,
                              const bf16*, int, int, int, int, int, int, int,
                              int, int);
  const Out out = two ? launch_out<T, 2> : launch_out<T, 1>;
  return (int)out(info, dev,
                  dim3(n_chunks * tiles, H / (two ? 2 : 1) * p_tiles, b), st,
                  (const T*)x, (const T*)B, (const T*)C, (T*)y, wC, wIn, S, H,
                  P, G, N, Q, Qp, n_chunks, p_tiles);
}

}  // namespace

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y,
                             void* state, void* ws, int b, int S, int H,
                             int P, int G, int N, int Q, int heads,
                             void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, ws, b, S, H, P, G,
                               N, Q, heads, stream);
}

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y, void* state,
                            void* ws, int b, int S, int H, int P, int G,
                            int N, int Q, int heads, void* stream) {
  return launch<float>(x, dt, A, B, C, y, state, ws, b, S, H, P, G, N, Q,
                       heads, stream);
}

// f32 values of the workspace that ssd_scan_* takes for these sizes.
extern "C" long long ssd_scan_workspace_floats(int b, int S, int H, int P,
                                               int N, int Q) {
  return (long long)Workspace(b, S, H, P, N, Q).floats;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
