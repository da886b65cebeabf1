// Mamba-2 SSD chunked scan for Hopper (sm_90a): the SSM mixer's prefill.
//
// Replaces the TPU kernel `ssd_scan_kernel`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`).
//
// What it computes, per (batch b, head h), over chunks of Q steps in order,
// all in f32 (A_h < 0, dt >= 0, so cum falls within a chunk):
//   dA = dt * A_h ;  cum = inclusive cumsum(dA) ;  total = cum[last]
//   y[q]  = sum_{j <= q} (C_q . B_j) exp(cum_q - cum_j) dt_j x_j
//         + exp(cum_q) C_q . state                 (the state BEFORE the chunk)
//   state = exp(total) state + sum_j B_j (x) x_j dt_j exp(total - cum_j)
// x (b,S,H,P), y (b,S,H,P) in T (bf16 or f32); dt (b,S,H) f32; A (H,) f32;
// B, C (b,S,G,N) in T, group g = h / (H/G) serving head h; the final state
// (b,H,N,P) f32 is written once, after the last chunk.  The last chunk may
// hold fewer than Q steps: its missing rows are taken as dt = 0, x = B = C
// = 0, which is what the reference's padding computes (exp(0) = 1 and no
// contribution, so the carried state is exact).
//
// What bounds it on the H100: f32 arithmetic.  At the main path's shape
// (mamba2-370m's 1023-token admission: H = 32, P = 64, N = 128, G = 1,
// Q = 256, 4 chunks) the causal work of the chunked form is ~1.6 GFLOP
// (C.B^T over the causal (Q,Q) half once per group; per head its product
// with x, the carry-in and the state update) against ~10 MB of operands:
// ~160 flop/byte, far above the card's f32 balance (~20), so the 67
// TFLOP/s f32 rate bounds it (~25 us).  What the design does about it: the
// (Q,Q) decay matrix is never held whole (256 KB at Q = 256, more than a
// block's shared memory): each block walks 64-row q tiles, and for each
// the 64-column j tiles up to the diagonal only, computing C_q.B_j^T as a
// register-tiled product (each thread a 4 x 4 micro tile, two 16-byte
// shared-memory reads per 16 FMAs), masking j > q BEFORE the exponent
// (above the diagonal cum_q - cum_j > 0 and exp may overflow; inf * 0
// would be NaN), then folding the tile into y.  The state update rides
// the last q tile's j loop, which visits every j tile of the chunk, so B
// is staged once per tile pair.  The (N, 16)
// state tile lives in shared memory across chunks.  Not the TPU grid:
// Pallas walks (b, H, chunk) sequentially with the state in VMEM; here one
// block per (b, h, 16-column tile of P) walks the chunks itself (the P
// columns are independent in every term), which gives 128 blocks for the
// main shape instead of 32, at the price of recomputing C.B^T per column
// tile.  Tensor cores (TF32 or bf16 `mma`) and sharing C.B^T across heads
// (it does not depend on h when G = 1) are later work.
//
// Requirements (checked by the wrapper): N <= 128, Q <= 1024, H % G == 0,
// tensors contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;          // P columns per block
constexpr int kT = 64;           // rows of a q tile and of a j tile
constexpr int kLd = kT + 4;      // padded stride of the transposed tiles;
                                 // keeps every row 16-byte aligned
constexpr int kMaxN = 128;       // state rows: 16 thread rows x 8 registers
constexpr int kNPer = kMaxN / 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rows r0 .. r0 + kT - 1 of the chunk starting at t0, group g, as f32 and
// transposed: dst[n * kLd + r].  Rows at or past qv are 0.
template <typename T>
__device__ __forceinline__ void load_rows_t(const T* __restrict__ src,
                                            float* __restrict__ dst, int bi,
                                            int S, int G, int g, int N, int t0,
                                            int r0, int qv) {
  for (int i = threadIdx.x; i < kT * N; i += kThreads) {
    const int r = i / N, n = i % N;
    float v = 0.f;
    if (r0 + r < qv)
      v = to_f(src[(((size_t)bi * S + t0 + r0 + r) * G + g) * N + n]);
    dst[n * kLd + r] = v;
  }
}

template <typename T>
__global__ void ssd_scan_kernel(const T* __restrict__ x,
                                const float* __restrict__ dt,
                                const float* __restrict__ A,
                                const T* __restrict__ Bm,
                                const T* __restrict__ Cm, T* __restrict__ y,
                                float* __restrict__ state_out, int S, int H,
                                int P, int G, int N, int Q, int Qp) {
  extern __shared__ __align__(16) float smem[];
  float* s_cum = smem;                 // (Qp)      cumsum of dt * A
  float* s_dout = s_cum + Qp;          // (Qp)      exp(total - cum)
  float* s_x = s_dout + Qp;            // (Qp, kPT) x * dt
  float* s_S = s_x + Qp * kPT;         // (N, kPT)  the carried state
  float* s_Ct = s_S + N * kPT;         // (N, kLd)  C of a q tile, transposed
  float* s_Bt = s_Ct + N * kLd;        // (N, kLd)  B of a j tile, transposed
  float* s_M = s_Bt + N * kLd;         // (kT, kLd) the masked decay tile

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h];
  const int tx = tid % 16, ty = tid / 16;   // micro tile rows ty*4+i,
                                            // columns tx*4+k
  const int pc = tid % kPT, rg = tid / kPT; // y rows rg*4+i, state rows rg+16*i

  for (int i = tid; i < N * kPT; i += kThreads) s_S[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int qv = min(Q, S - t0);          // valid rows of this chunk
    const int n_tiles = (qv + kT - 1) / kT;
    const int rows = n_tiles * kT;          // rows the tiles touch, <= Qp
    __syncthreads();                        // last chunk's readers are done

    if (tid < 32) {                         // inclusive cumsum, one warp
      float carry = 0.f;
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int r = r0 + tid;
        float v = r < qv ? dt[((size_t)bi * S + t0 + r) * H + h] * a : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        s_cum[r] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int i = tid; i < rows * kPT; i += kThreads) {
      const int r = i / kPT, p = i % kPT;
      float v = 0.f;
      if (r < qv && p0 + p < P) {
        const size_t row = (size_t)bi * S + t0 + r;
        v = to_f(x[(row * H + h) * P + p0 + p]) * dt[row * H + h];
      }
      s_x[i] = v;
    }
    __syncthreads();
    const float total = s_cum[qv - 1];
    for (int r = tid; r < rows; r += kThreads)
      s_dout[r] = expf(total - s_cum[r]);

    float st[kNPer];
#pragma unroll
    for (int i = 0; i < kNPer; ++i) st[i] = 0.f;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kT;
      const bool last = qt == n_tiles - 1;
      load_rows_t(Cm, s_Ct, bi, S, G, g, N, t0, q0, qv);
      __syncthreads();

      // carry-in from the state before this chunk: exp(cum_q) C_q . state
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < N; ++n) {
        const float4 cq =
            *reinterpret_cast<const float4*>(s_Ct + n * kLd + rg * 4);
        const float sv = s_S[n * kPT + pc];
        acc[0] = fmaf(cq.x, sv, acc[0]);
        acc[1] = fmaf(cq.y, sv, acc[1]);
        acc[2] = fmaf(cq.z, sv, acc[2]);
        acc[3] = fmaf(cq.w, sv, acc[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] *= expf(s_cum[q0 + rg * 4 + i]);

      for (int jt = 0; jt <= qt; ++jt) {    // j tiles up to the diagonal
        const int j0 = jt * kT;
        load_rows_t(Bm, s_Bt, bi, S, G, g, N, t0, j0, qv);
        __syncthreads();

        float m[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) m[i][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 cq =
              *reinterpret_cast<const float4*>(s_Ct + n * kLd + ty * 4);
          const float4 bj =
              *reinterpret_cast<const float4*>(s_Bt + n * kLd + tx * 4);
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
          const float bv[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) m[i][k] = fmaf(cv[i], bv[k], m[i][k]);
        }
        // L = exp(cum_q - cum_j) for j <= q; above the diagonal the term
        // is skipped, never exp'd and multiplied by a zero mask
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty * 4 + i;
          const float cum_q = s_cum[q];
          float out[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tx * 4 + k;
            out[k] = j <= q ? m[i][k] * expf(cum_q - s_cum[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(s_M + (ty * 4 + i) * kLd + tx * 4) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();

        for (int jl = 0; jl < kT; ++jl) {   // y += M @ (x dt)
          const float xv = s_x[(j0 + jl) * kPT + pc];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i] = fmaf(s_M[(rg * 4 + i) * kLd + jl], xv, acc[i]);
        }
        if (last) {   // this q tile's j loop visits every j of the chunk
          for (int jl = 0; jl < kT; ++jl) {
            const float xw = s_x[(j0 + jl) * kPT + pc] * s_dout[j0 + jl];
#pragma unroll
            for (int i = 0; i < kNPer; ++i) {
              const int n = rg + 16 * i;
              if (n < N) st[i] = fmaf(s_Bt[n * kLd + jl], xw, st[i]);
            }
          }
        }
        __syncthreads();                    // s_Bt, s_M are rewritten next
      }

      if (p0 + pc < P) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + rg * 4 + i;
          if (q < qv)
            y[(((size_t)bi * S + t0 + q) * H + h) * P + p0 + pc] =
                from_f<T>(acc[i]);
        }
      }
    }

    // state <- exp(total) state + B^T (x dt exp(total - cum)); each thread
    // owns its (n, pc) entries, and every reader of the old state passed
    // the last __syncthreads of the tile loop
    const float dec = expf(total);
#pragma unroll
    for (int i = 0; i < kNPer; ++i) {
      const int n = rg + 16 * i;
      if (n < N) s_S[n * kPT + pc] = fmaf(dec, s_S[n * kPT + pc], st[i]);
    }
  }

  __syncthreads();
  for (int i = tid; i < N * kPT; i += kThreads) {
    const int n = i / kPT, p = i % kPT;
    if (p0 + p < P)
      state_out[(((size_t)bi * H + h) * N + n) * P + p0 + p] = s_S[i];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, int b, int S, int H, int P,
           int G, int N, int Q, void* stream) {
  if (b == 0 || H == 0 || P == 0) return 0;  // nothing to compute
  if (S <= 0 || Q <= 0 || N <= 0 || N > kMaxN || G <= 0 || H % G ||
      b > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int Qp = (Q + kT - 1) / kT * kT;
  const size_t smem = sizeof(float) * ((size_t)2 * Qp + (size_t)Qp * kPT +
                                       (size_t)N * kPT + (size_t)2 * N * kLd +
                                       (size_t)kT * kLd);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kPT - 1) / kPT, H, b);
  ssd_scan_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (T*)y, (float*)state, S, H, P, G, N, Q, Qp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y,
                             void* state, int b, int S, int H, int P, int G,
                             int N, int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, b, S, H, P, G, N, Q,
                               stream);
}

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y, void* state,
                            int b, int S, int H, int P, int G, int N, int Q,
                            void* stream) {
  return launch<float>(x, dt, A, B, C, y, state, b, S, H, P, G, N, Q, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
