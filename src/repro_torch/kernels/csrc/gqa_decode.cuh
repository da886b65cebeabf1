// Shared device code of the single-token-style GQA attention kernels:
// paged decode (paged_decode.cu), paged speculative verify
// (paged_verify.cu) and dense flash-decode (decode_attention.cu).
//
// One block attends R = S * G query rows of one batch row b and one KV
// head kh: row r = s * G + g is query s of query head kh * G + g.  Query s
// sees the first
//   n_pos(s) = min(len0 + s, cap)
// positions of the row's KV sequence (decode: S = 1 and len0 = cache_len;
// verify: len0 = q_off + 1, a staircase).  The block walks the sequence
// once, C positions per iteration, loading each K/V row of the chunk into
// shared memory once for all R query rows; a query whose frontier lies
// before the chunk leaves its state unchanged.
//
// Every query row runs the same arithmetic in the same order whichever
// kernel it is in: a verify query s is bitwise the decode of that query at
// cache_len = n_pos(s), and a dense row is bitwise the paged row holding
// the same values, as long as the callers use the same chunk width C
// (`chunk_rows`).  Rounding points are those of the Pallas bodies: q and k
// are bf16, scores are summed in f32, the online softmax is f32 (running
// max starts at -1e30, the normaliser is clamped at 1e-30), p is cast to
// bf16 before P.V, the P.V sum is f32, the output is cast back to bf16.
// Rows past a query's frontier are skipped, never multiplied by 0: free
// slots read stale scratch rows that may hold anything (0 * NaN is NaN).
// Products that feed an add are written as explicit fmaf / __fmul_rn so
// that no contraction choice of the compiler can differ between kernels.
//
// What bounds these kernels on the H100: memory.  Each K/V row is read
// once per (row, kv-head) and carries 4 * Dh * R flops, far below the
// ~295 flop/byte where the tensor cores would become the limit.  Simple
// first: scalar FMAs from shared memory, no split of the sequence over
// blocks (B * K blocks fill only part of the card at small batch).  The
// kernels carry no __launch_bounds__: with __launch_bounds__(128) nvcc
// gave the paged kernel 40 registers instead of 48 and it ran slower.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gqa {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 128;   // target positions staged per iteration
constexpr size_t kSmemCap = 227 * 1024;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory of a block of R query rows, chunk width C and
// n_tbl staged table entries (0 for dense caches).
inline size_t smem_bytes(int R, int Dh, int C, int n_tbl) {
  return sizeof(float) * (2 * (size_t)R * Dh + (size_t)R * C + 3 * (size_t)R) +
         sizeof(int) * (n_tbl + (n_tbl & 1)) +
         2 * sizeof(__nv_bfloat16) * (size_t)C * (Dh + 2);
}

// Chunk width in positions: kChunkRows rounded down to whole blocks of bs
// (bs = 1 for a dense cache), halved while a decode block of G rows would
// not fit 200 KB.  Every kernel of a bitwise pair uses this same C.
inline int chunk_rows(int G, int Dh, int bs) {
  int cb = kChunkRows / bs;
  if (cb < 1) cb = 1;
  while (cb > 1 && smem_bytes(G, Dh, cb * bs, bs > 1 ? cb : 0) > 200 * 1024) cb /= 2;
  return cb * bs;
}

// Where a block finds the K/V rows of its batch row: for each layout, the
// table entries staged per chunk, their staging (all threads call it), and
// the buffer row of chunk position t.
struct PagedRows {            // pool (nb, bs, K, Dh) through a block table
  const int* table;           // this row's (mb,) table
  int nb, bs, mb;
};
struct DenseRows {            // cache (B, T, K, Dh): row b is one run of T
  size_t row0;                // index of position 0 of this row
};

__device__ __forceinline__ int table_entries(const PagedRows& r, int C) {
  return C / r.bs;
}
__device__ __forceinline__ int table_entries(const DenseRows&, int) { return 0; }

__device__ __forceinline__ void stage_table(const PagedRows& r, int* tbl_s,
                                            int n_tbl, int pos0, int n_pos) {
  const int blk0 = pos0 / r.bs;
  const int n_blk = (n_pos + r.bs - 1) / r.bs;
  for (int j = threadIdx.x; j < n_tbl; j += blockDim.x) {
    int bid = blk0 + j < n_blk ? r.table[blk0 + j] : 0;
    tbl_s[j] = bid < 0 ? 0 : (bid >= r.nb ? r.nb - 1 : bid);  // clamp like XLA
  }
  __syncthreads();
}
__device__ __forceinline__ void stage_table(const DenseRows&, int*, int, int,
                                            int) {}

__device__ __forceinline__ size_t buffer_row(const PagedRows& r,
                                             const int* tbl_s, int, int t) {
  return (size_t)tbl_s[t / r.bs] * r.bs + t % r.bs;
}
__device__ __forceinline__ size_t buffer_row(const DenseRows& r, const int*,
                                             int pos0, int t) {
  return r.row0 + pos0 + t;
}

// The block body.  q_b / o_b point at query row r = 0; query s is q_step
// elements after query s - 1 and head g of a query is Dh after head g - 1.
// kp / vp point at the K/V head kh of position (row) 0 of the buffer;
// positions are row_stride elements apart.
template <class Rows>
__device__ void attend_block(const __nv_bfloat16* __restrict__ q_b,
                             size_t q_step, __nv_bfloat16* __restrict__ o_b,
                             const __nv_bfloat16* __restrict__ kp,
                             const __nv_bfloat16* __restrict__ vp,
                             const Rows rows, size_t row_stride, int S, int G,
                             int Dh, int len0, int cap, int C, int vec,
                             float scale) {
  const int R = S * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ldk = Dh + 2;             // bf16 row stride: odd word stride
  const int n_tbl = table_entries(rows, C);

  extern __shared__ float smem[];
  float* q_s = smem;                  // (R, Dh)
  float* acc = q_s + R * Dh;          // (R, Dh)
  float* p_s = acc + R * Dh;          // (R, C)  bf16-rounded p
  float* m_s = p_s + R * C;           // (R,)  running max
  float* l_s = m_s + R;               // (R,)  running denominator
  float* a_s = l_s + R;               // (R,)  this chunk's rescale
  int* tbl_s = (int*)(a_s + R);       // (n_tbl,)
  __nv_bfloat16* k_s = (__nv_bfloat16*)(tbl_s + n_tbl + (n_tbl & 1));
  __nv_bfloat16* v_s = k_s + C * ldk; // (C, ldk) each

  for (int i = tid; i < R * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    q_s[i] = __bfloat162float(q_b[(size_t)(r / G) * q_step + (size_t)(r % G) * Dh + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int n_pos = min(len0 + S - 1, cap);   // the last query's frontier
  for (int pos0 = 0; pos0 < n_pos; pos0 += C) {
    const int n_load = min(C, n_pos - pos0);
    __syncthreads();                  // the previous chunk's readers are done
    stage_table(rows, tbl_s, n_tbl, pos0, n_pos);
    if (vec) {                        // 16-byte loads, 8 values each
      const int vpr = Dh / 8;
      for (int i = tid; i < n_load * vpr; i += blockDim.x) {
        const int t = i / vpr, c = i - t * vpr;
        const size_t off = buffer_row(rows, tbl_s, pos0, t) * row_stride + c * 8;
        const uint4 kw = *reinterpret_cast<const uint4*>(kp + off);
        const uint4 vw = *reinterpret_cast<const uint4*>(vp + off);
        unsigned* kd = reinterpret_cast<unsigned*>(k_s + t * ldk + c * 8);
        unsigned* vd = reinterpret_cast<unsigned*>(v_s + t * ldk + c * 8);
        kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
        vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
      }
    } else {
      for (int i = tid; i < n_load * Dh; i += blockDim.x) {
        const int t = i / Dh, d = i - t * Dh;
        const size_t off = buffer_row(rows, tbl_s, pos0, t) * row_stride + d;
        k_s[t * ldk + d] = kp[off];
        v_s[t * ldk + d] = vp[off];
      }
    }
    __syncthreads();
    // one warp per query row: scores, chunk max, p, chunk sum
    for (int r = warp; r < R; r += kWarps) {
      const int n_valid = min(C, min(len0 + r / G, cap) - pos0);
      if (n_valid <= 0) continue;     // chunk past this query's frontier
      const float* qr = q_s + r * Dh;
      float* pr = p_s + r * C;
      float m_loc = kNegInf;
      for (int t = lane; t < C; t += 32) {
        float s = kNegInf;
        if (t < n_valid) {
          const __nv_bfloat16* kr = k_s + t * ldk;
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], __bfloat162float(kr[d]), dot);
          s = __fmul_rn(dot, scale);
        }
        pr[t] = s;
        m_loc = fmaxf(m_loc, s);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(m_loc));
      float sum = 0.f;
      for (int t = lane; t < C; t += 32) {
        const float p = expf(pr[t] - m_new);
        sum += p;
        pr[t] = bf16_round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = fmaf(l_s[r], alpha, sum);
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v over each query's valid rows only
    for (int i = tid; i < R * Dh; i += blockDim.x) {
      const int r = i / Dh, d = i - r * Dh;
      const int n_valid = min(C, min(len0 + r / G, cap) - pos0);
      if (n_valid <= 0) continue;
      const float* pr = p_s + r * C;
      float a = __fmul_rn(acc[i], a_s[r]);
      for (int t = 0; t < n_valid; ++t)
        a = fmaf(pr[t], __bfloat162float(v_s[t * ldk + d]), a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    const float l = fmaxf(l_s[r], 1e-30f);
    o_b[(size_t)(r / G) * q_step + (size_t)(r % G) * Dh + d] = __float2bfloat16(acc[i] / l);
  }
}

// Raise the block's dynamic shared memory limit when it needs > 48 KB.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kSmemCap) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace gqa

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
