// Shared device code of the single-token-style GQA attention kernels:
// paged decode (paged_decode.cu), paged speculative verify
// (paged_verify.cu) and dense flash-decode (decode_attention.cu).
//
// One CTA attends R = S * G query rows of one batch row b and one KV head
// kh over one split of the sequence: row r = s * G + g is query s of query
// head kh * G + g, and query s sees the first
//   n_pos(s) = min(len0 + s, cap)
// positions of the row's KV sequence (decode: S = 1 and len0 = cache_len;
// verify: len0 = q_off + 1, a staircase).  The grid is (B, K, n_split):
// split j covers positions [j W, (j + 1) W).  n_split comes from the static
// capacity (the host never reads a length); a split that starts past the
// row's last frontier exits at once.  Inside a split the CTA walks kChunk
// positions at a time, staging the next chunk's K/V rows with cp.async while
// this one is computed, and keeps an online softmax (m, l, acc) per query
// row.  Each split writes its (m, l, acc) to a workspace; the last CTA of a
// (row, kv head) to finish (an atomic counter, which it resets) merges the
// partials in split order, skipping the splits past each query's frontier.
// A row whose last frontier fits in one split writes its output directly.
//
// Every query row runs the same arithmetic in the same order whichever
// kernel it is in: a verify query s is bitwise the decode of that query at
// cache_len = n_pos(s), and a dense row is bitwise the paged row holding
// the same values, as long as the callers pass the same split width W
// (`split_plan` in kernels/decode_attention/ops.py computes it for all
// three).  The per-row sums do not depend on R or on which thread runs
// them: scores are one fmaf chain over d; the chunk's max and sum are a
// fixed tree over kChunk positions (eight lanes, eight positions each);
// P.V is summed by each warp over its quarter of the chunk and the four
// quarters are added in warp order; the
// merge folds split 0, then 1, ... (one split is taken as it is, so a
// merged row equals a direct one).  Rounding points are those of the
// Pallas bodies: q and k are bf16, scores are summed in f32, the online
// softmax is f32 (running max starts at -1e30, the normaliser is clamped at
// 1e-30), p is cast to bf16 before P.V, the P.V sum is f32, the output is
// cast back to bf16.  Rows past a query's frontier are skipped, never
// multiplied by 0: free slots read stale scratch rows that may hold
// anything (0 * NaN is NaN).  Products that feed an add are written as
// explicit fmaf / __fmul_rn so that no contraction choice of the compiler
// can differ between kernels.
//
// What bounds these kernels on the H100: memory.  Each K/V row is read
// once per (row, kv-head) and carries 4 * Dh * R flops, far below the
// ~295 flop/byte where the tensor cores would become the limit, so CUDA
// cores do the arithmetic.  At decode sizes the bytes are few (3.7 MB at
// the main shape, ~1 us) and a CTA's chain of dependent steps sets the
// time: its loads, one chunk's arithmetic at two or three warps per
// scheduler, the partial's write and count, and the last CTA's merge.
// What the design does about it: the split gives the card B * K *
// ceil(len / W) CTAs instead of B * K (245 instead of 40 at the main
// shape, W = 64) and shortens each CTA's walk to one or two chunks, whose
// loads go out as 16-byte cp.async before q is staged; each K row is read
// from shared memory once into registers for all R query rows; the item
// loops carry no integer division (each row's frontier and split count sit
// in shared memory); the softmax runs four rows a warp, eight lanes a row;
// and the merge stages every split's partials in one cp.async wave.  The
// kernels carry no __launch_bounds__: with __launch_bounds__(128) nvcc
// gave an earlier body 40 registers instead of 48 and it ran slower.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gqa {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                 // positions staged per step
constexpr int kQuarter = kChunk / kWarps;  // positions per warp in P.V
constexpr int kSubs = kThreads / kChunk;   // row subsets in the score phase
constexpr int kRedFloats = 4096;           // P.V partials of one row block
constexpr size_t kSmemCap = 227 * 1024;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Max and sum over each group of eight lanes (lanes 8g .. 8g + 7), the
// same butterfly in every group.
__device__ __forceinline__ float group8_max(float v) {
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of a CTA of R query rows at head width Dh, in floats from
// the start: q (R, Dh), acc (R, Dh), p (R, kChunk), m / l / alpha and the
// int frontier and split count (R each), the P.V partials of a row block
// (kWarps, rb, Dh), then `stages` K/V chunk buffers of kChunk rows of Dh +
// 8 bf16 (16-byte aligned rows, whose 16-byte loads by consecutive threads
// meet no bank conflict).  The merge stages the splits' accs over [red,
// end), merge_j splits at a time.
struct Smem {
  int rb, stages, ldk, merge_j;
  size_t acc, p, m, red, kv, bytes;   // float offsets; bytes in all
  __host__ __device__ Smem(int R, int Dh) {
    rb = kRedFloats / (kWarps * Dh);
    rb = rb < 1 ? 1 : (rb > R ? R : rb);
    ldk = Dh + 8;
    acc = (size_t)R * Dh;
    p = acc + (size_t)R * Dh;
    m = p + (size_t)R * kChunk;
    red = (m + 5 * (size_t)R + 3) & ~size_t(3);               // 16-byte align
    kv = (red + (size_t)kWarps * rb * Dh + 3) & ~size_t(3);
    const size_t chunk = 2 * (size_t)kChunk * ldk * sizeof(__nv_bfloat16);
    stages = 2;                        // double-buffered unless it won't fit
    bytes = kv * sizeof(float) + stages * chunk;
    if (bytes > kSmemCap) {
      stages = 1;
      bytes -= chunk;
    }
    merge_j = (int)((bytes / sizeof(float) - red) / ((size_t)R * Dh));
  }
};

// Where a CTA finds the K/V rows of its batch row: the buffer row of
// logical position t.
struct PagedRows {            // pool (nb, bs, K, Dh) through a block table
  const int* table;           // this row's (mb,) table
  int nb, bs;
  __device__ __forceinline__ size_t row(int t) const {
    int bid = table[t / bs];
    bid = bid < 0 ? 0 : (bid >= nb ? nb - 1 : bid);    // clamp like XLA
    return (size_t)bid * bs + t % bs;
  }
};
struct DenseRows {            // cache (B, T, K, Dh): row b is one run of T
  size_t row0;                // index of position 0 of this row
  __device__ __forceinline__ size_t row(int t) const { return row0 + t; }
};

// Where a (row, kv head)'s split partials and its counter live.  part_acc
// (n_split, R, Dh) and part_ml (n_split, R, 2) floats of a workspace the
// wrapper allocates; counter an int that is 0 between launches.
struct Partials {
  float* acc;
  float* ml;
  int* counter;
};

// The partials of (row, kv head) bk of n_bk in a workspace of n_bk *
// n_split * R * (Dh + 2) floats: every acc first, then every (m, l).
__device__ __forceinline__ Partials partials(float* ws, int* counters, int bk,
                                             int n_bk, int R, int Dh) {
  const size_t per = (size_t)gridDim.z * R;     // n_split * R rows
  return {ws + bk * per * Dh, ws + n_bk * per * Dh + bk * per * 2,
          counters + bk};
}

// The split body, for split blockIdx.z.  q_b / o_b point at query row r =
// 0; query s is q_step elements after query s - 1 and head g of a query is
// Dh after head g - 1.  kp / vp point at the K/V head kh of position (row)
// 0 of the buffer; positions are row_stride elements apart.  kWide (the
// verify kernel's S * G rows) groups more rows per score pass and per V
// load; the grouping changes no row's sums, so both widths stay bitwise
// alike.
template <bool kWide, class Rows>
__device__ void attend_split(const __nv_bfloat16* __restrict__ q_b,
                             size_t q_step, __nv_bfloat16* __restrict__ o_b,
                             const __nv_bfloat16* __restrict__ kp,
                             const __nv_bfloat16* __restrict__ vp,
                             const Rows rows, size_t row_stride, int S, int G,
                             int Dh, int len0, int cap, int W, int vec,
                             float scale, const Partials part) {
  constexpr int kChains = kWide ? 4 : 2;     // rows per score pass
  constexpr int kPvRows = kWide ? 8 : 4;     // rows sharing a V load in P.V
  const int R = S * G;
  const int n_last = min(len0 + S - 1, cap);     // the last query's frontier
  const int n_active = max(1, (n_last + W - 1) / W);
  const int split = blockIdx.z;
  if (split >= n_active) return;
  const int s0 = split * W, s1 = min(s0 + W, n_last);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Smem L(R, Dh);
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc = smem + L.acc;
  float* p_s = smem + L.p;
  float* m_s = smem + L.m;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  int* np_s = reinterpret_cast<int*>(a_s + R);   // each row's frontier
  int* nj_s = np_s + R;                          // and split count (merge)
  float* red = smem + L.red;
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  const int ldk = L.ldk;
  auto k_buf = [&](int st) { return kv_s + (size_t)st * 2 * kChunk * ldk; };

  // f(i, r, d) over this thread's items i = r * Dh + d of rows [0, n_rows)
  // of an (R, Dh) array, with no division in the loop
  const int r_step = kThreads / Dh, d_step = kThreads % Dh;
  const int r_first = tid / Dh, d_first = tid % Dh;
  auto for_items = [&](int n_rows, auto&& f) {
    for (int i = tid, r = r_first, d = d_first; i < n_rows * Dh;
         i += kThreads, r += r_step, d += d_step) {
      if (d >= Dh) {
        d -= Dh;
        ++r;
      }
      f(i, r, d);
    }
  };

  // chunk c's K rows, then its V rows, into buffer st: 16-byte cp.async
  // when rows are 16-byte aligned, plain loads otherwise
  const int n_chunks = s1 > s0 ? (s1 - s0 + kChunk - 1) / kChunk : 0;
  auto load = [&](int c, int st) {
    const int pos0 = s0 + c * kChunk, n_load = min(kChunk, s1 - pos0);
    __nv_bfloat16* ks = k_buf(st);
    __nv_bfloat16* vs = ks + kChunk * ldk;
    if (vec) {
      const int vpr = Dh / 8;
      for (int i = tid; i < n_load * vpr; i += kThreads) {
        const int t = i / vpr, c8 = (i - t * vpr) * 8;
        const size_t off = rows.row(pos0 + t) * row_stride + c8;
        cp_async16(ks + t * ldk + c8, kp + off);
        cp_async16(vs + t * ldk + c8, vp + off);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < n_load * Dh; i += kThreads) {
        const int t = i / Dh, d = i - t * Dh;
        const size_t off = rows.row(pos0 + t) * row_stride + d;
        ks[t * ldk + d] = kp[off];
        vs[t * ldk + d] = vp[off];
      }
    }
  };
  // the first chunks' loads go out before q is staged
  for (int c = 0; c < min(L.stages, n_chunks); ++c) load(c, c);
  for (int r = tid; r < R; r += kThreads) {
    np_s[r] = min(len0 + r / G, cap);
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for_items(R, [&](int i, int r, int d) {
    q_s[i] = __bfloat162float(q_b[(size_t)(r / G) * q_step + (size_t)(r % G) * Dh + d]);
    acc[i] = 0.f;
  });

  for (int c = 0; c < n_chunks; ++c) {
    const int pos0 = s0 + c * kChunk;
    const int st = L.stages == 2 ? (c & 1) : 0;
    if (vec) {
      if (L.stages == 2 && c + 1 < n_chunks) cp_async_wait<1>();  // c landed
      else cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = k_buf(st);
    const __nv_bfloat16* vs = ks + kChunk * ldk;

    // scores: thread (t, sub) reads K row t into registers 64 values at a
    // time and scores it against the rows r = sub, sub + kSubs, ...
    {
      const int t = tid % kChunk, sub = tid / kChunk;
      for (int d0 = 0; d0 < Dh; d0 += 64) {
        const int nd = min(64, Dh - d0);
        float kr[64];
        if (vec) {
#pragma unroll
          for (int i = 0; i < 64; i += 8) {
            if (i < nd) {
              const uint4 w = *reinterpret_cast<const uint4*>(ks + t * ldk + d0 + i);
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h[e]);
                kr[i + 2 * e] = f.x;
                kr[i + 2 * e + 1] = f.y;
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (i < nd) kr[i] = __bfloat162float(ks[t * ldk + d0 + i]);
        }
        // kChains rows at a time (independent fmaf chains), each only
        // where t lies before its query's frontier
        for (int r = sub; r < R; r += kChains * kSubs) {
          bool on[kChains], any = false;
          const float* qr[kChains];
          float dot[kChains];
#pragma unroll
          for (int j = 0; j < kChains; ++j) {
            const int rj = r + j * kSubs;
            on[j] = rj < R && pos0 + t < np_s[rj];
            any = any || on[j];
            qr[j] = q_s + (on[j] ? rj : r) * Dh + d0;
            dot[j] = d0 && on[j] ? p_s[rj * kChunk + t] : 0.f;
          }
          if (!any) continue;
          if (vec) {                              // 16-byte q reads
#pragma unroll
            for (int i = 0; i < 64; i += 4) {
              if (i < nd) {
#pragma unroll
                for (int j = 0; j < kChains; ++j) {
                  const float4 a = *reinterpret_cast<const float4*>(qr[j] + i);
                  dot[j] = fmaf(a.x, kr[i], dot[j]);
                  dot[j] = fmaf(a.y, kr[i + 1], dot[j]);
                  dot[j] = fmaf(a.z, kr[i + 2], dot[j]);
                  dot[j] = fmaf(a.w, kr[i + 3], dot[j]);
                }
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              if (i < nd) {
#pragma unroll
                for (int j = 0; j < kChains; ++j) dot[j] = fmaf(qr[j][i], kr[i], dot[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kChains; ++j)
            if (on[j]) p_s[(r + j * kSubs) * kChunk + t] = dot[j];
        }
      }
      for (int r = sub; r < R; r += kSubs)
        p_s[r * kChunk + t] = pos0 + t < np_s[r]
                                  ? __fmul_rn(p_s[r * kChunk + t], scale)
                                  : kNegInf;
    }
    __syncthreads();

    // eight lanes per query row, four rows per warp at once: chunk max, p,
    // chunk sum (each lane's eight positions in order, then a 3-step
    // butterfly), the rescale
    for (int rw = warp * 4; rw < R; rw += 4 * kWarps) {
      const int r = rw + lane / 8, l8 = lane % 8;
      const bool live = r < R && np_s[r] > pos0;   // chunk before the frontier
      float* pr = p_s + (live ? r : 0) * kChunk;
      float m_loc = kNegInf;
      if (live) {
#pragma unroll
        for (int k = 0; k < kChunk / 8; ++k) m_loc = fmaxf(m_loc, pr[l8 + 8 * k]);
      }
      const float m_prev = live ? m_s[r] : kNegInf;
      const float m_new = fmaxf(m_prev, group8_max(m_loc));
      float sum = 0.f;
      if (live) {
#pragma unroll
        for (int k = 0; k < kChunk / 8; ++k) {
          const float p = expf(pr[l8 + 8 * k] - m_new);
          sum += p;
          pr[l8 + 8 * k] = bf16_round(p);
        }
      }
      sum = group8_sum(sum);
      if (live && l8 == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = fmaf(l_s[r], alpha, sum);
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // P.V, a block of rows at a time: warp w sums its quarter of the
    // chunk's positions for each (row, d); the quarters are added in warp
    // order into acc * alpha
    for (int rb0 = 0; rb0 < R; rb0 += L.rb) {
      const int nr = min(L.rb, R - rb0);
      const int t0 = warp * kQuarter;
      float* red_w = red + (size_t)warp * L.rb * Dh;
      if (vec) {
        // lane owns column pairs 2 lane + 64 k; kPvRows rows at a time
        // share each V load, each (row, column) one fmaf chain over t
        for (int j0 = 0; j0 < nr; j0 += kPvRows) {
          int t1[kPvRows], t_end = t0;
#pragma unroll
          for (int j = 0; j < kPvRows; ++j) {
            t1[j] = j0 + j < nr ? min(t0 + kQuarter, np_s[rb0 + j0 + j] - pos0)
                                : t0;
            t_end = max(t_end, t1[j]);
          }
          for (int c2 = 2 * lane; c2 < Dh; c2 += 64) {
            float part[kPvRows][2] = {};
#pragma unroll 4
            for (int t = t0; t < t_end; ++t) {
              const float2 v = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(vs + t * ldk + c2));
#pragma unroll
              for (int j = 0; j < kPvRows; ++j) {
                if (t < t1[j]) {
                  const float p = p_s[(rb0 + j0 + j) * kChunk + t];
                  part[j][0] = fmaf(p, v.x, part[j][0]);
                  part[j][1] = fmaf(p, v.y, part[j][1]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kPvRows; ++j) {
              if (j0 + j < nr) {
                red_w[(j0 + j) * Dh + c2] = part[j][0];
                red_w[(j0 + j) * Dh + c2 + 1] = part[j][1];
              }
            }
          }
        }
      } else {
        for (int i = lane; i < nr * Dh; i += 32) {
          const int r = rb0 + i / Dh, d = i % Dh;
          const int t1 = min(t0 + kQuarter, np_s[r] - pos0);
          const float* pr = p_s + r * kChunk;
          float part = 0.f;
          for (int t = t0; t < t1; ++t)
            part = fmaf(pr[t], __bfloat162float(vs[t * ldk + d]), part);
          red_w[i] = part;
        }
      }
      __syncthreads();
      const size_t q = (size_t)L.rb * Dh;
      for_items(nr, [&](int i, int rr, int) {
        const int r = rb0 + rr;
        if (np_s[r] <= pos0) return;
        float s = red[i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += red[w * q + i];   // warp order
        float& a = acc[(size_t)rb0 * Dh + i];
        a = __fmul_rn(a, a_s[r]) + s;
      });
      __syncthreads();
    }
    if (c + L.stages < n_chunks) load(c + L.stages, st);  // the freed buffer
  }
  __syncthreads();

  auto out = [&](int r, int d, float o, float l) {
    o_b[(size_t)(r / G) * q_step + (size_t)(r % G) * Dh + d] =
        __float2bfloat16(o / fmaxf(l, 1e-30f));
  };
  if (n_active == 1) {                 // one split: no merge
    for_items(R, [&](int i, int r, int d) { out(r, d, acc[i], l_s[r]); });
    return;
  }

  // this split's partials, for the rows whose frontier reaches into it;
  // one fence by one thread after the CTA's barrier, then the count (the
  // pattern of a cooperative grid barrier)
  for_items(R, [&](int i, int r, int) {
    if (np_s[r] > s0) part.acc[(size_t)split * R * Dh + i] = acc[i];
  });
  for (int r = tid; r < R; r += kThreads) {
    if (np_s[r] > s0) {
      part.ml[((size_t)split * R + r) * 2] = m_s[r];
      part.ml[((size_t)split * R + r) * 2 + 1] = l_s[r];
    }
  }
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(part.counter, 1) == n_active - 1;
    if (last) {
      atomicExch(part.counter, 0);     // ready for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;

  // merge, in split order, the splits that hold positions of each query:
  // stage every split's (m, l) and fold each row's into the factors (a_j,
  // b_j) of its acc terms and its merged normaliser; then stage the accs,
  // merge_j splits at a time, and fold them into acc
  const int per = R * Dh;
  float* buf = red;
  auto stage = [&](int j0) {           // splits j0 .. j0 + merge_j - 1
    const int n = min(L.merge_j, n_active - j0) * per;
    const float* src = part.acc + (size_t)j0 * per;
    if (vec) {                         // rows of Dh % 8 == 0 floats
      for (int i = 4 * tid; i < n; i += 4 * kThreads) cp_async16(buf + i, src + i);
      cp_async_commit();
    } else {
      for (int i = tid; i < n; i += kThreads) buf[i] = __ldcg(src + i);
    }
  };
  stage(0);                            // in flight while the factors fold
  float* ml = p_s;                     // (n_active, R, 2), free by now
  for (int i = tid; i < n_active * R * 2; i += kThreads)
    ml[i] = __ldcg(part.ml + i);
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) {
    const int nj = min(n_active, (np_s[r] + W - 1) / W);
    nj_s[r] = nj;
    if (nj <= 0) continue;
    float m = ml[2 * r], l = ml[2 * r + 1];
    for (int j = 1; j < nj; ++j) {
      float* f = ml + 2 * ((size_t)j * R + r);
      const float mx = fmaxf(m, f[0]);
      const float a = expf(m - mx), b = expf(f[0] - mx);
      l = fmaf(l, a, __fmul_rn(f[1], b));
      m = mx;
      f[0] = a;                        // (m_j, l_j) -> (a_j, b_j)
      f[1] = b;
    }
    l_s[r] = l;
  }
  for (int j0 = 0; j0 < n_active; j0 += L.merge_j) {
    const int jn = min(L.merge_j, n_active - j0);
    if (j0 > 0) stage(j0);
    if (vec) cp_async_wait<0>();
    __syncthreads();
    for_items(R, [&](int i, int r, int) {
      float o = j0 == 0 ? buf[i] : acc[i];
      for (int j = max(j0, 1); j < min(j0 + jn, nj_s[r]); ++j) {
        const float* f = ml + 2 * ((size_t)j * R + r);
        o = fmaf(o, f[0], __fmul_rn(buf[(size_t)(j - j0) * per + i], f[1]));
      }
      acc[i] = o;
    });
    __syncthreads();
  }
  for_items(R, [&](int i, int r, int d) {
    if (nj_s[r] > 0) out(r, d, acc[i], l_s[r]);
    else out(r, d, 0.f, 0.f);
  });
}

// Raise the kernel's dynamic shared memory limit when a launch needs more
// than 48 KB, once per device and size.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kSmemCap) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem <= granted[dev & 63]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) granted[dev & 63] = smem;
  return e;
}

// A split plan the kernels take: n_split splits of W positions, W a
// multiple of kChunk, and at most kChunk / 2 splits (the merge stages the
// splits' (m, l) in the (R, kChunk) p buffer); a merge needs room for one
// split's accs beside them.
inline cudaError_t check_plan(int W, int n_split, const Smem& L) {
  return (W <= 0 || W % kChunk || n_split <= 0 || n_split > kChunk / 2 ||
          (n_split > 1 && L.merge_j < 1))
             ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace gqa

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
