// Paged k-query GQA attention for speculative verify, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_verify_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_paged_verify_kernel`).
//
// What it computes: the S = k+1 verify queries of batch row b sit at
// absolute positions q_off[b] + s; query s of head h = kh*G + g attends
//   out[b,s,h] = softmax_t(q[b,s,h] . k[t] * scale) @ v[t],
//   t < min(q_off[b] + s + 1, mb*bs)       (a staircase mask),
// where logical position t of row b lives at pool[table[b, t/bs], t%bs, kh].
// A query past the table's reach (q_off + s >= mb*bs: the engine routes
// its write to the scratch block and acceptance clamps it away) sees the
// whole table.
//
// What bounds it on the H100: memory, as the decode kernel.  The Pallas
// kernel runs a (B, K, mb) grid with the S queries in one tile; here a CTA
// per (b, kh, split of W positions) holds all S*G query rows of the group
// in shared memory and walks its split of the row's table once, up to
// min(q_off+S, mb*bs) positions in the decode kernel's chunks, so each K/V
// row is read from memory once for the S queries.  Each query keeps its own
// online-softmax state and counts its own valid rows per chunk; a chunk
// past its frontier leaves it unchanged, and the merge of the splits skips
// the splits past it.  The body is the decode kernel's (gqa_decode.cuh)
// with the same split width, so query s is bitwise the paged decode of
// that query at cache_len = min(q_off+s+1, mb*bs).
//
// Layouts (all contiguous): q (B, S, H, Dh) bf16; pools (nb, bs, K, Dh)
// bf16; table (B, mb) int32; q_off (B,) int32; out (B, S, H, Dh) bf16; ws
// (B, K, n_split, S*G, Dh + 2) f32; counters (B * K,) int32, 0 between
// launches.

#include "gqa_decode.cuh"

namespace {

__global__ void paged_verify_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ q_off, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int S, int H, int K,
    int Dh, int nb, int bs, int mb, int W, int vec, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K, bk = b * K + kh;
  const size_t q0 = ((size_t)b * S * H + (size_t)kh * G) * Dh;
  gqa::attend_split<true>(q + q0, (size_t)H * Dh, out + q0, kp + (size_t)kh * Dh,
                    vp + (size_t)kh * Dh,
                    gqa::PagedRows{table + (size_t)b * mb, nb, bs},
                    (size_t)K * Dh, S, G, Dh, q_off[b] + 1, mb * bs, W, vec,
                    scale,
                    gqa::partials(ws, counters, bk, gridDim.x * K, S * G, Dh));
}

}  // namespace

extern "C" int paged_verify_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* q_off, void* out, void* ws, void* counters, int B, int S,
    int H, int K, int Dh, int nb, int bs, int mb, int W, int n_split,
    float scale, void* stream) {
  const int G = H / K;
  const gqa::Smem L(S * G, Dh);
  const size_t smem = L.bytes;
  cudaError_t e = gqa::check_plan(W, n_split, L);
  if (e == cudaSuccess) e = gqa::allow_smem(paged_verify_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (Dh % 8 == 0) && ((size_t)k_pool % 16 == 0) &&
                  ((size_t)v_pool % 16 == 0);
  dim3 grid(B, K, n_split);
  paged_verify_kernel<<<grid, gqa::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)table, (const int*)q_off,
      (__nv_bfloat16*)out, (float*)ws, (int*)counters, S, H, K, Dh, nb, bs,
      mb, W, vec, scale);
  return (int)cudaGetLastError();
}
