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
// kernel runs a (B, K, mb) grid with the S queries in one tile; here one
// block per (b, kh) holds all S*G query rows of the group in shared memory
// and walks the row's table ONCE, up to ceil(min(q_off+S, mb*bs) / bs)
// entries in the decode kernel's chunks, so each K/V row is read from
// memory once for the S queries.  Each query keeps its own online-softmax
// state and counts its own valid rows per chunk; a chunk past its frontier
// leaves it unchanged.  The body is the decode kernel's (gqa_decode.cuh)
// with the same chunk width, so query s is bitwise the paged decode of
// that query at cache_len = min(q_off+s+1, mb*bs).
//
// Layouts (all contiguous): q (B, S, H, Dh) bf16; pools (nb, bs, K, Dh)
// bf16; table (B, mb) int32; q_off (B,) int32; out (B, S, H, Dh) bf16.

#include "gqa_decode.cuh"

namespace {

__global__ void paged_verify_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ q_off, __nv_bfloat16* __restrict__ out, int S,
    int H, int K, int Dh, int nb, int bs, int mb, int C, int vec,
    float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K;
  const size_t q0 = ((size_t)b * S * H + (size_t)kh * G) * Dh;
  gqa::attend_block(q + q0, (size_t)H * Dh, out + q0, kp + (size_t)kh * Dh,
                    vp + (size_t)kh * Dh,
                    gqa::PagedRows{table + (size_t)b * mb, nb, bs, mb},
                    (size_t)K * Dh, S, G, Dh, q_off[b] + 1, mb * bs, C, vec,
                    scale);
}

}  // namespace

extern "C" int paged_verify_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* q_off, void* out, int B, int S, int H, int K, int Dh, int nb,
    int bs, int mb, float scale, void* stream) {
  const int G = H / K;
  const int C = gqa::chunk_rows(G, Dh, bs);      // the decode kernel's chunk
  const size_t smem = gqa::smem_bytes(S * G, Dh, C, C / bs);
  cudaError_t e = gqa::allow_smem(paged_verify_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (Dh % 8 == 0) && ((size_t)k_pool % 16 == 0) &&
                  ((size_t)v_pool % 16 == 0);
  dim3 grid(B, K);
  paged_verify_kernel<<<grid, gqa::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)table, (const int*)q_off,
      (__nv_bfloat16*)out, S, H, K, Dh, nb, bs, mb, C, vec, scale);
  return (int)cudaGetLastError();
}
