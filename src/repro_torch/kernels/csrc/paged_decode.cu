// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_paged_kernel`).
//
// What it computes: for every batch row b and query head h = kh*G + g,
//   out[b,h] = softmax_t(q[b,h] . k[t] * scale) @ v[t],   t < cache_len[b],
// where logical position t of row b lives at
//   pool[table[b, t / bs], t % bs, kh].
//
// What bounds it on the H100: memory (see gqa_decode.cuh, which holds the
// body shared with the verify and dense kernels).  The grid is (B, K,
// n_split): a CTA per (b, kh, split of W positions) loads the G query heads
// of the group once and walks its split of the row's block table in chunks,
// 16-byte cp.async row loads when Dh % 8 == 0, reading each live K/V row
// once; blocks past the length are never read, and inside the last block
// the rows past the length are skipped.  The splits of a row merge in the
// same launch (workspace and per-(b, kh) counters from the wrapper).
//
// Layouts (all contiguous): q (B, H, Dh) bf16; pools (nb, bs, K, Dh) bf16;
// table (B, mb) int32; lens (B,) int32; out (B, H, Dh) bf16; ws (B, K,
// n_split, G, Dh + 2) f32; counters (B * K,) int32, 0 between launches.

#include "gqa_decode.cuh"

namespace {

__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int H, int K, int Dh,
    int nb, int bs, int mb, int W, int vec, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K, bk = b * K + kh;
  const size_t q0 = ((size_t)b * H + (size_t)kh * G) * Dh;
  gqa::attend_split<false>(q + q0, 0, out + q0, kp + (size_t)kh * Dh,
                    vp + (size_t)kh * Dh,
                    gqa::PagedRows{table + (size_t)b * mb, nb, bs},
                    (size_t)K * Dh, 1, G, Dh, lens[b], mb * bs, W, vec, scale,
                    gqa::partials(ws, counters, bk, gridDim.x * K, G, Dh));
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, void* out, void* ws, void* counters, int B, int H,
    int K, int Dh, int nb, int bs, int mb, int W, int n_split, float scale,
    void* stream) {
  const int G = H / K;
  const gqa::Smem L(G, Dh);
  const size_t smem = L.bytes;
  cudaError_t e = gqa::check_plan(W, n_split, L);
  if (e == cudaSuccess) e = gqa::allow_smem(paged_decode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // rows of Dh % 8 == 0 bf16 values start on 16-byte boundaries
  const int vec = (Dh % 8 == 0) && ((size_t)k_pool % 16 == 0) &&
                  ((size_t)v_pool % 16 == 0);
  dim3 grid(B, K, n_split);
  paged_decode_kernel<<<grid, gqa::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)table, (const int*)lens,
      (__nv_bfloat16*)out, (float*)ws, (int*)counters, H, K, Dh, nb, bs, mb,
      W, vec, scale);
  return (int)cudaGetLastError();
}
