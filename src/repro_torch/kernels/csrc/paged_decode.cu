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
// block body shared with the verify and dense kernels).  One block per
// (b, kh) loads all G query heads of the group once, then walks the row's
// block table up to ceil(cache_len / bs) entries, a chunk of ~128
// positions (8 table entries at bs = 16) per iteration so that one
// iteration's loads are in flight together, with 16-byte row loads when
// Dh % 8 == 0.  One warp per query head scores the chunk and runs its
// online softmax with warp shuffles.  Blocks past the length are never
// read, and inside the last block the rows past the length are skipped.
//
// Layouts (all contiguous): q (B, H, Dh) bf16; pools (nb, bs, K, Dh) bf16;
// table (B, mb) int32; lens (B,) int32; out (B, H, Dh) bf16.

#include "gqa_decode.cuh"

namespace {

__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int H,
    int K, int Dh, int nb, int bs, int mb, int C, int vec, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K;
  const size_t q0 = ((size_t)b * H + (size_t)kh * G) * Dh;
  gqa::attend_block(q + q0, 0, out + q0, kp + (size_t)kh * Dh,
                    vp + (size_t)kh * Dh,
                    gqa::PagedRows{table + (size_t)b * mb, nb, bs, mb},
                    (size_t)K * Dh, 1, G, Dh, lens[b], mb * bs, C, vec, scale);
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, void* out, int B, int H, int K, int Dh, int nb, int bs,
    int mb, float scale, void* stream) {
  const int G = H / K;
  const int C = gqa::chunk_rows(G, Dh, bs);
  const size_t smem = gqa::smem_bytes(G, Dh, C, C / bs);
  cudaError_t e = gqa::allow_smem(paged_decode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // rows of Dh % 8 == 0 bf16 values start on 16-byte boundaries
  const int vec = (Dh % 8 == 0) && ((size_t)k_pool % 16 == 0) &&
                  ((size_t)v_pool % 16 == 0);
  dim3 grid(B, K);
  paged_decode_kernel<<<grid, gqa::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)table, (const int*)lens,
      (__nv_bfloat16*)out, H, K, Dh, nb, bs, mb, C, vec, scale);
  return (int)cudaGetLastError();
}
