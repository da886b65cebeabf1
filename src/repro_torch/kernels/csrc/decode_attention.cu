// Dense single-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_attention_kernel`
// (src/repro/kernels/decode_attention/kernel.py).
//
// What it computes: for every batch row b and query head h = kh*G + g,
//   out[b,h] = softmax_t(q[b,h] . k[b,t] * scale) @ v[b,t],
//   t < min(cache_len[b], T),
// over dense per-row caches (B, T, K, Dh): the kv="dense" ablation's ring.
//
// What bounds it on the H100: memory, as the paged decode kernel.  The
// Pallas wrapper transposes the caches to (B, K, T, Dh) and tiles T by 128;
// here the kernel reads the (B, T, K, Dh) ring in place, with no transpose
// copy: a dense row is one contiguous run of T positions, walked by the
// paged decode kernel's body (gqa_decode.cuh) with a contiguous address map
// and the same split width and chunks.  So a dense row is bitwise the paged
// decode of the same values in any block layout.
//
// Layouts (all contiguous): q (B, H, Dh) bf16; caches (B, T, K, Dh) bf16;
// lens (B,) int32; out (B, H, Dh) bf16; ws (B, K, n_split, G, Dh + 2) f32;
// counters (B * K,) int32, 0 between launches.

#include "gqa_decode.cuh"

namespace {

__global__ void decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int T, int H, int K, int Dh, int W, int vec,
    float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K, bk = b * K + kh;
  const size_t q0 = ((size_t)b * H + (size_t)kh * G) * Dh;
  gqa::attend_split<false>(q + q0, 0, out + q0, kc + (size_t)kh * Dh,
                    vc + (size_t)kh * Dh, gqa::DenseRows{(size_t)b * T},
                    (size_t)K * Dh, 1, G, Dh, lens[b], T, W, vec, scale,
                    gqa::partials(ws, counters, bk, gridDim.x * K, G, Dh));
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k_cache,
                                     const void* v_cache, const void* lens,
                                     void* out, void* ws, void* counters,
                                     int B, int T, int H, int K, int Dh,
                                     int W, int n_split, float scale,
                                     void* stream) {
  const int G = H / K;
  const gqa::Smem L(G, Dh);
  const size_t smem = L.bytes;
  cudaError_t e = gqa::check_plan(W, n_split, L);
  if (e == cudaSuccess) e = gqa::allow_smem(decode_attention_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (Dh % 8 == 0) && ((size_t)k_cache % 16 == 0) &&
                  ((size_t)v_cache % 16 == 0);
  dim3 grid(B, K, n_split);
  decode_attention_kernel<<<grid, gqa::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const int*)lens, (__nv_bfloat16*)out,
      (float*)ws, (int*)counters, T, H, K, Dh, W, vec, scale);
  return (int)cudaGetLastError();
}
