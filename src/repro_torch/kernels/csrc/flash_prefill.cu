// Blocked flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_attn_kernel`).
//
// What it computes: causal, sliding-window or non-causal GQA attention
//   out[b,i,h] = softmax_t(q[b,i,h] . k[b,t,kh] * scale) @ v[b,t,kh]
// with kh = h / G, query i at absolute position q_offset + i, and the mask
//   t < t_total  &&  (!causal || t <= pos)  &&  (window <= 0 || t > pos - window).
// Same rounding points as the Pallas body: q, k, p and v are bf16, Q.K and
// P.V are summed in f32, the online softmax is f32 with masked scores set
// to -1e30 (not -inf) and the normaliser clamped at 1e-30, so a fully
// masked row comes out uniform over the tiles it saw instead of NaN.  The
// output is cast to bf16.
//
// What bounds it on the H100: operations.  A causal prefill of S tokens
// does about 2 * S^2 * H * Dh flops against 2 * S * (H + K) * Dh * 2 bytes;
// at S = 1023 that is ~500 flop/byte, above the card's ~295.  This first
// version uses scalar f32 FMAs from shared memory (no tensor cores), so it
// runs far below the bf16 tensor-core peak; `mma.sync`/`wgmma` tiles are a
// later change.  What the design does about the bound now: it never
// computes a tile the mask removes.  One block per (batch, kv-head, q-tile)
// covers all G query heads of the group, so each K/V tile staged in shared
// memory serves G heads; the KV loop starts at the window's first tile and
// stops at the causal bound of the tile's last row.  Ragged S and T are
// masked in the kernel; nothing is padded or copied.
//
// Layouts (all contiguous): q (B, S, H, Dh), k/v (B, T, K, Dh), out like q,
// all bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBlockK = 32;      // KV rows per shared-memory tile
constexpr int kMaxRows = 64;     // query rows (positions x heads) per block

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int S, int T, int H, int K, int Dh, int block_q, int causal, int window,
    int q_offset, int t_total, float scale) {
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x - b * K;
  const int q0 = blockIdx.y * block_q;
  const int G = H / K;
  const int R = block_q * G;          // query rows; row r = (i = r / G, g = r % G)
  const int ldq = Dh + 1;             // padded strides: conflict-free columns
  const int ldk = Dh + 1;
  const int lds = kBlockK + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;                  // (R, ldq)
  float* acc = q_s + R * ldq;         // (R, Dh)
  float* k_s = acc + R * Dh;          // (kBlockK, ldk)
  float* v_s = k_s + kBlockK * ldk;   // (kBlockK, ldk)
  float* p_s = v_s + kBlockK * ldk;   // (R, lds)
  float* m_s = p_s + R * lds;         // (R,)
  float* l_s = m_s + R;               // (R,)
  float* a_s = l_s + R;               // (R,)

  const size_t q_row = (size_t)H * Dh;    // between positions of q / out
  const size_t kv_row = (size_t)K * Dh;   // between positions of k / v
  for (int idx = tid; idx < R * Dh; idx += blockDim.x) {
    const int r = idx / Dh, d = idx - r * Dh;
    const int i = q0 + r / G, h = kh * G + r % G;
    q_s[r * ldq + d] = i < S
        ? __bfloat162float(q[((size_t)b * S + i) * q_row + (size_t)h * Dh + d])
        : 0.f;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // KV range this q-tile can see: [kv_lo, kv_hi)
  const int last_i = min(S, q0 + block_q) - 1;
  const int pos_first = q_offset + q0, pos_last = q_offset + last_i;
  int kv_hi = t_total;
  if (causal) kv_hi = min(kv_hi, pos_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, pos_first - window + 1) / kBlockK * kBlockK;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBlockK) {
    const int nk = min(kBlockK, T - t0);   // rows that exist in memory
    __syncthreads();
    for (int idx = tid; idx < kBlockK * Dh; idx += blockDim.x) {
      const int c = idx / Dh, d = idx - c * Dh;
      float kv = 0.f, vv = 0.f;
      if (c < nk) {
        const size_t off = ((size_t)b * T + t0 + c) * kv_row + (size_t)kh * Dh + d;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      k_s[c * ldk + d] = kv;
      v_s[c * ldk + d] = vv;
    }
    __syncthreads();
    for (int idx = tid; idx < R * kBlockK; idx += blockDim.x) {
      const int r = idx / kBlockK, c = idx - r * kBlockK;
      const int pos = q_offset + q0 + r / G, t = t0 + c;
      bool valid = t < t_total && c < nk;
      if (causal) valid = valid && t <= pos;
      if (window > 0) valid = valid && t > pos - window;
      float s = kNegInf;
      if (valid) {
        const float* qr = q_s + r * ldq;
        const float* kr = k_s + c * ldk;
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[r * lds + c] = s;
    }
    __syncthreads();
    for (int r = tid; r < R; r += blockDim.x) {
      float* pr = p_s + r * lds;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int c = 0; c < kBlockK; ++c) m_new = fmaxf(m_new, pr[c]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int c = 0; c < kBlockK; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = bf16_round(p);
      }
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < R * Dh; idx += blockDim.x) {
      const int r = idx / Dh, d = idx - r * Dh;
      const float* pr = p_s + r * lds;
      float a = acc[idx] * a_s[r];
      for (int c = 0; c < kBlockK; ++c) a = fmaf(pr[c], v_s[c * ldk + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * Dh; idx += blockDim.x) {
    const int r = idx / Dh, d = idx - r * Dh;
    const int i = q0 + r / G, h = kh * G + r % G;
    if (i < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
      out[((size_t)b * S + i) * q_row + (size_t)h * Dh + d] =
          __float2bfloat16(acc[idx] / l);
    }
  }
}

}  // namespace

extern "C" int flash_prefill_block_q(int G) {
  const int bq = kMaxRows / G;
  return bq < 1 ? 1 : (bq > 16 ? 16 : bq);
}

extern "C" size_t flash_prefill_smem_bytes(int G, int Dh) {
  const int R = flash_prefill_block_q(G) * G;
  return sizeof(float) * ((size_t)R * (Dh + 1) + (size_t)R * Dh +
                          2 * (size_t)kBlockK * (Dh + 1) +
                          (size_t)R * (kBlockK + 1) + 3 * (size_t)R);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int S, int T, int H, int K,
                                  int Dh, int causal, int window, int q_offset,
                                  int t_total, float scale, void* stream) {
  const int G = H / K;
  const int block_q = flash_prefill_block_q(G);
  const size_t smem = flash_prefill_smem_bytes(G, Dh);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * K, (S + block_q - 1) / block_q);
  flash_prefill_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, T, H, K, Dh, block_q,
      causal, window, q_offset, t_total, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
