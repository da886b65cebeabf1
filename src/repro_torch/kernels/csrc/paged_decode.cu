// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_paged_kernel`).
//
// What it computes: for every batch row b and query head h = kh*G + g,
//   out[b,h] = softmax_t(q[b,h] . k[t] * scale) @ v[t],   t < cache_len[b],
// where logical position t of row b lives at
//   pool[table[b, t / bs], t % bs, kh].
// Same rounding points as the Pallas body: q and k are bf16, scores are
// summed in f32, the online softmax is f32 (running max starts at -1e30,
// the normaliser is clamped at 1e-30), p is cast to bf16 before P.V, the
// P.V sum is f32, and the output is cast back to bf16.
//
// What bounds it on the H100: memory.  Each decode step reads every live
// KV row once (sum(cache_len) * K * Dh * 2 bytes per pool) and does only
// 4 * Dh * G flops per KV row and query group, far below the ~295 flop/byte
// where the tensor cores would become the limit.  The design therefore
// reads each K/V row exactly once per (row, kv-head): one block per
// (b, kh) loads all G query heads of the group once, then walks the row's
// block table up to ceil(cache_len / bs) entries, a chunk of ~128
// positions (8 table entries at bs = 16) per iteration so that one
// iteration's loads are in flight together.  One warp per query head
// scores the chunk and runs its online softmax with warp shuffles.  Blocks
// past the length are never read, and inside the last block the rows past
// the length are skipped, not multiplied by 0: free slots decode over the
// scratch block 0, whose stale rows may hold anything (0 * NaN is NaN).
// Rows are staged with 16-byte loads when Dh % 8 == 0.  Simple first:
// scalar FMAs from shared memory and no split over the table (B * K
// blocks fill only part of the card at small batch); split-K is for a
// later change.
//
// Layouts (all contiguous): q (B, H, Dh) bf16; pools (nb, bs, K, Dh) bf16;
// table (B, mb) int32; lens (B,) int32; out (B, H, Dh) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 128;   // target positions staged per iteration

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

__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int H,
    int K, int Dh, int nb, int bs, int mb, int chunk_blocks, int vec,
    float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int C = chunk_blocks * bs;    // positions per iteration
  const int ldk = Dh + 2;             // bf16 row stride: odd word stride

  extern __shared__ float smem[];
  float* q_s = smem;                  // (G, Dh)
  float* acc = q_s + G * Dh;          // (G, Dh)
  float* p_s = acc + G * Dh;          // (G, C)  bf16-rounded p
  float* m_s = p_s + G * C;           // (G,)  running max
  float* l_s = m_s + G;               // (G,)  running denominator
  float* a_s = l_s + G;               // (G,)  this chunk's rescale
  int* tbl_s = (int*)(a_s + G);       // (chunk_blocks,)
  __nv_bfloat16* k_s = (__nv_bfloat16*)(tbl_s + chunk_blocks + (chunk_blocks & 1));
  __nv_bfloat16* v_s = k_s + C * ldk; // (C, ldk) each

  const int len = lens[b];
  const size_t row_stride = (size_t)K * Dh;    // between positions of a block
  const __nv_bfloat16* q_b = q + ((size_t)b * H + (size_t)kh * G) * Dh;
  for (int i = tid; i < G * Dh; i += blockDim.x) {
    q_s[i] = __bfloat162float(q_b[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  int n_blk = (len + bs - 1) / bs;
  if (n_blk > mb) n_blk = mb;
  const int n_pos = min(len, mb * bs);
  for (int blk0 = 0; blk0 < n_blk; blk0 += chunk_blocks) {
    const int pos0 = blk0 * bs;
    const int n_valid = min(C, n_pos - pos0);          // >= 1 here
    __syncthreads();                  // the previous chunk's readers are done
    for (int j = tid; j < chunk_blocks; j += blockDim.x) {
      int bid = blk0 + j < n_blk ? table[(size_t)b * mb + blk0 + j] : 0;
      tbl_s[j] = bid < 0 ? 0 : (bid >= nb ? nb - 1 : bid);   // clamp like XLA
    }
    __syncthreads();
    if (vec) {                        // 16-byte loads, 8 values each
      const int vpr = Dh / 8;
      for (int i = tid; i < n_valid * vpr; i += blockDim.x) {
        const int t = i / vpr, c = i - t * vpr;
        const size_t off = ((size_t)tbl_s[t / bs] * bs + t % bs) * row_stride +
                           (size_t)kh * Dh + c * 8;
        const uint4 kw = *reinterpret_cast<const uint4*>(kp + off);
        const uint4 vw = *reinterpret_cast<const uint4*>(vp + off);
        unsigned* kd = reinterpret_cast<unsigned*>(k_s + t * ldk + c * 8);
        unsigned* vd = reinterpret_cast<unsigned*>(v_s + t * ldk + c * 8);
        kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
        vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
      }
    } else {
      for (int i = tid; i < n_valid * Dh; i += blockDim.x) {
        const int t = i / Dh, d = i - t * Dh;
        const size_t off = ((size_t)tbl_s[t / bs] * bs + t % bs) * row_stride +
                           (size_t)kh * Dh + d;
        k_s[t * ldk + d] = kp[off];
        v_s[t * ldk + d] = vp[off];
      }
    }
    __syncthreads();
    // one warp per query head: scores, chunk max, p, chunk sum
    for (int g = warp; g < G; g += kWarps) {
      const float* qr = q_s + g * Dh;
      float* pr = p_s + g * C;
      float m_loc = kNegInf;
      for (int t = lane; t < C; t += 32) {
        float s = kNegInf;
        if (t < n_valid) {
          const __nv_bfloat16* kr = k_s + t * ldk;
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], __bfloat162float(kr[d]), dot);
          s = dot * scale;
        }
        pr[t] = s;
        m_loc = fmaxf(m_loc, s);
      }
      const float m_prev = m_s[g];
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
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v over the valid rows only
    for (int i = tid; i < G * Dh; i += blockDim.x) {
      const int g = i / Dh, d = i - g * Dh;
      const float* pr = p_s + g * C;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < n_valid; ++t)
        a = fmaf(pr[t], __bfloat162float(v_s[t * ldk + d]), a);
      acc[i] = a;
    }
  }
  __syncthreads();
  __nv_bfloat16* o_b = out + ((size_t)b * H + (size_t)kh * G) * Dh;
  for (int i = tid; i < G * Dh; i += blockDim.x) {
    const float l = fmaxf(l_s[i / Dh], 1e-30f);
    o_b[i] = __float2bfloat16(acc[i] / l);
  }
}

size_t smem_bytes(int G, int Dh, int bs, int chunk_blocks) {
  const size_t C = (size_t)chunk_blocks * bs;
  return sizeof(float) * (2 * (size_t)G * Dh + (size_t)G * C + 3 * (size_t)G) +
         sizeof(int) * (chunk_blocks + (chunk_blocks & 1)) +
         2 * sizeof(__nv_bfloat16) * C * (Dh + 2);
}

int chunk_blocks_for(int G, int Dh, int bs) {
  int cb = kChunkRows / bs;
  if (cb < 1) cb = 1;
  while (cb > 1 && smem_bytes(G, Dh, bs, cb) > 200 * 1024) cb /= 2;
  return cb;
}

}  // namespace

extern "C" size_t paged_decode_smem_bytes(int G, int Dh, int bs) {
  return smem_bytes(G, Dh, bs, chunk_blocks_for(G, Dh, bs));
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, void* out, int B, int H, int K, int Dh, int nb, int bs,
    int mb, float scale, void* stream) {
  const int G = H / K;
  const int cb = chunk_blocks_for(G, Dh, bs);
  const size_t smem = smem_bytes(G, Dh, bs, cb);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // rows of Dh % 8 == 0 bf16 values start on 16-byte boundaries
  const int vec = (Dh % 8 == 0) && ((size_t)k_pool % 16 == 0) &&
                  ((size_t)v_pool % 16 == 0);
  dim3 grid(B, K);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)table, (const int*)lens,
      (__nv_bfloat16*)out, H, K, Dh, nb, bs, mb, cb, vec, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
