// Fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel `rmsnorm_kernel`
// (src/repro/kernels/rmsnorm/kernel.py, body `_rmsnorm_kernel`).
//
// What it computes, per row of x (R, D):
//   x' = x (+ residual)                      in f32
//   normed = x' * rsqrt(mean(x'^2) + eps) * (1 + scale)      in f32
// and writes (normed, x') both in x's dtype: the two-output contract.  The
// scale (D,) is read as f32.
//
// What bounds it on the H100: bytes (one read of x, of the residual and of
// the scale, two row writes; a few flops per element), and at the main
// path's decode shape (8 rows of 960) not even those: a few KB take
// nanoseconds, so the launch and one memory round trip are the cost.  What
// the design does about it: one 128-thread block per row, so the 8 decode
// rows run on 8 SMs at once; 16-byte loads and stores; each thread loads
// its part of the row and of the scale together, so a launch waits on one
// round trip; the row stays in registers between the reduction (warp
// shuffles, then the 4 warps' sums) and the elementwise pass up to D =
// 4096 (bf16; 2048 for f32), so every byte crosses device memory once.
// (One warp per row with eight rows in a block took half again as long on
// the serve path's decode step: the 8 rows shared one SM.)  Rows of another
// width (D not a multiple of 16 bytes, or wider) take a scalar two-pass
// path, one warp per row, that reads x (and the residual) twice.  The entry
// is a plain C function: the wrapper's host path is one allocation and one
// ctypes call.
//
// Layouts: x, residual (R, D) contiguous, bf16 or f32; scale (D,) f32; out
// (2, R, D) in x's dtype, normed first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // the vector path: one block per row
constexpr int kRowsPerBlock = 8;      // the scalar path: one warp per row
constexpr int kMaxVecs = 4;           // 16-byte vectors a thread holds


__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One block per row, the row in registers: each thread holds up to VPL
// 16-byte vectors of it and their scale, all loaded at once.
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads) rmsnorm_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ scale, T* __restrict__ out, int R, int D,
    float eps) {
  constexpr int E = 16 / sizeof(T);          // elements per vector
  __shared__ float warp_ss[kThreads / 32];
  const int row = blockIdx.x;
  const int nvec = D / E;
  const size_t base = (size_t)row * D;
  float v[VPL][E], sc[VPL][E];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = threadIdx.x + kThreads * j;
    if (c < nvec) {
      const uint4 xr = reinterpret_cast<const uint4*>(x + base)[c];
      const T* xe = reinterpret_cast<const T*>(&xr);
#pragma unroll
      for (int e = 0; e < E; ++e) v[j][e] = to_f32(xe[e]);
#pragma unroll
      const float4* s4p = reinterpret_cast<const float4*>(scale) + c * (E / 4);
#pragma unroll
      for (int e4 = 0; e4 < E / 4; ++e4) {
        const float4 s4 = s4p[e4];
        sc[j][4 * e4] = s4.x;
        sc[j][4 * e4 + 1] = s4.y;
        sc[j][4 * e4 + 2] = s4.z;
        sc[j][4 * e4 + 3] = s4.w;
      }
      if (res != nullptr) {
        const uint4 rr = reinterpret_cast<const uint4*>(res + base)[c];
        const T* re = reinterpret_cast<const T*>(&rr);
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] += to_f32(re[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[j][e] * v[j][e];
    }
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) warp_ss[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) ss += warp_ss[w];
  const float inv = rsqrtf(ss / D + eps);
  T* normed = out + base;
  T* res_out = out + (size_t)R * D + base;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = threadIdx.x + kThreads * j;
    if (c < nvec) {
      uint4 n_raw, r_raw;
      T* ne = reinterpret_cast<T*>(&n_raw);
      T* re = reinterpret_cast<T*>(&r_raw);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ne[e] = from_f32<T>(v[j][e] * inv * (1.f + sc[j][e]));
        re[e] = from_f32<T>(v[j][e]);
      }
      reinterpret_cast<uint4*>(normed)[c] = n_raw;
      reinterpret_cast<uint4*>(res_out)[c] = r_raw;
    }
  }
}

// Any width: two passes over the row, one element per lane at a time.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock) rmsnorm_scalar_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ scale, T* __restrict__ out, int R, int D,
    float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const size_t base = (size_t)row * D;
  T* normed = out + base;
  T* res_out = out + (size_t)R * D + base;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    float v = to_f32(x[base + c]);
    if (res != nullptr) v += to_f32(res[base + c]);
    ss += v * v;
    res_out[c] = from_f32<T>(v);
  }
  const float inv = rsqrtf(warp_sum(ss) / D + eps);
  for (int c = lane; c < D; c += 32) {
    float v = to_f32(x[base + c]);
    if (res != nullptr) v += to_f32(res[base + c]);
    normed[c] = from_f32<T>(v * inv * (1.f + scale[c]));
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* scale, void* out,
           int R, int D, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
        reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const int per_thread = (D / E + kThreads - 1) / kThreads;   // vectors
  auto run = [&](auto kernel) {
    kernel<<<R, kThreads, 0, stream>>>(xp, rp, sp, op, R, D, eps);
  };
  if (!aligned || D % E != 0 || per_thread > kMaxVecs) {
    rmsnorm_scalar_kernel<T>
        <<<(R + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
           stream>>>(xp, rp, sp, op, R, D, eps);
  } else if (per_thread <= 1) {
    run(rmsnorm_vec_kernel<T, 1>);
  } else if (per_thread <= 2) {
    run(rmsnorm_vec_kernel<T, 2>);
  } else {
    run(rmsnorm_vec_kernel<T, 4>);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  res may be NULL (no residual).
extern "C" int rmsnorm_fused_fwd(const void* x, const void* res,
                                 const void* scale, void* out, int R, int D,
                                 int dtype, float eps, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, res, scale, out, R, D, eps, s);
  if (dtype == 1) return launch<float>(x, res, scale, out, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
