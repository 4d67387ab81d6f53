// Pieces shared by the port's CUDA sources: element-dtype conversions and
// the fused MU epilogue (mu = B*Φ, viol = max |min(B, 1-Φ)|), which both the
// sparse (phi.cu) and the dense (dense.cu) fused steps run as their second
// pass.  Included by each .cu; the build hashes this header with them.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to the element dtype T and back (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max(s, eps) that lets a NaN through, as jnp.maximum does (fmaxf would not)
__device__ __forceinline__ float max_eps(float s, float eps) {
  return isnan(s) ? s : fmaxf(s, eps);
}

constexpr int kThreads = 256;

// threads per block: R-wide groups filling ~256 threads (R <= 1024)
inline int block_threads(int R) { return R <= kThreads ? R * (kThreads / R) : R; }

// Elementwise over the (rows, R) window: mu = B*Φ in B's dtype, and
// max |min(B, 1-Φ)| folded into one f32 with an unsigned atomicMax on its
// bits (all values are >= 0 or +NaN after fabsf, so the bit order is the
// value order and a NaN wins, as jnp.max lets it).
template <typename T>
__global__ void mu_epilogue_kernel(const T* __restrict__ b,
                                   const float* __restrict__ phi,
                                   T* __restrict__ mu,
                                   unsigned int* __restrict__ viol_bits,
                                   long long n) {
  unsigned int hi = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float bv = to_f(b[i]);
    const float p = phi[i];
    const float q = 1.f - p;
    const float m = (isnan(bv) || isnan(q)) ? __int_as_float(0x7fc00000)
                                             : fminf(bv, q);
    hi = max(hi, __float_as_uint(fabsf(m)));
    mu[i] = from_f<T>(bv * p);
  }
  for (int off = 16; off > 0; off >>= 1)
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  __shared__ unsigned int warp_hi[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_hi[warp] = hi;
  __syncthreads();
  if (warp == 0) {
    hi = lane < (int)(blockDim.x >> 5) ? warp_hi[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
    if (lane == 0 && hi != 0u) atomicMax(viol_bits, hi);
  }
}

template <typename T>
cudaError_t launch_epilogue(const void* b, const void* phi, void* mu, void* viol,
                            long long n, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  mu_epilogue_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(b), static_cast<const float*>(phi),
      static_cast<T*>(mu), static_cast<unsigned int*>(viol), n);
  return cudaGetLastError();
}

}  // namespace repro_torch
