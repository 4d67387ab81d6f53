// Pieces shared by the port's CUDA sources: element-dtype conversions, the
// fused MU epilogue (mu = B*Φ, viol = max |min(B, 1-Φ)|) that the sparse
// fused step (phi.cu) runs as its second pass and the dense one (dense.cu)
// inlines into its accumulation, 16-byte cp.async, and the once-per-shape
// launch set-up (dynamic shared-memory limit, resident CTAs).  Included by
// each .cu; the build hashes this header with them.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

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

// 16 bytes from global to shared memory without a register round trip;
// with src_bytes < 16 only that many are read and the rest is zero-filled.
__device__ __forceinline__ void cp_async16(void* sdst, const void* gsrc,
                                           int src_bytes = 16) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(sdst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(gsrc), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// CTAs of one kernel instance resident at once at (threads, smem) on the
// current device, queried on the first launch of each (instance, device,
// threads, smem) and kept, so a launch makes no runtime query but
// cudaGetDevice.  That first query also raises the instance's dynamic
// shared-memory limit on the device to smem where it was lower (only ever
// raised, so every shape seen before still launches).
inline cudaError_t resident_ctas(const void* kern, int threads, long long smem,
                                 int* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, long long>, int> known;
  static std::map<std::pair<const void*, int>, long long> smem_limit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kern, dev, threads, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  long long& limit = smem_limit[std::make_pair(kern, dev)];
  if (smem > limit) {
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return err;
    limit = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, (size_t)smem)) != cudaSuccess)
    return err;
  *out = known[key] = (per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

// One entry of the MU epilogue: writes mu = B*Φ in B's dtype and returns
// the bits of |min(B, 1-Φ)| as an unsigned (all values are >= 0 or +NaN
// after fabsf, so the bit order is the value order and a NaN wins, as
// jnp.max lets it).
template <typename T>
__device__ __forceinline__ unsigned mu_entry(T b, float phi, T* mu) {
  const float bv = to_f(b);
  const float q = 1.f - phi;
  const float m = (isnan(bv) || isnan(q)) ? __int_as_float(0x7fc00000)
                                           : fminf(bv, q);
  *mu = from_f<T>(bv * phi);
  return __float_as_uint(fabsf(m));
}

// Max of every thread's hi over the block (at most kThreads threads, all
// of them calling), folded into *viol_bits with one atomicMax.
__device__ __forceinline__ void block_max_into(unsigned hi,
                                               unsigned* viol_bits) {
  for (int off = 16; off > 0; off >>= 1)
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  __shared__ unsigned warp_hi[kThreads / 32];
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

// Elementwise over the (rows, R) window: mu = B*Φ and viol = max
// |min(B, 1-Φ)| (mu_entry, block_max_into).
template <typename T>
__global__ void mu_epilogue_kernel(const T* __restrict__ b,
                                   const float* __restrict__ phi,
                                   T* __restrict__ mu,
                                   unsigned int* __restrict__ viol_bits,
                                   long long n) {
  unsigned int hi = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    hi = max(hi, mu_entry<T>(b[i], phi[i], mu + i));
  block_max_into(hi, viol_bits);
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
