// STREAM copy / scale / add / triad (paper Exp. 7, Table 3): the hand-written
// Hopper kernel of the port's bandwidth yardstick, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below; the launcher returns
// cudaGetLastError() so the Python wrapper can raise).
//
// Replaces (JAX package, Pallas TPU kernel):
//   * stream_launch <- src/repro/kernels/stream/kernel.py stream_pallas_call
//                      (bodies _copy_kernel, _scale_kernel, _add_kernel,
//                      _triad_kernel).
//
// What it computes, elementwise over n elements of T (f32 or bf16):
//   copy  out = b                  scale out = s*b
//   add   out = b + c              triad out = b + s*c
// Scale and triad round after each operation, as the reference's s * b and
// b + s * c do: __fmul_rn / __fadd_rn in f32 (never contracted into one FMA),
// and for bf16 the product s*c is rounded to bf16 before the add.  So the
// kernel is bitwise equal to its plain PyTorch version.  Copy moves bits.
//
// What bounds it on the H100.  Bytes: 2 or 3 words per element moved and at
// most 2 flops, 1/6 flop per byte at best, far below the card's ridge point.
// The roof is device memory (3.35 TB/s published); the design reads each
// input and writes the output once, in 16-byte accesses.
//
// Design.  The TPU walks (block_rows, 128) tiles in order on one core; on
// the card the launch shape is sized for the SMs instead, and block_rows
// keeps only the meaning of the wrapper's length check.  Each thread moves
// one 16-byte vector (4 f32 or 8 bf16 through a uint4) per array, a CTA of
// 256 threads covers 256 consecutive vectors (every access a full 128-bit
// coalesced one), and the ragged last CTA is masked: at n = 2^28 f32 that
// is 262144 CTAs, and the tail of the last wave is a negligible share,
// where the block_rows-sized CTAs of the first design (8192 CTAs at
// block_rows = 256, ~8 waves, each thread looping over 32 vectors) lost
// ~4% to it.  More vectors per thread, all loads issued before the first
// store, measured no faster on an H100 (K = 2, 4, 8 within ~1% of K = 1;
// PERF.md).  Loads and stores are plain: streaming cache hints (__ldcs /
// __stcs) measured no different on the card at these sizes.
#include <string.h>

#include "common.cuh"

namespace {

using repro_torch::from_f;
using repro_torch::kThreads;
using repro_torch::round_to;
using repro_torch::to_f;

enum Op { kCopy = 0, kScale = 1, kAdd = 2, kTriad = 3 };

template <int OP, typename T>
__device__ __forceinline__ float apply(float b, float c, float s) {
  if (OP == kScale) return __fmul_rn(s, b);
  if (OP == kAdd) return __fadd_rn(b, c);
  return __fadd_rn(b, round_to<T>(__fmul_rn(s, c)));  // triad
}

// One 16-byte vector of T through the op.
template <int OP, typename T>
__device__ __forceinline__ uint4 apply_vec(uint4 vb, uint4 vc, float s) {
  if (OP == kCopy) return vb;
  constexpr int kLanes = 16 / sizeof(T);
  T xb[kLanes], xc[kLanes], xo[kLanes];
  memcpy(xb, &vb, 16);
  memcpy(xc, &vc, 16);
#pragma unroll
  for (int i = 0; i < kLanes; ++i)
    xo[i] = from_f<T>(apply<OP, T>(to_f(xb[i]), to_f(xc[i]), s));
  uint4 out;
  memcpy(&out, xo, 16);
  return out;
}

template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint4* __restrict__ b, const uint4* __restrict__ c,
              uint4* __restrict__ out, long long n_vec, float s) {
  constexpr bool kTwoInputs = OP == kAdd || OP == kTriad;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const uint4 vb = b[i];
  out[i] = apply_vec<OP, T>(vb, kTwoInputs ? c[i] : vb, s);
}

template <int OP, typename T>
cudaError_t launch(const void* b, const void* c, void* out, long long n,
                   float s, cudaStream_t stream) {
  constexpr int kLanes = 16 / sizeof(T);
  const long long n_vec = n / kLanes;
  const long long n_cta = (n_vec + kThreads - 1) / kThreads;
  if (n_cta > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (n_cta == 0) return cudaGetLastError();
  stream_kernel<OP, T><<<(unsigned)n_cta, kThreads, 0, stream>>>(
      static_cast<const uint4*>(b), static_cast<const uint4*>(c),
      static_cast<uint4*>(out), n_vec, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* b, const void* c, void* out,
                      long long n, float s, cudaStream_t stream) {
  switch (op) {
    case kCopy: return launch<kCopy, T>(b, c, out, n, s, stream);
    case kScale: return launch<kScale, T>(b, c, out, n, s, stream);
    case kAdd: return launch<kAdd, T>(b, c, out, n, s, stream);
    case kTriad: return launch<kTriad, T>(b, c, out, n, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// op: 0 copy, 1 scale, 2 add, 3 triad.  dtype: 0 = float32, 1 = bfloat16.
// b, c, out: n elements each, 16-byte aligned; n a multiple of
// 128*block_rows; c is read only by add and triad.  The launch shape does
// not depend on block_rows.
int stream_launch(int op, int dtype, const void* b, const void* c, void* out,
                  long long n, int block_rows, float s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_rows < 1 || n % (128LL * block_rows) != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_op<float>(op, b, c, out, n, s, st);
  if (dtype == 1)
    return (int)launch_op<__nv_bfloat16>(op, b, c, out, n, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
