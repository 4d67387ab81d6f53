// Sparse MTTKRP on the blocked layout: the hand-written Hopper kernel of the
// CP-ALS path, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below; the launcher returns
// cudaGetLastError() so the Python wrapper can raise).
//
// Replaces (JAX package, Pallas TPU kernel):
//   * mttkrp_blocked_launch <- src/repro/kernels/mttkrp/kernel.py
//                              mttkrp_pallas_call (body _mttkrp_kernel).
//
// What it computes.  Grid step g covers block_nnz sorted nonzeros of row
// block rb = grid_rb[g]; for each nonzero j with local row l_j:
//   M[rb*br + l_j, :] += round(x_j * kr_j)
// where round() is the element dtype (the TPU's vals * kr in that dtype),
// accumulated in f32.  It is Φ (phi.cu) without the model divide and
// without B: there is no x > 0 condition, so a negative value counts like
// any other; only a slot with x == 0 (padding, or a stored zero, which adds
// exactly 0 either way) is skipped.
//
// What bounds it on the H100.  Bytes: per nonzero it reads x, l and an
// R-wide Khatri-Rao row and does 2R flops, 1/8 flop per byte at R = 16, far
// below the card's ridge point.  The design aims to read each input once.
//
// Design: pass 1 of phi.cu without the weight step.  One block per grid
// step.  The block finds the last local row its valid slots touch (the
// valid slots are a prefix with non-decreasing local rows; padding carries
// x = 0 and local row 0), zeroes a shared-memory window of the rows
// row0 .. row_hi, and R-wide thread groups sum runs of equal row over
// contiguous chunks of the step in registers, adding into the window at a
// run boundary.  The block then does one global atomicAdd per (touched row,
// r) into a zeroed f32 output, so a hub row spread over thousands of grid
// steps costs thousands of blocks' flushes, not one per nonzero.  Float
// atomics make the last bits vary from run to run.
#include "common.cuh"

namespace {

using repro_torch::block_threads;
using repro_torch::round_to;
using repro_torch::to_f;

template <typename T>
__global__ void mttkrp_accum_kernel(const int* __restrict__ grid_rb,
                                    const T* __restrict__ vals,
                                    const int* __restrict__ lrow,
                                    const T* __restrict__ kr,
                                    float* __restrict__ out,
                                    int bn, int br, int R) {
  extern __shared__ float win[];  // [span * R] rows row0 .. row0+span-1
  __shared__ int row_hi;

  const int g = blockIdx.x;
  const int rb = grid_rb[g];
  const long long base = (long long)g * bn;
  const int row0 = lrow[base];  // valid slots are a prefix of the step
  if (threadIdx.x == 0) row_hi = row0;
  __syncthreads();

  // Step 1: the row span of the slots that contribute.
  int my_hi = row0;
  for (int j = threadIdx.x; j < bn; j += blockDim.x)
    if (to_f(vals[base + j]) != 0.f) my_hi = max(my_hi, lrow[base + j]);
  atomicMax(&row_hi, my_hi);
  __syncthreads();
  const int span = row_hi - row0 + 1;
  for (int i = threadIdx.x; i < span * R; i += blockDim.x) win[i] = 0.f;
  __syncthreads();

  // Step 2: R-wide groups reduce runs of equal row over contiguous chunks.
  const int nchunk = blockDim.x / R;
  const int chunk = threadIdx.x / R;
  const int r = threadIdx.x - chunk * R;
  if (chunk < nchunk) {
    const int len = (bn + nchunk - 1) / nchunk;
    const int j0 = chunk * len;
    const int j1 = min(bn, j0 + len);
    int cur = -1;
    float acc = 0.f;
    for (int j = j0; j < j1; ++j) {
      const float x = to_f(vals[base + j]);
      if (x == 0.f) continue;  // padding: contributes exactly 0
      const int row = lrow[base + j] - row0;
      // rounded to the element dtype once (the TPU kernel's vals * kr in
      // that dtype), then accumulated in f32
      const float c = round_to<T>(x * to_f(kr[(base + j) * R + r]));
      if (row != cur) {
        if (cur >= 0) atomicAdd(&win[cur * R + r], acc);
        cur = row;
        acc = 0.f;
      }
      acc += c;
    }
    if (cur >= 0) atomicAdd(&win[cur * R + r], acc);
  }
  __syncthreads();

  // One global atomic per (touched row, r).
  float* out_blk = out + ((long long)rb * br + row0) * R;
  for (int i = threadIdx.x; i < span * R; i += blockDim.x) {
    const float v = win[i];
    if (v != 0.f) atomicAdd(&out_blk[i], v);
  }
}

template <typename T>
cudaError_t launch_accum(const void* grid_rb, const void* vals, const void* lrow,
                         const void* kr, void* out, int n_grid, int bn, int br,
                         int R, cudaStream_t stream) {
  const int threads = block_threads(R);
  const size_t smem = sizeof(float) * (size_t)br * R;
  cudaError_t err = cudaFuncSetAttribute(
      mttkrp_accum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mttkrp_accum_kernel<T><<<n_grid, threads, smem, stream>>>(
      static_cast<const int*>(grid_rb), static_cast<const T*>(vals),
      static_cast<const int*>(lrow), static_cast<const T*>(kr),
      static_cast<float*>(out), bn, br, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  out: zeroed (n_rows_pad, R) f32.
int mttkrp_blocked_launch(int dtype, const void* grid_rb, const void* vals,
                          const void* lrow, const void* kr, void* out,
                          int n_grid, int bn, int br, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_accum<float>(grid_rb, vals, lrow, kr, out, n_grid, bn,
                                    br, R, s);
  if (dtype == 1)
    return (int)launch_accum<__nv_bfloat16>(grid_rb, vals, lrow, kr, out,
                                            n_grid, bn, br, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
