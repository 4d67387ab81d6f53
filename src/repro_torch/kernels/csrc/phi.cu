// Φ^(n) on the blocked layout: the two hand-written Hopper kernels of the
// CP-APR MU path, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below; every launcher
// returns cudaGetLastError() so the Python wrapper can raise).
//
// Replaces (JAX package, Pallas TPU kernels):
//   * phi_blocked_launch    <- src/repro/kernels/phi/kernel.py phi_pallas_call
//                              (body _phi_kernel): plain Φ, the scooch step.
//   * phi_mu_blocked_launch <- src/repro/kernels/phi/kernel.py
//                              phi_mu_pallas_call (body _phi_mu_kernel): the
//                              fused Φ -> (B*Φ, KKT violation) inner MU step.
//
// What it computes.  Grid step g covers block_nnz sorted nonzeros of row
// block rb = grid_rb[g]; for each nonzero j with local row l_j:
//   s_j = <B[rb*br + l_j, :], pi_j>,  w_j = x_j / max(s_j, eps)  (0 if x_j<=0)
//   Φ[rb*br + l_j, :] += w_j * pi_j
// and the fused variant then writes mu = B*Φ and viol = max |min(B, 1-Φ)|.
//
// What bounds it on the H100.  Bytes: per nonzero it reads x, l and an R-wide
// Π row and does ~4R+2 flops, about 0.125 flop per word (paper Eqs. 3-4),
// three orders of magnitude below the card's ridge point.  Nothing here can
// use the tensor cores usefully; the design aims to read each input once.
//
// Design.  The TPU grid runs in order and carries Φ across grid steps by
// revisiting the output block; GPU blocks run in parallel in no order, so:
//   Pass 1 (phi_accum_kernel): one block per grid step.  It loads its own
//     indices, gathers the B rows directly (no one-hot matmul, no lane
//     padding of R), and stores w_j in shared memory.  Then R-wide thread
//     groups each take a contiguous chunk of the step and sum runs of equal
//     row in registers; a run boundary adds into a shared-memory window of
//     the rows the step touches, and at the end the block does one global
//     atomicAdd per (touched row, r) into a zeroed f32 Φ -- the paper's
//     "atomics only at segment boundaries" (CPU Alg. 4).  A hub row that
//     spans thousands of grid steps is spread over thousands of blocks, so
//     the 24-row mode of uber and a 60%-hub mode still fill the card.
//   Pass 2 (mu_epilogue_kernel in common.cuh, fused step only): elementwise
//     over the padded window, writes mu = B*Φ in B's dtype and folds
//     max |min(B, 1-Φ)| into a single f32 with an unsigned atomicMax on its
//     bits (all values are >= 0 or +NaN after fabsf, so the bit order is the
//     value order and a NaN wins, as jnp.max lets it).
// Float atomics make the summation order, and so the last bits of Φ, vary
// from run to run; the wrappers' plain versions agree to a stated tolerance.
//
// Layout facts relied on (repro_torch/core/layout.py): the valid slots of a
// grid step are a prefix of it, their local rows are non-decreasing, and
// padding slots carry x = 0 (weight exactly 0, skipped).  B is zero-padded to
// n_rows_pad rows, so padded rows add exactly 0 to viol.
#include "common.cuh"

namespace {

using repro_torch::block_threads;
using repro_torch::launch_epilogue;
using repro_torch::max_eps;
using repro_torch::round_to;
using repro_torch::to_f;

template <typename T>
__global__ void phi_accum_kernel(const int* __restrict__ grid_rb,
                                 const T* __restrict__ vals,
                                 const int* __restrict__ lrow,
                                 const T* __restrict__ pi,
                                 const T* __restrict__ b,
                                 float* __restrict__ phi,
                                 int bn, int br, int R, float eps) {
  extern __shared__ float smem[];
  float* w = smem;        // [bn] weights of this step
  float* win = smem + bn; // [span * R] rows row0 .. row0+span-1 of the block
  __shared__ int row_hi;

  const int g = blockIdx.x;
  const int rb = grid_rb[g];
  const long long base = (long long)g * bn;
  const int row0 = lrow[base];  // valid slots are a prefix of the step
  const T* b_blk = b + (long long)rb * br * R;
  if (threadIdx.x == 0) row_hi = row0;
  __syncthreads();

  // Step 1: one thread per nonzero computes its weight.
  int my_hi = row0;
  for (int j = threadIdx.x; j < bn; j += blockDim.x) {
    const float x = to_f(vals[base + j]);
    float wj = 0.f;
    if (x > 0.f) {
      const int l = lrow[base + j];
      const T* brow = b_blk + (long long)l * R;
      const T* prow = pi + (base + j) * R;
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += to_f(brow[r]) * to_f(prow[r]);
      wj = x / max_eps(s, eps);
      my_hi = max(my_hi, l);
    }
    w[j] = wj;
  }
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
      const float wj = w[j];
      if (wj == 0.f) continue;  // padding: contributes exactly 0
      const int row = lrow[base + j] - row0;
      // the contribution is rounded to the element dtype once (as the TPU
      // kernel's (w * pi).astype(pi.dtype)), then accumulated in f32
      const float c = round_to<T>(wj * to_f(pi[(base + j) * R + r]));
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
  float* phi_blk = phi + ((long long)rb * br + row0) * R;
  for (int i = threadIdx.x; i < span * R; i += blockDim.x) {
    const float v = win[i];
    if (v != 0.f) atomicAdd(&phi_blk[i], v);
  }
}

template <typename T>
cudaError_t launch_accum(const void* grid_rb, const void* vals, const void* lrow,
                         const void* pi, const void* b, void* phi, int n_grid,
                         int bn, int br, int R, float eps, cudaStream_t stream) {
  const int threads = block_threads(R);
  const size_t smem = sizeof(float) * ((size_t)bn + (size_t)br * R);
  cudaError_t err = cudaFuncSetAttribute(
      phi_accum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  phi_accum_kernel<T><<<n_grid, threads, smem, stream>>>(
      static_cast<const int*>(grid_rb), static_cast<const T*>(vals),
      static_cast<const int*>(lrow), static_cast<const T*>(pi),
      static_cast<const T*>(b), static_cast<float*>(phi), bn, br, R, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  phi: zeroed (n_rows_pad, R) f32.
int phi_blocked_launch(int dtype, const void* grid_rb, const void* vals,
                       const void* lrow, const void* pi, const void* b,
                       void* phi, int n_grid, int bn, int br, int R, float eps,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_accum<float>(grid_rb, vals, lrow, pi, b, phi, n_grid, bn,
                                    br, R, eps, s);
  if (dtype == 1)
    return (int)launch_accum<__nv_bfloat16>(grid_rb, vals, lrow, pi, b, phi,
                                            n_grid, bn, br, R, eps, s);
  return (int)cudaErrorInvalidValue;
}

// phi: zeroed (n_rows_pad, R) f32 scratch; mu: (n_rows_pad, R) in the element
// dtype; viol: one zeroed f32.
int phi_mu_blocked_launch(int dtype, const void* grid_rb, const void* vals,
                          const void* lrow, const void* pi, const void* b,
                          void* phi, void* mu, void* viol, int n_grid, int bn,
                          int br, int R, long long n_rows_pad, float eps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = phi_blocked_launch(dtype, grid_rb, vals, lrow, pi, b, phi, n_grid,
                               bn, br, R, eps, stream);
  if (err != 0) return err;
  const long long n = n_rows_pad * (long long)R;
  if (dtype == 0) return (int)launch_epilogue<float>(b, phi, mu, viol, n, s);
  return (int)launch_epilogue<__nv_bfloat16>(b, phi, mu, viol, n, s);
}

}  // extern "C"
