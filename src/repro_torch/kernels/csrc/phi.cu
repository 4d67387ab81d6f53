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
// What bounds it on the H100.  Bytes: per nonzero it must read x, l and an
// R-wide Π row (72 B at R = 16 in f32) and does ~4R+2 flops, about 0.125
// flop per word (paper Eqs. 3-4), three orders of magnitude below the card's
// ridge point.  B (n_rows_pad x R) is small and stays in L1/L2.  The bound
// is the Π stream over HBM bandwidth.  Measured on the card (PERF.md), the
// first designs of this kernel were bound instead by instructions per
// nonzero and per CTA-wide chunk; the design spends few of either.
//
// Pass 1 is the Φ instance of the accumulation kernel that sparse MTTKRP
// shares (phi_accum_kernel<true, ...>, accum.cuh, which holds its design).
// Pass 2 (mu_epilogue_kernel in common.cuh, fused step only): elementwise
// over the padded window, writes mu = B*Φ in B's dtype and folds
// max |min(B, 1-Φ)| into a single f32 with an unsigned atomicMax on its
// bits.  B is zero-padded to n_rows_pad rows, so padded rows add exactly 0
// to viol.
#include "accum.cuh"

namespace {

using repro_torch::launch_epilogue;
using repro_torch::blocked::accum;
using repro_torch::blocked::accum_shape;

}  // namespace

extern "C" {

// Shared memory per CTA of the Φ accumulation (dtype 0 = f32, 1 = bf16).
int phi_accum_smem_bytes(int dtype, int bn, int br, int R) {
  (void)br;  // the footprint does not depend on block_rows
  return (int)accum_shape(dtype == 1 ? 2 : 4, bn, R).smem;
}

// dtype: 0 = float32, 1 = bfloat16.  phi: zeroed (n_rows_pad, R) f32.
int phi_blocked_launch(int dtype, const void* grid_rb, const void* vals,
                       const void* lrow, const void* pi, const void* b,
                       void* phi, int n_grid, int bn, int br, int R, float eps,
                       void* stream) {
  return accum<true>(dtype, grid_rb, vals, lrow, pi, b, phi, n_grid, bn, br, R,
                     eps, static_cast<cudaStream_t>(stream));
}

// phi: zeroed (n_rows_pad, R) f32 scratch; mu: (n_rows_pad, R) in the element
// dtype; viol: one zeroed f32.
int phi_mu_blocked_launch(int dtype, const void* grid_rb, const void* vals,
                          const void* lrow, const void* pi, const void* b,
                          void* phi, void* mu, void* viol, int n_grid, int bn,
                          int br, int R, long long n_rows_pad, float eps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = accum<true>(dtype, grid_rb, vals, lrow, pi, b, phi, n_grid, bn, br,
                        R, eps, s);
  if (err != 0) return err;
  const long long n = n_rows_pad * (long long)R;
  if (dtype == 0) return (int)launch_epilogue<float>(b, phi, mu, viol, n, s);
  return (int)launch_epilogue<__nv_bfloat16>(b, phi, mu, viol, n, s);
}

}  // extern "C"
