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
// accumulated in f32.  It is Φ without the model divide and without B:
// there is no x > 0 condition, so a negative value counts like any other
// and a NaN passes; only a slot with x == 0 (padding, or a stored zero,
// which adds exactly 0 either way) is skipped.
//
// What bounds it on the H100.  Bytes: per nonzero it reads x, l and an
// R-wide Khatri-Rao row (72 B at R = 16 in f32) and does 2R flops, 1/8 flop
// per byte at R = 16, far below the card's ridge point: the bound is the
// row stream over HBM bandwidth.
//
// Design: the MTTKRP instance of the Φ kernels' accumulation
// (phi_accum_kernel<false, ...>, accum.cuh, which holds the design):
// persistent CTAs, one contiguous slot range per warp streamed through the
// warp's own 2-stage cp.async ring, runs of equal rows summed in registers
// and landed with one global atomicAdd per (row, r) per run.  The instance
// reads no B row and forms no dot, shuffle reduction or divide.  Its
// shared memory per CTA is the Φ kernel's (mttkrp_accum_smem_bytes below,
// mirrored by repro_torch/kernels/phi/kernel.py::smem_bytes).  Float atomics
// make the last bits vary from run to run.
#include "accum.cuh"

namespace {

using repro_torch::blocked::accum;
using repro_torch::blocked::accum_shape;

}  // namespace

extern "C" {

// Shared memory per CTA of the MTTKRP accumulation (dtype 0 = f32, 1 = bf16).
int mttkrp_accum_smem_bytes(int dtype, int bn, int br, int R) {
  (void)br;  // the footprint does not depend on block_rows
  return (int)accum_shape(dtype == 1 ? 2 : 4, bn, R).smem;
}

// dtype: 0 = float32, 1 = bfloat16.  out: zeroed (n_rows_pad, R) f32.
int mttkrp_blocked_launch(int dtype, const void* grid_rb, const void* vals,
                          const void* lrow, const void* kr, void* out,
                          int n_grid, int bn, int br, int R, void* stream) {
  return accum<false>(dtype, grid_rb, vals, lrow, kr, nullptr, out, n_grid, bn,
                      br, R, 0.f, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
