// The dense matrix-free tier: three hand-written Hopper kernels over the
// mode-permuted dense tensor x (K, I, J), with c (J, R), a (K, R), B (I, R).
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below; every launcher
// returns cudaGetLastError() so the Python wrapper can raise).
//
// Replaces (JAX package, Pallas TPU kernels, src/repro/kernels/dense/kernel.py):
//   * dense_mttkrp_launch <- dense_mttkrp_pallas_call (_dense_mttkrp_kernel):
//       M[i, r] = sum_k a[k, r] * sum_j x[k, i, j] c[j, r]
//   * dense_phi_launch    <- dense_phi_pallas_call (_dense_phi_kernel with
//       _dense_phi_accum): per slice k
//         m = B (c∘a_k)^T,  w = x_k > 0 ? x_k / max(m, eps) : 0,
//         Φ[i, r] += a[k, r] * sum_j w[i, j] c[j, r]
//   * dense_phi_mu_launch <- dense_phi_mu_pallas_call (_dense_phi_mu_kernel):
//       the same Φ, then mu = B*Φ and viol = max |min(B, 1-Φ)|.
// Roundings follow the TPU bodies: c∘a_k is rounded to the element dtype
// before the first contraction, w is rounded to it before the second, every
// contraction accumulates in f32 (identities for f32 elements).
//
// What bounds it on the H100.  The tier caps x at 2^22 cells, ~17 MB in
// f32, so one call is ~5 us of HBM traffic at 3.35 TB/s; its operations
// (about 4R per cell for Φ, 2R for MTTKRP) take 2-4 us at the f32 rate.
// Both are of the order of a launch: at these sizes the call is bound by
// how well its blocks fill the card and by launch cost, not by either rate.
//
// Design.  The TPU runs K in order into one revisited (I, R) window.  Here
// I*R is only a few thousand outputs while each has K*J ~ 32k terms, so the
// reduction over K is split across blocks: block (k-chunk, i-tile) takes
// block_k slices and ti rows, with ti*R threads, one per (row, r) output.
// For each chunk of jc columns it stages c (and, for Φ, round(c∘a_k) and
// the B tile) in shared memory; phase A computes the tile's weights w (the
// model slice m is formed element by element in registers and never
// written to global memory) and phase B contracts them against c, each
// thread summing its (row, r) output over the block's slices in a register.
// One f32 atomicAdd per (row, r) per block lands the partial in a zeroed
// window; the fused step then runs the MU epilogue (common.cuh) as a second
// kernel, after every block has landed.  Plain CUDA-core FMAs: the tensor
// cores, TMA and wgmma are later work.  Float atomics make the last bits
// vary from run to run.
#include "common.cuh"

namespace {

using repro_torch::block_threads;
using repro_torch::launch_epilogue;
using repro_torch::max_eps;
using repro_torch::round_to;
using repro_torch::to_f;

// Shared memory a block may take, in floats: 96 KB keeps two blocks per SM.
constexpr long long kSmemFloats = 96 * 1024 / 4;

template <typename T, bool PHI>
__global__ void dense_accum_kernel(const T* __restrict__ x,
                                   const T* __restrict__ c,
                                   const T* __restrict__ a,
                                   const T* __restrict__ b,
                                   float* __restrict__ out,
                                   int K, int I, int J, int R, int kb, int ti,
                                   int jc, int n_itiles, float eps) {
  extern __shared__ float smem[];
  const int Rs = R | 1;         // odd row stride: conflict-free column reads
  const int wst = jc + 1;       // weight-tile row stride, padded by one
  float* cs = smem;             // [jc * R]  c rows j0 .. j0+jc-1
  float* ws = cs + jc * R;      // [ti * wst] weights of the (ti, jc) tile
  float* bs = ws + ti * wst;    // [ti * R]  B tile (Φ only)
  float* cas = bs + ti * R;     // [jc * Rs] round(c∘a_k) (Φ only)

  const int i0 = (blockIdx.x % n_itiles) * ti;
  const int k0 = (blockIdx.x / n_itiles) * kb;
  const int k1 = min(K, k0 + kb);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // ti * R
  const int ii = tid / R;           // this thread's output (row, r)
  const int r = tid - ii * R;

  if (PHI)
    for (int p = tid; p < ti * R; p += nthreads) {
      const int pi = p / R;
      bs[p] = i0 + pi < I ? to_f(b[(long long)(i0 + pi) * R + (p - pi * R)])
                          : 0.f;
    }

  float acc = 0.f;
  for (int j0 = 0; j0 < J; j0 += jc) {
    const int jn = min(jc, J - j0);
    __syncthreads();  // the previous chunk's readers of cs are done
    for (int p = tid; p < jc * R; p += nthreads) {
      const int jj = p / R;
      cs[p] = jj < jn ? to_f(c[(long long)(j0 + jj) * R + (p - jj * R)]) : 0.f;
    }
    for (int k = k0; k < k1; ++k) {
      const T* a_k = a + (long long)k * R;
      __syncthreads();  // cs loaded; the previous slice's readers are done
      if (PHI) {
        for (int p = tid; p < jc * R; p += nthreads) {
          const int jj = p / R, q = p - jj * R;
          cas[jj * Rs + q] = round_to<T>(cs[p] * to_f(a_k[q]));
        }
        __syncthreads();
      }
      // Phase A: the weights of rows i0.., columns j0.. of slice k.
      const T* x_k = x + (long long)k * I * J;
      for (int p = tid; p < ti * jc; p += nthreads) {
        const int pi = p / jc, jj = p - pi * jc;
        float w = 0.f;
        if (i0 + pi < I && jj < jn) {
          const float xv = to_f(x_k[(long long)(i0 + pi) * J + j0 + jj]);
          if (!PHI) {
            w = xv;
          } else if (xv > 0.f) {
            float m = 0.f;
            for (int q = 0; q < R; ++q) m += bs[pi * R + q] * cas[jj * Rs + q];
            w = round_to<T>(xv / max_eps(m, eps));
          }
        }
        ws[pi * wst + jj] = w;
      }
      __syncthreads();
      // Phase B: back-contraction of the weights against c, times a[k, r].
      const float* wrow = ws + ii * wst;
      float t = 0.f;
      for (int jj = 0; jj < jn; ++jj) t += wrow[jj] * cs[jj * R + r];
      acc += t * to_f(a_k[r]);
    }
  }
  if (i0 + ii < I) atomicAdd(&out[(long long)(i0 + ii) * R + r], acc);
}

template <typename T, bool PHI>
cudaError_t launch_accum(const void* x, const void* c, const void* a,
                         const void* b, void* out, int K, int I, int J, int R,
                         int kb, float eps, cudaStream_t stream) {
  // ti rows of R threads each (block_threads' R-wide groups), at most I
  const int ti = block_threads(R) / R < I ? block_threads(R) / R : I;
  // as many columns per chunk as the shared-memory budget allows
  const long long fixed = ti + (PHI ? (long long)ti * R : 0);
  const long long per_j = R + ti + (PHI ? (R | 1) : 0);
  long long jc = (kSmemFloats - fixed) / per_j;
  if (jc > J) jc = J;
  if (jc < 1) jc = 1;
  const size_t smem = sizeof(float) * (size_t)(fixed + per_j * jc);
  const int n_itiles = (I + ti - 1) / ti;
  const long long blocks = (long long)n_itiles * ((K + kb - 1) / kb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      dense_accum_kernel<T, PHI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dense_accum_kernel<T, PHI><<<(int)blocks, ti * R, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), K, I, J, R, kb, ti, (int)jc, n_itiles, eps);
  return cudaGetLastError();
}

template <bool PHI>
int dispatch(int dtype, const void* x, const void* c, const void* a,
             const void* b, void* out, int K, int I, int J, int R, int kb,
             float eps, cudaStream_t s) {
  if (dtype == 0)
    return (int)launch_accum<float, PHI>(x, c, a, b, out, K, I, J, R, kb, eps,
                                         s);
  if (dtype == 1)
    return (int)launch_accum<__nv_bfloat16, PHI>(x, c, a, b, out, K, I, J, R,
                                                 kb, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  out: zeroed (I, R) f32.
int dense_mttkrp_launch(int dtype, const void* x, const void* c, const void* a,
                        void* out, int K, int I, int J, int R, int block_k,
                        void* stream) {
  return dispatch<false>(dtype, x, c, a, nullptr, out, K, I, J, R, block_k,
                         0.f, static_cast<cudaStream_t>(stream));
}

// phi: zeroed (I, R) f32.
int dense_phi_launch(int dtype, const void* x, const void* c, const void* a,
                     const void* b, void* phi, int K, int I, int J, int R,
                     int block_k, float eps, void* stream) {
  return dispatch<true>(dtype, x, c, a, b, phi, K, I, J, R, block_k, eps,
                        static_cast<cudaStream_t>(stream));
}

// phi: zeroed (I, R) f32 scratch; mu: (I, R) in the element dtype; viol: one
// zeroed f32.
int dense_phi_mu_launch(int dtype, const void* x, const void* c, const void* a,
                        const void* b, void* phi, void* mu, void* viol, int K,
                        int I, int J, int R, int block_k, float eps,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = dispatch<true>(dtype, x, c, a, b, phi, K, I, J, R, block_k, eps, s);
  if (err != 0) return err;
  const long long n = (long long)I * R;
  if (dtype == 0) return (int)launch_epilogue<float>(b, phi, mu, viol, n, s);
  return (int)launch_epilogue<__nv_bfloat16>(b, phi, mu, viol, n, s);
}

}  // extern "C"
