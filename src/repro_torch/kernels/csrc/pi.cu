// Π^(n) rows and the values in the blocked layout's slot order: the
// hand-written Hopper kernel that forms the operands of the Φ kernels
// (phi.cu) and of sparse MTTKRP (mttkrp.cu) once per mode update, built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below; the launcher returns
// cudaGetLastError() so the Python wrapper can raise).
//
// Replaces no TPU kernel: the JAX package forms Π with plain jnp (its
// core/pi.py pi_rows, then the layout expansion in core/phi.py), which XLA
// fuses.  In PyTorch that is 2N + 3 passes over (nnz, R) or (slots, R)
// arrays (a ones fill, one row gather and one product per other mode, the
// gathers into slot order and their wheres), each at a fraction of the
// card's bandwidth; this kernel is their one pass.
//
// What it computes.  For every slot j of the layout (lt.gather, lt.valid),
// the (nnz, N) sorted coordinates idx and the (nnz,) sorted values vals:
//   pi_e[j, r] = valid[j]
//       ? prod_{m != n, ascending} A^(m)[idx[gather[j], m], r] : 0
//   vals_e[j]  = valid[j] ? vals[gather[j]] : 0
// starting from 1 and rounding each product to the element dtype (f32:
// __fmul_rn; bf16: the f32 product rounded to bf16), which is bitwise what
// pi_rows followed by the layout expansion gives.  The values are copied,
// not converted.  Both are made anew each mode update and freed after it,
// so no slot-ordered copy of the values outlives its mode update.
//
// What bounds it on the H100.  Bytes: per slot it writes R + 1 elements
// (68 B at R = 16 in f32) and reads gather (8 B), valid (1 B), its value
// and N-1 coordinates (8 B each); the factors (well under the 50 MB L2 at
// the benchmark's shapes) are read from L2.  It does N-1 multiplies per
// element, so the bound is those bytes over HBM bandwidth.
//
// Design.  A group of R*esz/16 lanes covers one slot (one element per lane
// where a row is not a multiple of 16 bytes or a factor is misaligned),
// each lane with 16-byte __ldg factor loads and a 16-byte store, so a
// warp's stores are contiguous.  A lane loads its slot's coordinates of
// every factor first and then every factor row, so a slot waits on three
// dependent loads (gather, coordinates, rows); the group's first lane also
// copies the slot's value.  lt.gather is monotone over the valid slots, so
// the coordinate and value reads stream.  Persistent CTAs walk
// the slots grid-stride.  At most kMaxFactors factors go to one kernel
// launch; the launcher chains launches for more modes, each later launch
// multiplying into the rows the earlier one wrote, in the same order (the
// first launch alone writes the values).
#include "common.cuh"

namespace {

using repro_torch::from_f;
using repro_torch::kThreads;
using repro_torch::resident_ctas;
using repro_torch::round_to;
using repro_torch::to_f;

constexpr int kMaxFactors = 4;  // N <= 5 in one launch

struct Factors {
  const void* ptr[kMaxFactors];
  int col[kMaxFactors];  // the coordinate column (mode) of each factor
  int count;
};

// V consecutive elements of a row as floats: one 16-byte load, or V == 1.
template <typename T, int V>
__device__ __forceinline__ void load_elems(const T* p, float (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = to_f(e[i]);
  } else {
    static_assert(V == 1, "one element or 16 bytes");
    x[0] = to_f(p[0]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_elems(T* p, const float (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(x[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = from_f<T>(x[0]);
  }
}

// blockDim = (lanes of a slot, or kThreads if more; slots per CTA).  first:
// the products start from 1 and the values are written, else the products
// start from the rows already in out.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) pi_gather_kernel(
    const long long* __restrict__ gather, const bool* __restrict__ valid,
    const long long* __restrict__ idx, const T* __restrict__ vals,
    const Factors f, T* __restrict__ out, T* __restrict__ vals_out,
    long long n_slots, int n_modes, int R, bool first) {
  const int lanes = R / V;
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long j = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       j < n_slots; j += step) {
    // both loads at once: a padding slot's gather is 0, read but not used
    const bool ok = valid[j];
    const long long g = gather[j];
    const long long* coords = idx + g * n_modes;
    if (first && threadIdx.x == 0)
      vals_out[j] = ok ? vals[g] : from_f<T>(0.f);
    long long rows[kMaxFactors];
#pragma unroll
    for (int k = 0; k < kMaxFactors; ++k)
      if (k < f.count && ok) rows[k] = __ldg(coords + f.col[k]);
    for (int c = threadIdx.x; c < lanes; c += blockDim.x) {
      T* o = out + j * R + c * V;
      float p[V];
      if (first) {
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = 1.f;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = to_f(o[i]);
      }
      if (ok) {
        float x[kMaxFactors][V];
#pragma unroll
        for (int k = 0; k < kMaxFactors; ++k)
          if (k < f.count)
            load_elems<T, V>(
                static_cast<const T*>(f.ptr[k]) + rows[k] * R + c * V, x[k]);
#pragma unroll
        for (int k = 0; k < kMaxFactors; ++k)
          if (k < f.count) {
#pragma unroll
            for (int i = 0; i < V; ++i)
              p[i] = round_to<T>(__fmul_rn(p[i], x[k][i]));
          }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = 0.f;
      }
      store_elems<T, V>(o, p);
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* gather, const void* valid, const void* idx,
                   const void* vals, const Factors& f, void* out,
                   void* vals_out, long long n_slots, int n_modes, int R,
                   bool first, cudaStream_t stream) {
  const auto kern = pi_gather_kernel<T, V>;
  const int lanes = R / V;
  const int tx = lanes < kThreads ? lanes : kThreads;
  const int ty = kThreads / tx;
  int resident = 0;
  const cudaError_t err = resident_ctas(reinterpret_cast<const void*>(kern),
                                        tx * ty, 0, &resident);
  if (err != cudaSuccess) return err;
  long long blocks = (n_slots + ty - 1) / ty;
  if (blocks > resident) blocks = resident;
  kern<<<(int)blocks, dim3(tx, ty), 0, stream>>>(
      static_cast<const long long*>(gather), static_cast<const bool*>(valid),
      static_cast<const long long*>(idx), static_cast<const T*>(vals), f,
      static_cast<T*>(out), static_cast<T*>(vals_out), n_slots, n_modes, R,
      first);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(bool vec, const void* gather, const void* valid,
                        const void* idx, const void* vals, const Factors& f,
                        void* out, void* vals_out, long long n_slots,
                        int n_modes, int R, bool first, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec)
    return launch<T, kVec>(gather, valid, idx, vals, f, out, vals_out,
                           n_slots, n_modes, R, first, stream);
  return launch<T, 1>(gather, valid, idx, vals, f, out, vals_out, n_slots,
                      n_modes, R, first, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  gather: (n_slots,) int64; valid:
// (n_slots,) bool; idx: (nnz, n_modes) int64, row-major; vals: (nnz,) in
// the element dtype; factors: n_modes device pointers (host array), each
// (I_m, R) row-major in the element dtype; out: (n_slots, R) and vals_out:
// (n_slots,) in the element dtype, every element written.
int pi_gather_launch(int dtype, const void* gather, const void* valid,
                     const void* idx, const void* vals, int n_modes, int mode,
                     const void* const* factors, void* out, void* vals_out,
                     long long n_slots, int R, void* stream) {
  if (n_slots == 0) return 0;
  const int esz = dtype == 1 ? 2 : 4;
  bool vec = (R * esz) % 16 == 0 && aligned16(out);
  for (int m = 0; m < n_modes; ++m)
    if (m != mode) vec = vec && aligned16(factors[m]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int m = 0;
  for (bool first = true;; first = false) {
    Factors f{};  // the next kMaxFactors factors, ascending
    for (; m < n_modes && f.count < kMaxFactors; ++m) {
      if (m == mode) continue;
      f.ptr[f.count] = factors[m];
      f.col[f.count++] = m;
    }
    const cudaError_t err =
        dtype == 0
            ? launch_rows<float>(vec, gather, valid, idx, vals, f, out,
                                 vals_out, n_slots, n_modes, R, first, s)
            : launch_rows<__nv_bfloat16>(vec, gather, valid, idx, vals, f,
                                         out, vals_out, n_slots, n_modes, R,
                                         first, s);
    if (err != cudaSuccess) return (int)err;
    if (n_modes - m - (mode >= m ? 1 : 0) <= 0) break;  // no factor left
  }
  return 0;
}

}  // extern "C"
