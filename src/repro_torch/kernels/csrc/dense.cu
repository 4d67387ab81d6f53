// The dense matrix-free tier: one hand-written Hopper kernel over the
// mode-permuted dense tensor x (K, I, J), with c (J, R), a (K, R), B (I, R),
// in three instances.  Built with
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
//       the same Φ, then mu = B*Φ and viol = max |min(B, 1-Φ)|, in the same
//       launch (the TPU kernel's last grid step).
// Roundings follow the TPU bodies: c∘a_k is rounded to the element dtype
// before the first contraction, w is rounded to it before the second, every
// contraction accumulates in f32 (identities for f32 elements), and the
// second contraction is scaled by a_k after it, as (w @ c) * a_k.
//
// What bounds it on the H100.  The tier caps x at 2^22 cells, 16.8 MB in
// f32: 5.0 us of HBM traffic at 3.35 TB/s.  The arithmetic is 4R+1 flops
// per cell for Φ (2R for MTTKRP), 4.1 us at R = 16 at the 67 TFLOP/s f32
// rate: the bound is the bytes, but only just.  The first design issued two
// 4-byte shared loads per FMA and was bound by shared-memory loads.  This
// one is bound by instruction issue at 16 warps per SM: per cell of Φ about
// 16 FMAs of each contraction plus an IEEE divide, which costs as much as
// the model window's FMAs (PERF.md has the per-phase times).
//
// Design.
//   * Work split.  CTA (i-tile, k-range): ti rows of x and a contiguous
//     range of the K slices, ti and the split chosen on the host
//     (repro_torch/kernels/dense/kernel.py::launch_shape) so that the grid
//     fills the 132 SMs in one wave at the cap.  A CTA walks its (column
//     chunk, slice) pairs chunk by chunk, jc columns at a time.
//   * Streaming.  The (ti, jc) x tiles stream through a kStages-deep ring
//     in shared memory with 16-byte cp.async (zero-filled past I and J), so
//     the next tiles are in flight while one is contracted; x is read from
//     device memory once.  Shapes whose rows are not 16-byte aligned take
//     the same ring with plain loads.  The chunk's c rows are loaded into
//     shared memory once per chunk; B's tile once per CTA.
//   * Two register-tiled contractions per pair, each thread a 4 x 4 tile
//     of outputs read as 16-byte shared loads (8 FMAs per shared load; the
//     first design made 0.5):
//       phase A (Φ only), the model window m = B_tile round(c∘a_k)^T,
//         ti x jc, depth R, with round(c∘a_k) formed from the chunk per
//         pair, then w = x > 0 ? round(x / max(m, eps)) : 0 (MTTKRP: w = x)
//         into a (ti, jc) f32 weight tile;
//       phase B, the back-contraction w c, ti x R, depth jc split S ways
//         over the threads, scaled by a_k into each thread's 4 x 4 sum,
//         which stays in registers over all of the CTA's pairs.
//     A pair costs two CTA barriers (one more where the chunk changes).
//   * Partials, not atomics.  At the end each CTA sums its S partials in
//     shared memory in a fixed order and writes its (ti, R) partial to its
//     own slot of a work buffer.  The slots of an i-tile meet in a
//     two-level tree: the last CTA of each group of kGroup k-ranges (a
//     ticket: atomicAdd after a fence) sums the group's slots in order, and
//     the last group sums the group sums in order and writes the result: Φ
//     or M, or for the fused step mu = B*Φ and viol = max |min(B, 1-Φ)|
//     (common.cuh's mu_entry, one atomicMax per CTA).  So every result is
//     bitwise reproducible from run to run, Φ is never zeroed or reread as
//     a whole, and the fused step is one kernel (and the zeroing of its
//     4-byte viol).  The last CTA of each level resets its ticket, so a
//     launch leaves the tickets zero and the next launch on the stream
//     reuses them as they are.
//   * Any R in 1..1024 and any I, J, K >= 1: R is zero-padded to a multiple
//     of 4 in shared memory; past R = 64 the host narrows ti so that the
//     4 x 4 output tiles of phase B fit one per thread, and narrows jc so
//     that the footprint fits.  The footprint does not grow with J.
//
// The shared-memory footprint (dense_smem_bytes) is mirrored by
// repro_torch/kernels/dense/kernel.py::smem_bytes; keep the two equal.
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro_torch::block_max_into;
using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::from_f;
using repro_torch::kThreads;
using repro_torch::max_eps;
using repro_torch::mu_entry;
using repro_torch::resident_ctas;
using repro_torch::round_to;
using repro_torch::to_f;

constexpr int kStages = 3;  // x tiles in the ring
constexpr int kGroup = 8;   // k-ranges per group of the partials' tree
constexpr int kBatch = 8;   // partials a thread loads at once
enum Op { kMttkrp = 0, kPhi = 1, kPhiMu = 2 };

// n rounded up to a multiple of 4 whose quotient by 4 is odd: a row stride
// (in floats) at which 8 consecutive rows read 16 bytes each from distinct
// banks.
__host__ __device__ inline int odd4(int n) {
  int m = (n + 3) / 4;
  return 4 * (m % 2 ? m : m + 1);
}

struct Shape {
  int rp;     // R rounded up to a multiple of 4
  int rs;     // row stride of the B tile and the c∘a_k tiles, floats
  int ws;     // row stride of the weight tile, floats
  int xs;     // row stride of an x tile, elements (an odd count of 16 bytes)
  int nb;     // 4 x 4 output tiles of phase B
  int splits; // ways the depth of phase B is split
  long long bt, ca, cs, w, x_stage, red, smem;  // region bytes
};

// The footprint and strides for element size isz, operation op, rank R,
// tile ti x jc (ti a multiple of 4, jc a multiple of 8).
__host__ __device__ inline Shape dense_shape(int isz, int op, int R, int ti,
                                                int jc) {
  Shape s;
  s.rp = (R + 3) / 4 * 4;
  s.rs = odd4(R);
  s.ws = odd4(jc);
  int xb = (jc * isz + 15) / 16;  // 16-byte units per x row
  if (xb % 2 == 0) ++xb;
  s.xs = 16 * xb / isz;
  s.nb = (ti / 4) * (s.rp / 4);
  s.splits = s.nb >= kThreads ? 1 : kThreads / s.nb;
  const bool phi = op != kMttkrp;
  s.bt = phi ? 4LL * ti * s.rs : 0;
  s.ca = phi ? 4LL * jc * s.rs : 0;
  s.cs = 4LL * jc * s.rs;
  s.w = 4LL * ti * s.ws;
  s.x_stage = (long long)ti * s.xs * isz;
  s.red = 4LL * s.splits * ti * s.rp;
  const long long loop = s.ca + s.cs + s.w + kStages * s.x_stage;
  s.smem = s.bt + (loop > s.red ? loop : s.red);
  return s;
}

// 4 consecutive elements of T at p (16-byte aligned for f32, 8 for bf16).
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    T e[4];
    memcpy(e, &v, 8);
    return make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
  }
}

// (row, col) of the entries tid, tid + kThreads, ... of a row-major tile
// w wide, stepped without an integer divide per entry (w is known only at
// run time, where a divide costs some twenty instructions).
struct Walk {
  int row, col, drow, dcol, w;
  __device__ Walk(int tid, int w_) : w(w_) {
    row = tid / w;
    col = tid - row * w;
    drow = kThreads / w;
    dcol = kThreads - drow * w;
  }
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
};

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ASYNC: x rows are 16-byte aligned (J * sizeof(T) a multiple of 16, x
// aligned), so tiles move with cp.async; else with plain loads.
template <typename T, int OP, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 2)
dense_accum_kernel(const T* __restrict__ x, const T* __restrict__ c,
                   const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ out, T* __restrict__ mu,
                   unsigned* __restrict__ viol_bits, float* __restrict__ part,
                   int* __restrict__ tickets, int K, int I, int J, int R,
                   int ti, int jc, int n_ks, float eps) {
  constexpr bool PHI = OP != kMttkrp;
  extern __shared__ __align__(16) char smem[];
  const Shape sh = dense_shape(sizeof(T), OP, R, ti, jc);
  const int rs = sh.rs, ws = sh.ws, xs = sh.xs, rp = sh.rp;
  float* bt = reinterpret_cast<float*>(smem);  // [ti][rs] B tile, Φ only
  char* loop = smem + sh.bt;
  float* ca = reinterpret_cast<float*>(loop);  // [jc][rs] round(c∘a_k)
  float* cs = reinterpret_cast<float*>(loop + sh.ca);  // [jc][rs] c chunk
  float* wt = reinterpret_cast<float*>(loop + sh.ca + sh.cs);  // [ti][ws]
  T* xt = reinterpret_cast<T*>(loop + sh.ca + sh.cs + sh.w);   // [kStages]
  float* red = reinterpret_cast<float*>(loop);  // [splits][ti][rp], at the end

  const int tid = threadIdx.x;
  const int n_itiles = (I + ti - 1) / ti;
  const int itile = blockIdx.x % n_itiles, ks = blockIdx.x / n_itiles;
  const int i0 = itile * ti;
  const int k_lo = (int)((long long)ks * K / n_ks);
  const int nk = (int)((long long)(ks + 1) * K / n_ks) - k_lo;
  const int n_it = nk * ((J + jc - 1) / jc);  // (column chunk, slice) pairs
  const int t4 = ti / 4;

  if constexpr (PHI) {
    Walk e(tid, rp);
    for (int p = tid; p < ti * rp; p += kThreads, e.next())
      bt[e.row * rs + e.col] =
          (i0 + e.row < I && e.col < R)
              ? to_f(b[(long long)(i0 + e.row) * R + e.col]) : 0.f;
  }

  // the x tile of pair it (chunk it / nk, slice k_lo + it % nk) into ring
  // stage it % kStages
  auto issue = [&](int it) {
    if (it < n_it) {
      const int k = k_lo + it % nk, j0 = it / nk * jc;
      T* dst = xt + (long long)(it % kStages) * ti * xs;
      const T* src = x + ((long long)k * I + i0) * J + j0;
      if constexpr (ASYNC) {
        constexpr int V = 16 / sizeof(T);
        const int per_row = jc / V;
        Walk e(tid, per_row);
        for (int p = tid; p < ti * per_row; p += kThreads, e.next()) {
          const int i = e.row, v = e.col * V;
          const bool in = i0 + i < I && j0 + v < J;
          cp_async16(dst + i * xs + v, in ? src + (long long)i * J + v : x,
                     in ? 16 : 0);
        }
      } else {
        Walk e(tid, jc);
        for (int p = tid; p < ti * jc; p += kThreads, e.next())
          dst[e.row * xs + e.col] =
              (i0 + e.row < I && j0 + e.col < J)
                  ? src[(long long)e.row * J + e.col] : from_f<T>(0.f);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int q = 0; q < kStages - 1; ++q) issue(q);

  // phase B's 4 x 4 tile: rows ib + t4*u, columns 4*rb.., depth slice s
  const int tb = tid % sh.nb, s = tid / sh.nb;
  const bool b_on = s < sh.splits;
  const int ib = tb % t4, rb = tb / t4;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    issue(it + kStages - 1);
    const int k = k_lo + it % nk, j0 = it / nk * jc;
    const int jn = min(jc, J - j0);
    const T* x_p = xt + (long long)(it % kStages) * ti * xs;
    const T* a_k = a + (long long)k * R;

    // A new chunk: its c rows into cs, each thread the entries it then
    // scales (after every thread is done with the last chunk's).
    if (it % nk == 0) {
      if (it > 0) __syncthreads();
      Walk e(tid, rp);
      for (int p = tid; p < jc * rp; p += kThreads, e.next())
        cs[e.row * rs + e.col] =
            (e.row < jn && e.col < R)
                ? to_f(c[(long long)(j0 + e.row) * R + e.col]) : 0.f;
    }
    // c∘a_k rounded to T, phase A's operand (its readers, the last pair's
    // phase A, are past the last pair's second barrier)
    if constexpr (PHI) {
      Walk e(tid, rp);
      for (int p = tid; p < jc * rp; p += kThreads, e.next())
        ca[e.row * rs + e.col] =
            e.col < R ? round_to<T>(cs[e.row * rs + e.col] *
                                    to_f(__ldg(a_k + e.col)))
                      : 0.f;
    }
    cp_async_wait<kStages - 1>();  // this thread's copies of tile it landed
    __syncthreads();

    // Phase A: w for the (ti, jc) tile, 4 x 4 per thread: rows ia + t4*u,
    // columns 4*ja..
    for (int t = tid; t < t4 * (jc / 4); t += kThreads) {
      const int ia = t % t4, ja = t / t4;
      float m[4][4];
      if constexpr (PHI) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) m[u][v] = 0.f;
        for (int q = 0; q < rp; q += 4) {
          float4 bq[4], cq[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            bq[u] = *reinterpret_cast<const float4*>(
                &bt[(ia + t4 * u) * rs + q]);
#pragma unroll
          for (int v = 0; v < 4; ++v)
            cq[v] = *reinterpret_cast<const float4*>(
                &ca[(4 * ja + v) * rs + q]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              float mm = m[u][v];
              mm = fmaf(bq[u].x, cq[v].x, mm);
              mm = fmaf(bq[u].y, cq[v].y, mm);
              mm = fmaf(bq[u].z, cq[v].z, mm);
              mm = fmaf(bq[u].w, cq[v].w, mm);
              m[u][v] = mm;
            }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 xv = load4<T>(x_p + (ia + t4 * u) * xs + 4 * ja);
        float w[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float xe = at(xv, v);
          if constexpr (PHI)
            w[v] = xe > 0.f ? round_to<T>(xe / max_eps(m[u][v], eps)) : 0.f;
          else
            w[v] = xe;
        }
        *reinterpret_cast<float4*>(&wt[(ia + t4 * u) * ws + 4 * ja]) =
            make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();

    // Phase B: t = w c over this thread's share of the columns, then
    // acc += t a_k, as the TPU kernel's (w @ c) * a_k
    if (b_on) {
      float t[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[u][e] = 0.f;
      const int ng = (jn + 3) / 4;
      for (int jg = s; jg < ng; jg += sh.splits) {
        float4 wv[4], cv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wv[u] = *reinterpret_cast<const float4*>(
              &wt[(ib + t4 * u) * ws + 4 * jg]);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          cv[v] = *reinterpret_cast<const float4*>(
              &cs[(4 * jg + v) * rs + 4 * rb]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float y = t[u][e];
            y = fmaf(wv[u].x, at(cv[0], e), y);
            y = fmaf(wv[u].y, at(cv[1], e), y);
            y = fmaf(wv[u].z, at(cv[2], e), y);
            y = fmaf(wv[u].w, at(cv[3], e), y);
            t[u][e] = y;
          }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ak = 4 * rb + e < R ? to_f(__ldg(a_k + 4 * rb + e)) : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u][e] = fmaf(t[u][e], ak, acc[u][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is past its last read of the ring

  // The CTA's (ti, R) partial: its splits summed in order, into its slot
  if (b_on) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(
          &red[((long long)s * ti + ib + t4 * u) * rp + 4 * rb]) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
  __syncthreads();
  const long long i_pad = (long long)n_itiles * ti;
  Walk e(tid, R);
  for (int p = tid; p < ti * R; p += kThreads, e.next()) {
    const int i = e.row, r = e.col;
    float v = 0.f;
    for (int q = 0; q < sh.splits; ++q)
      v += red[((long long)q * ti + i) * rp + r];
    part[((long long)ks * i_pad + i0 + i) * R + r] = v;
  }

  // The partials meet in a two-level tree, each level in a fixed order:
  // the last CTA of each group of kGroup k-ranges to get here sums the
  // group's slots into its first; the last of the groups sums those and
  // writes the result.  One release fence and ticket per CTA per level,
  // after the CTA's writes (ordered by the barrier), and an acquire fence
  // by the last one.
  __shared__ int last;
  auto ticket = [&](int* t, int n) -> bool {  // true in the last of n CTAs
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(t, 1) == n - 1;
      if (last) __threadfence();
    }
    __syncthreads();
    return last;
  };
  // entry f of slots first, first + step, ... (count of them), summed in
  // order, kBatch loads in flight at a time
  auto sum_slots = [&](int f, int first, int count, int step) -> float {
    const float* src = part + ((long long)first * i_pad + i0) * R + f;
    const long long stride = (long long)step * i_pad * R;
    float v = 0.f;
    for (int q0 = 0; q0 < count; q0 += kBatch) {
      float l[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e)
        l[e] = q0 + e < count ? __ldcg(src + (q0 + e) * stride) : 0.f;
#pragma unroll
      for (int e = 0; e < kBatch; ++e) v += l[e];
    }
    return v;
  };
  const int n_groups = (n_ks + kGroup - 1) / kGroup, g = ks / kGroup;
  const int g_n = min(kGroup, n_ks - g * kGroup);
  int* tk = tickets + (long long)itile * (n_groups + 1);  // [final, groups]
  if (!ticket(tk + 1 + g, g_n)) return;
  if (tid == 0) tk[1 + g] = 0;  // every CTA of the group has taken its ticket
  if (g_n > 1)
    for (int f = tid; f < ti * R; f += kThreads)
      part[((long long)g * kGroup * i_pad + i0) * R + f] =
          sum_slots(f, g * kGroup, g_n, 1);
  if (!ticket(tk, n_groups)) return;
  if (tid == 0) tk[0] = 0;  // the tickets are zero again for the next launch
  unsigned hi = 0u;
  for (int f = tid; f < ti * R; f += kThreads) {
    const float v = sum_slots(f, 0, n_groups, kGroup);
    if (f < (I - i0) * R) {
      const long long o = (long long)i0 * R + f;
      if constexpr (OP == kPhiMu)
        hi = max(hi, mu_entry<T>(b[o], v, mu + o));
      else
        out[o] = v;
    }
  }
  if constexpr (OP == kPhiMu) block_max_into(hi, viol_bits);
}

template <typename T, int OP, bool ASYNC>
cudaError_t launch_async(const void* x, const void* c, const void* a,
                         const void* b, void* out, void* mu, void* viol,
                         void* part, void* tickets, int K, int I, int J, int R,
                         int ti, int jc, int n_ks, float eps,
                         cudaStream_t stream) {
  const Shape sh = dense_shape(sizeof(T), OP, R, ti, jc);
  auto kern = dense_accum_kernel<T, OP, ASYNC>;
  int resident = 0;  // raises the instance's shared-memory limit once
  const cudaError_t err = resident_ctas(reinterpret_cast<const void*>(kern),
                                        kThreads, sh.smem, &resident);
  if (err != cudaSuccess) return err;
  const long long n_itiles = (I + ti - 1) / ti;
  kern<<<(unsigned)(n_itiles * n_ks), kThreads, sh.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), static_cast<T*>(mu),
      static_cast<unsigned*>(viol), static_cast<float*>(part),
      static_cast<int*>(tickets), K, I, J, R, ti, jc, n_ks, eps);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_op(const void* x, const void* c, const void* a,
                      const void* b, void* out, void* mu, void* viol,
                      void* part, void* tickets, int K, int I, int J, int R,
                      int ti, int jc, int n_ks, float eps,
                      cudaStream_t stream) {
  const bool aligned = (long long)J * sizeof(T) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(x) % 16 == 0;
  if (aligned)
    return launch_async<T, OP, true>(x, c, a, b, out, mu, viol, part, tickets,
                                     K, I, J, R, ti, jc, n_ks, eps, stream);
  return launch_async<T, OP, false>(x, c, a, b, out, mu, viol, part, tickets,
                                    K, I, J, R, ti, jc, n_ks, eps, stream);
}

// Checks the host-chosen launch shape, then dispatches on the dtype.
template <int OP>
int dispatch(int dtype, const void* x, const void* c, const void* a,
             const void* b, void* out, void* mu, void* viol, void* part,
             void* tickets, int K, int I, int J, int R, int ti, int jc,
             int n_ks, float eps, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : 2;
  if (K < 1 || I < 1 || J < 1 || R < 1 || R > 1024 || ti < 4 || ti % 4 ||
      jc < 8 || jc % 8 || n_ks < 1 || n_ks > K ||
      dense_shape(isz, OP, R, ti, jc).nb > kThreads ||
      (long long)((I + ti - 1) / ti) * n_ks > 0x7fffffffLL ||
      dense_shape(isz, OP, R, ti, jc).smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_op<float, OP>(x, c, a, b, out, mu, viol, part, tickets,
                                     K, I, J, R, ti, jc, n_ks, eps, s);
  return (int)launch_op<__nv_bfloat16, OP>(x, c, a, b, out, mu, viol, part,
                                           tickets, K, I, J, R, ti, jc, n_ks,
                                           eps, s);
}

}  // namespace

extern "C" {

// Shared memory per CTA (dtype 0 = f32, 1 = bf16; op 0 = MTTKRP, 1 = Φ,
// 2 = fused Φ -> MU) at tile ti x jc.
int dense_smem_bytes(int dtype, int op, int R, int ti, int jc) {
  return (int)dense_shape(dtype == 1 ? 2 : 4, op, R, ti, jc).smem;
}

// The launch shape (ti, jc, n_ks) comes from the host (kernels/dense/
// kernel.py::launch_shape).  part: (n_ks, ceil(I/ti)*ti, R) f32, any
// contents; tickets: ceil(I/ti) * (ceil(n_ks/8) + 1) int32, zero, and left
// zero; out: (I, R) f32, written.
int dense_mttkrp_launch(int dtype, const void* x, const void* c, const void* a,
                        void* out, void* part, void* tickets, int K, int I,
                        int J, int R, int ti, int jc, int n_ks, void* stream) {
  return dispatch<kMttkrp>(dtype, x, c, a, nullptr, out, nullptr, nullptr,
                           part, tickets, K, I, J, R, ti, jc, n_ks, 0.f,
                           static_cast<cudaStream_t>(stream));
}

// phi: (I, R) f32, written; part and tickets as above.
int dense_phi_launch(int dtype, const void* x, const void* c, const void* a,
                     const void* b, void* phi, void* part, void* tickets,
                     int K, int I, int J, int R, int ti, int jc, int n_ks,
                     float eps, void* stream) {
  return dispatch<kPhi>(dtype, x, c, a, b, phi, nullptr, nullptr, part,
                        tickets, K, I, J, R, ti, jc, n_ks, eps,
                        static_cast<cudaStream_t>(stream));
}

// mu: (I, R) in the element dtype, written; viol: one zeroed f32; part and
// tickets as above.  One kernel launch.
int dense_phi_mu_launch(int dtype, const void* x, const void* c, const void* a,
                        const void* b, void* mu, void* viol, void* part,
                        void* tickets, int K, int I, int J, int R, int ti,
                        int jc, int n_ks, float eps, void* stream) {
  return dispatch<kPhiMu>(dtype, x, c, a, b, nullptr, mu, viol, part, tickets,
                          K, I, J, R, ti, jc, n_ks, eps,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
