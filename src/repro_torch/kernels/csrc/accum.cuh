// The accumulation kernel on the blocked layout, shared by the Φ kernels
// (phi.cu: B1's pass 1 and all of B2) and sparse MTTKRP (mttkrp.cu: B3):
// one kernel body, templated on the operation.  Included by both sources;
// the build hashes every *.cuh with each source.
//
// What it computes.  Grid step g covers block_nnz sorted slots of row
// block rb = grid_rb[g]; for each slot j with local row l_j and row
// v_j (a Π row for Φ, a Khatri-Rao row for MTTKRP):
//   Φ (PHI):      w_j = x_j > 0 ? x_j / max(<B[row_j, :], v_j>, eps) : 0
//   MTTKRP:       w_j = x_j  (any sign; a NaN counts)
//   out[rb*br + l_j, :] += round(w_j * v_j)
// where round() is the element dtype (the TPU kernels' (w*v).astype), every
// sum in f32 into a zeroed f32 window.  A slot with w_j == 0 (padding, a
// zero value, a Φ weight of x <= 0) adds exactly 0 and is skipped.  The
// MTTKRP instance reads no B row, forms no dot and no divide.
//
// What bounds it on the H100.  Bytes: per slot it reads x, l and an R-wide
// row (72 B at R = 16 in f32) and does ~4R+2 (Φ) or 2R (MTTKRP) flops, far
// below the card's ridge point; B (Φ only) stays in L1/L2.  The bound is
// the row stream over HBM bandwidth.
//
// Design.
//   * Work split.  The layout's slots (n_grid * block_nnz, in row order:
//     row blocks ascending, local rows ascending within a step) are cut
//     into one contiguous range per warp over persistent CTAs (as many as
//     are resident at once, counted once per shape and kept), so a warp's
//     range spans many grid steps and a hub row that spans thousands of
//     steps is still spread over every SM.  (One CTA per grid step was
//     measured 1.5-5.8x slower for Φ: each warp then lands a run for a
//     sliver of a step; PERF.md.)  A step's rows, values and local rows
//     are contiguous, so a warp's range is one contiguous stream.
//   * Ring.  Each warp streams its range through its own ring of kStages
//     shared-memory stages: a chunk of at most kChunkBytes of f32 rows
//     (the same count of bf16 rows; at least one row, never more than a
//     step) with its values, local rows and the one or two row blocks it
//     touches, copied with 16-byte cp.async.cg by the warp's lanes, one
//     copy of every 16-byte block the chunk overlaps, so any alignment
//     works (the bytes around a chunk that share its first or last 16-byte
//     block are copied and not read; such a block never leaves the
//     allocation, whose start and size are multiples of 16).  While a
//     chunk is reduced the next one is in flight.  A warp waits on its own
//     copies (cp.async.wait_group, __syncwarp): no CTA-wide barrier.  The
//     ring's bytes depend on R only through the row count, never on
//     block_nnz x R; the warps per CTA are as many as fit kSmemBudget.
//   * One pass per chunk.  A group of G lanes takes one slot (G = the
//     16-byte vectors of a row, at most a warp: 4 lanes at R = 16 in f32,
//     2 in bf16), so a warp takes 32/G consecutive slots at a time.  Each
//     lane reads its 16-byte slices of the row from shared memory (and,
//     for Φ, of the B row from global memory, L1/L2; the group reduces the
//     dot with xor shuffles and forms the weight), and rounds each
//     contribution w*v to the element dtype, all from registers: the rows
//     are never read from device memory a second time.  Rows whose 16-byte
//     slices are not aligned (R*sizeof(T) not a multiple of 16) take the
//     same path with one element per lane access.
//   * Runs of equal rows.  Each lane keeps its slot's share of the open
//     run in registers across chunks and steps; while every slot is on the
//     open run's row (one warp vote) that is all an iteration does.  Where
//     the row changes, a segmented shuffle scan keyed by row combines the
//     slots, and each finished run adds once per column to the zeroed f32
//     window in global memory: one atomicAdd per (row, r) per run of a
//     warp's range, so at most one per (touched row, r) per range and one
//     more at each range end -- the paper's "atomics only at segment
//     boundaries" (CPU Alg. 4).
// Float atomics make the summation order, and so the last bits of the
// result, vary from run to run; the wrappers' plain versions agree to a
// stated tolerance.
//
// Layout facts relied on (repro_torch/core/layout.py): the valid slots of a
// grid step are a prefix of it, their local rows are non-decreasing, the
// steps of a row block are consecutive and row blocks ascend, and padding
// slots carry x = 0 (weight exactly 0, skipped).
//
// The shared-memory footprint (accum_shape(...).smem, reported by each
// library's *_smem_bytes) is mirrored by
// repro_torch/kernels/phi/kernel.py::smem_bytes; keep the two equal.
#pragma once

#include <limits.h>
#include <string.h>

#include "common.cuh"

namespace repro_torch {
namespace blocked {

constexpr int kMaxThreads = 256;        // at most 8 warps per CTA
constexpr int kStages = 2;              // ring stages per warp
constexpr int kChunkBytes = 2048;       // f32 Π bytes per stage
constexpr int kSmemBudget = 56 * 1024;  // shared bytes per CTA, at most

__host__ __device__ inline long long round16(long long n) {
  return (n + 15) & ~15LL;
}
// shared bytes that hold a copy of n bytes at any 16-byte phase
__host__ __device__ inline long long region(long long n) {
  return round16(n) + 16;
}

struct Shape {
  int chunk;  // nonzeros per ring stage
  int warps;  // warps per CTA
  long long pi_region, x_region, l_region, stage_bytes, smem;
};

inline Shape accum_shape(int isz, int bn, int R) {
  Shape s;
  // nonzeros per stage from the f32 row, so a bf16 ring is never larger
  long long ch = kChunkBytes / (4LL * R);
  if (ch < 1) ch = 1;
  if (ch > bn) ch = bn;  // a chunk touches at most two grid steps
  s.chunk = (int)ch;
  s.pi_region = region(ch * R * isz);
  s.x_region = region(ch * isz);
  s.l_region = region(ch * 4);
  s.stage_bytes = s.pi_region + s.x_region + s.l_region + region(8);
  // warps per CTA from the f32 stage, so a bf16 CTA is never larger
  const long long f32_stage = region(ch * R * 4) + region(ch * 4) +
                              region(ch * 4) + region(8);
  long long w = kSmemBudget / (kStages * f32_stage);
  if (w > kMaxThreads / 32) w = kMaxThreads / 32;
  if (w < 1) w = 1;
  s.warps = (int)w;
  s.smem = w * kStages * s.stage_bytes;
  return s;
}

// The 32 lanes of a warp copy every 16-byte block that [src, src+nbytes)
// overlaps into dst (16-byte aligned); the first byte lands at
// dst + (src & 15).
__device__ __forceinline__ void warp_copy(char* dst, const void* src,
                                          long long nbytes, int lane) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(src);
  const unsigned long long lo = a & ~15ULL;
  const int nblk = (int)((a + nbytes - lo + 15) >> 4);
  for (int i = lane; i < nblk; i += 32)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(lo + 16ULL * i));
}

template <typename T>
__device__ __forceinline__ const T* landed(const char* dst, const void* src) {
  return reinterpret_cast<const T*>(
      dst + (reinterpret_cast<unsigned long long>(src) & 15ULL));
}

// VEC consecutive elements of T at p (16-byte aligned when VEC > 1) as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte vector");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    T e[VEC];
    memcpy(e, &v, 16);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec_global(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f(p[0]);
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    T e[VEC];
    memcpy(e, &v, 16);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
  }
}

// Sum of v over the slots of a warp (lanes with the same position gl in
// their group); every lane gets its column's total.
template <int E>
__device__ __forceinline__ void slot_sum(float* v, int G) {
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], o);
  }
}

// GT: lanes per nonzero when known at compile time, else 0 and computed
// from R (the one-element path).
template <bool PHI, typename T, int VEC, int KV, int GT>
__global__ void __launch_bounds__(kMaxThreads)
phi_accum_kernel(const int* __restrict__ grid_rb, const T* __restrict__ vals,
                 const int* __restrict__ lrow, const T* __restrict__ pi,
                 const T* __restrict__ b, float* __restrict__ phi, int n_grid,
                 int bn, int br, int R, float eps, int chunk, int pi_region,
                 int x_region, int l_region, int stage_bytes) {
  constexpr int E = VEC * KV;  // elements of a row each lane holds
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) char smem[];

  // lanes per nonzero: the row's VEC-wide slices, rounded up to a power of
  // two and capped at a warp (then each lane takes KV slices)
  int G = GT;
  if (GT == 0) {
    G = 1;
    while (G < R / VEC && G < 32) G <<= 1;
  }
  const int NS = 32 / G;  // nonzeros per warp at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = lane / G, gl = lane - s * G;

  // this warp's contiguous range of slots
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const long long wid = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long total = (long long)n_grid * bn;
  const long long j_lo = wid * total / warps, j_hi = (wid + 1) * total / warps;
  const long long nq = (j_hi - j_lo + chunk - 1) / chunk;
  char* ring = smem + (long long)warp * kStages * stage_bytes;

  // The producer's and the consumer's next chunk: first slot, its grid
  // step, ring stage (a chunk is at most a step, so it ends in the same
  // step or the next one).
  long long pj = j_lo, pg = j_lo / bn;
  int pst = 0;
  auto issue = [&]() {
    if (pj < j_hi) {
      const int n = (int)min((long long)chunk, j_hi - pj);
      char* st = ring + pst * stage_bytes;
      warp_copy(st, pi + pj * R, (long long)n * R * sizeof(T), lane);
      warp_copy(st + pi_region, vals + pj, (long long)n * sizeof(T), lane);
      warp_copy(st + pi_region + x_region, lrow + pj, 4LL * n, lane);
      warp_copy(st + pi_region + x_region + l_region, grid_rb + pg,
                pg + 1 < n_grid ? 8 : 4, lane);
      pj += n;
      if (pj >= (pg + 1) * bn) ++pg;
      if (++pst == kStages) pst = 0;
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int q = 0; q < kStages - 1; ++q) issue();

  // The open run: its global row (warp-uniform, -1 for none) and this
  // lane's share of its sum (the run's total is the sum over the slots).
  int rkey = -1;
  float run[E];
#pragma unroll
  for (int e = 0; e < E; ++e) run[e] = 0.f;
  auto land = [&](int row, const float* v) {
    float* dst = phi + (long long)row * R;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int col = (gl + k * G) * VEC;
      if (col < R) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) atomicAdd(&dst[col + e], v[k * VEC + e]);
      }
    }
  };

  long long cj = j_lo, cg = j_lo / bn;
  int cst = 0;
  for (long long q = 0; q < nq; ++q) {
    issue();
    cp_async_wait<kStages - 1>();
    __syncwarp();

    const int n = (int)min((long long)chunk, j_hi - cj);
    const char* st = ring + cst * stage_bytes;
    const T* pis = landed<T>(st, pi + cj * R);
    const T* xs = landed<T>(st + pi_region, vals + cj);
    const int* ls = landed<int>(st + pi_region + x_region, lrow + cj);
    const int* rbs = landed<int>(st + pi_region + x_region + l_region,
                                 grid_rb + cg);
    const int t = (int)((cg + 1) * bn - cj);  // slots before the next step
    const int row_lo = rbs[0] * br;
    const int row_hi = t < n ? rbs[1] * br : row_lo;

    for (int i = s; i - s < n; i += NS) {
      const bool valid = i < n;
      float p[E], acc[E];
      float part = 0.f;
      const float x = valid ? to_f(xs[i]) : 0.f;
      const int row = valid ? (i < t ? row_lo : row_hi) + ls[i] : 0;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int col = (gl + k * G) * VEC;
        if (valid && col < R) {
          load_vec<T, VEC>(pis + (long long)i * R + col, p + k * VEC);
          if constexpr (PHI) {
            float bv[VEC];
            load_vec_global<T, VEC>(b + (long long)row * R + col, bv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) part += bv[e] * p[k * VEC + e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) p[k * VEC + e] = 0.f;
        }
      }
      float wj = x;  // MTTKRP: the value itself, of any sign (NaN counts)
      if constexpr (PHI) {
#pragma unroll
        for (int o = G >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(kAll, part, o);
        wj = x > 0.f ? x / max_eps(part, eps) : 0.f;
      }
      const int key = (valid && wj != 0.f) ? row : -1;  // a zero weight adds 0
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = key >= 0 ? round_to<T>(__fmul_rn(wj, p[e])) : 0.f;

      if (__all_sync(kAll, key == rkey || key < 0)) {
        // the common case: every slot on the open run's row (or adding 0)
#pragma unroll
        for (int e = 0; e < E; ++e) run[e] += acc[e];
        continue;
      }
      const int kmax = __reduce_max_sync(kAll, key);
      const int kmin = __reduce_min_sync(kAll, key >= 0 ? key : INT_MAX);
      if (kmin == kmax && rkey < 0) {  // the first run
        rkey = kmax;
#pragma unroll
        for (int e = 0; e < E; ++e) run[e] = acc[e];
        continue;
      }
      // the open run ends here or joins slot 0's run
      if (rkey >= 0) slot_sum<E>(run, G);
      if (kmin == kmax) {  // one row, a new run
        if (s == 0) land(rkey, run);
        rkey = kmax;
#pragma unroll
        for (int e = 0; e < E; ++e) run[e] = acc[e];
        continue;
      }
      // several rows: a segmented inclusive scan over the slots, runs of
      // equal key, with the open run carried into slot 0
      const int key0 = __shfl_sync(kAll, key, gl);
      if (rkey >= 0 && s == 0) {
        if (key0 == rkey) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += run[e];
        } else {
          land(rkey, run);
        }
      }
      const int kprev = __shfl_up_sync(kAll, key, G);
      bool head = s == 0 || kprev != key;
#pragma unroll
      for (int d = 1; d < NS; d <<= 1) {
        const bool oh = __shfl_up_sync(kAll, head, d * G);
        float oa[E];
#pragma unroll
        for (int e = 0; e < E; ++e) oa[e] = __shfl_up_sync(kAll, acc[e], d * G);
        if (s >= d) {
          if (!head) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] += oa[e];
          }
          head = head || oh;
        }
      }
      // a run that ends before the last slot lands; the last slot's run
      // stays open, held by slot 0's lanes
      const int knext = __shfl_down_sync(kAll, key, G);
      if (s < NS - 1 && knext != key && key >= 0) land(key, acc);
      const int last = (NS - 1) * G + gl;
      rkey = __shfl_sync(kAll, key, last);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = __shfl_sync(kAll, acc[e], last);
        run[e] = (s == 0 && rkey >= 0) ? v : 0.f;
      }
    }
    __syncwarp();  // every lane is done with the stage the next issue fills
    cj += n;
    if (cj >= (cg + 1) * bn) ++cg;
    if (++cst == kStages) cst = 0;
  }
  cp_async_wait<0>();
  if (rkey >= 0) {
    slot_sum<E>(run, G);
    if (s == 0) land(rkey, run);
  }
}

// Persistent CTAs (as many as are resident at once, at most one per grid
// step); each warp takes a contiguous range of the slots.
template <bool PHI, typename T, int VEC, int KV, int GT>
cudaError_t launch_kv(const void* grid_rb, const void* vals, const void* lrow,
                      const void* pi, const void* b, void* out, int n_grid,
                      int bn, int br, int R, float eps, cudaStream_t stream) {
  const Shape sh = accum_shape(sizeof(T), bn, R);
  auto kern = phi_accum_kernel<PHI, T, VEC, KV, GT>;
  const int threads = 32 * sh.warps;
  int grid = 0;
  const cudaError_t err = resident_ctas(reinterpret_cast<const void*>(kern),
                                        threads, sh.smem, &grid);
  if (err != cudaSuccess) return err;
  if (grid > n_grid) grid = n_grid;
  if (grid < 1) return cudaGetLastError();  // nothing to do
  kern<<<grid, threads, sh.smem, stream>>>(
      static_cast<const int*>(grid_rb), static_cast<const T*>(vals),
      static_cast<const int*>(lrow), static_cast<const T*>(pi),
      static_cast<const T*>(b), static_cast<float*>(out), n_grid, bn, br, R,
      eps, sh.chunk, (int)sh.pi_region, (int)sh.x_region, (int)sh.l_region,
      (int)sh.stage_bytes);
  return cudaGetLastError();
}

// The instance for R: 16-byte slices when rows and bases allow them, else
// one element per access; KV slices per lane, the least power of two that
// covers the row with at most 32 lanes.
template <bool PHI, typename T, int VEC>
cudaError_t launch_vec(const void* grid_rb, const void* vals, const void* lrow,
                       const void* pi, const void* b, void* out, int n_grid,
                       int bn, int br, int R, float eps, cudaStream_t stream) {
  const int per_lane = (R / VEC + 31) / 32;
  constexpr int kMaxKV = 1024 / VEC / 32;  // MAX_RANK's slices per lane
  if (per_lane == 1 && VEC > 1) {  // one slice per lane: G lanes, G <= 32
    int G = 1;
    while (G < R / VEC) G <<= 1;
#define REPRO_PHI_G(GT)                                                       \
  if (G == GT)                                                                \
    return launch_kv<PHI, T, VEC, 1, GT>(grid_rb, vals, lrow, pi, b, out,     \
                                         n_grid, bn, br, R, eps, stream);
    REPRO_PHI_G(1)
    REPRO_PHI_G(2)
    REPRO_PHI_G(4)
    REPRO_PHI_G(8)
    REPRO_PHI_G(16)
    REPRO_PHI_G(32)
#undef REPRO_PHI_G
  }
  // several slices per lane (a whole warp per nonzero), or one element per
  // lane access (lanes per nonzero computed in the kernel)
  constexpr int kGT = VEC > 1 ? 32 : 0;
#define REPRO_PHI_KV(K)                                                       \
  if constexpr (K <= kMaxKV) {                                                \
    if (per_lane <= K)                                                        \
      return launch_kv<PHI, T, VEC, K, kGT>(grid_rb, vals, lrow, pi, b, out,  \
                                            n_grid, bn, br, R, eps, stream);  \
  }
  REPRO_PHI_KV(1)
  REPRO_PHI_KV(2)
  REPRO_PHI_KV(4)
  REPRO_PHI_KV(8)
  REPRO_PHI_KV(16)
  REPRO_PHI_KV(32)
#undef REPRO_PHI_KV
  return cudaErrorInvalidValue;  // R above MAX_RANK
}

template <bool PHI, typename T>
cudaError_t launch_accum(const void* grid_rb, const void* vals, const void* lrow,
                         const void* pi, const void* b, void* out, int n_grid,
                         int bn, int br, int R, float eps,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = R % kVec == 0 &&
                       reinterpret_cast<unsigned long long>(pi) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(b) % 16 == 0;
  if (aligned)
    return launch_vec<PHI, T, kVec>(grid_rb, vals, lrow, pi, b, out, n_grid,
                                    bn, br, R, eps, stream);
  return launch_vec<PHI, T, 1>(grid_rb, vals, lrow, pi, b, out, n_grid, bn, br,
                               R, eps, stream);
}

template <bool PHI>
int accum(int dtype, const void* grid_rb, const void* vals, const void* lrow,
          const void* pi, const void* b, void* out, int n_grid, int bn, int br,
          int R, float eps, cudaStream_t s) {
  if (R < 1 || R > 1024 || bn < 1 || br < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_accum<PHI, float>(grid_rb, vals, lrow, pi, b, out,
                                         n_grid, bn, br, R, eps, s);
  if (dtype == 1)
    return (int)launch_accum<PHI, __nv_bfloat16>(grid_rb, vals, lrow, pi, b,
                                                 out, n_grid, bn, br, R, eps,
                                                 s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace blocked
}  // namespace repro_torch
