// LU of a batch of small matrices on Hopper.
//
// Replaces the TPU kernel recursivefactorization_jl_tpu/ops/batched_kernel.py
// `_lane_kernel` (reached through `batched_lu_pallas` and
// `batched_lu_pallas_noswap`) with kernels that compute what its two modes
// compute, and agree bitwise with the package's plain versions,
// ops/batched_kernel.py `batched_lu_plain` and `batched_lu_noswap_plain`:
//
//   swap    LAPACK row interchanges.  Per step k: the pivot is the largest
//           |a[i, k]| over rows i >= k, the smallest row among equals (a NaN
//           among the candidates selects row m - 1, as the TPU kernel's
//           max/equality formulation does); ipiv[k] = kp; the composed
//           permutation swaps entries k and kp; rows k and kp are
//           interchanged across all n columns unless the pivot is zero; the
//           column below the diagonal is scaled by r = 1/p; the trailing
//           block gets a[i, j] - l[i] * u[j].  A zero pivot skips the swap
//           and the scale, the update still runs with the unscaled column,
//           and info records the first such step (1-based, negated without
//           pivoting).
//   noswap  Square matrices; rows stay where they are.  Per step k the pivot
//           is the largest |a[i, k]| over the rows not used yet (ties by
//           physical row; a NaN among them selects row n - 1 even when that
//           row is used), perm[k] = kp, that row becomes used, and every
//           other unused row is scaled by r = 1/p (not on a zero pivot) and
//           gets a[i, j] - l[i] * u[j] from row kp.  The rows are written
//           out in pivot order (out[k] = row perm[k]), so the factors come
//           out as L @ U == A[perm, :] without a gather.
//
// Every product and difference is rounded on its own (__fmul_rn, __fsub_rn,
// and -fmad=false at build time), the scale is x * (1/p), and every element
// takes its updates in step order, so each route gives the same bits.
//
// Design.  The TPU kernel puts 128 matrices side by side on the lane axis of
// a transposed (n, m, G) block, pads the batch to a multiple of G and masks
// whole-block vector passes.  None of that is carried over.  The swap mode
// has three routes, chosen by the shape (`own_route`, mirrored by
// ops/batched_kernel.py `lu_route`), the noswap mode the first two
// (`noswap_route`: its matrices are square, n <= 128); the warp and block
// routes are one kernel function each with the mode a compile-time choice
// (the warp kernel's kSwap flag) or a sibling that shares the grid, the
// pivot reduction and the row publication (the block route):
//
//   warp   m <= 32 and n <= 32: one warp (or half a warp when m <= 16) per
//          matrix, several matrices per block.  Lane i holds row i in
//          registers, with the column index fixed at compile time (the
//          kernel is templated on a column capacity of 8, 16 or 32 and the
//          step loop is unrolled).  The pivot search is an integer
//          reduction (redux.sync) over the lanes' magnitude bits, rows k
//          and kp pass through shared memory as 16-byte vectors (every
//          lane reads the U row from there, lanes k and kp their new row),
//          and a step has no barrier, only one __syncwarp.  Loads and
//          stores go through shared memory, so that global accesses stay
//          coalesced.  Noswap: lane i keeps physical row i; the search runs
//          over the lanes not used yet, lane kp alone publishes its row
//          from column k on, and the rows leave through the staging tile
//          gathered by perm.
//   block  32 < max(m, n) <= 128: one block of BT x BT threads per matrix
//          (8 x 8 up to max(m, n) = 64, 16 x 16 beyond); thread (ty, tx)
//          keeps the elements (ty + BT i, tx + BT j) in registers (an S x S
//          tile, S = 6 or 8).  Only row k, row kp and the multipliers pass
//          through shared memory.  The next column's pivot candidates are
//          reduced by its owners at the end of the update, one per thread
//          row; after the barrier every warp reduces those itself.  Two
//          __syncthreads() per step.  Cyclic ownership keeps the shrinking
//          trailing block spread over all threads, and the step loop is
//          unrolled over the tile's slots so that finished slots drop out.
//          Noswap: a used bit per row slot; the finished column slots drop
//          out, but the rows of every slot stay in the update (the used
//          rows are scattered), and the rows leave by the step that picked
//          them.
//   tile   every other shape the swap mode takes (max(m, n) > 128: tall or
//          wide batches, whose tile does not fit the registers): one block
//          per matrix, the matrix in a shared-memory tile with row stride
//          n + 1.  Warp 0 searches the pivot and does the step's
//          bookkeeping; the interchange and the scale share a phase; the
//          update is spread over the block.  Three __syncthreads() per
//          step.
//
// What bounds them.  By the roofline, bytes: each matrix is read and written
// once, and the 2n^3/3 operations per matrix are a fraction of that time at
// the card's rate.  What sets the time is the chain of n dependent steps and
// the instructions each step issues besides its multiply-subtracts: the
// search and exchange in the warp route; in the block route the selects
// over the tile for row kp's runtime slot, the fused candidate search and
// the two barriers (PERF.md), and in its noswap mode the row slots that
// stay in the update (PERF.md); in the tile route three
// barriers and the shared-memory traffic of the rank-1 update.
//
// Built with -DRF_BATCHED_TRACE (the separate library `batched_lu_trace` of
// ops/_kernels.py), thread 0 of block 0 stamps clock64() at the phase
// boundaries of each step (rf_batched_lu_set_trace; the warp and block
// routes in both modes, the swap mode's tile route); the production
// library has no trace code.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "rf_common.cuh"

namespace {

using namespace rf;

constexpr int kMaxThreads = 1024;

#ifdef RF_BATCHED_TRACE
// kTraceStride stamps per step at trace[kTraceStride * k + phase], then at
// trace[kTraceStride * minmn + {0, 1, 2, 3}] the kernel's first %globaltimer
// (ns), clock64(), last %globaltimer, clock64()
constexpr int kTraceStride = 8;
__device__ long long* g_trace = nullptr;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool tracing() {
  return g_trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
}

#define RF_STAMP(k, phase)                                         \
  do {                                                             \
    if (tracing()) g_trace[kTraceStride * (k) + (phase)] = clock64(); \
  } while (0)
#define RF_TRACE_BEGIN(minmn)                                      \
  do {                                                             \
    if (tracing()) {                                               \
      g_trace[kTraceStride * (minmn)] = global_ns();               \
      g_trace[kTraceStride * (minmn) + 1] = clock64();             \
    }                                                              \
  } while (0)
#define RF_TRACE_END(minmn)                                        \
  do {                                                             \
    if (tracing()) {                                               \
      g_trace[kTraceStride * (minmn) + 2] = global_ns();           \
      g_trace[kTraceStride * (minmn) + 3] = clock64();             \
    }                                                              \
  } while (0)
#else
#define RF_STAMP(k, phase) do {} while (0)
#define RF_TRACE_BEGIN(minmn) do {} while (0)
#define RF_TRACE_END(minmn) do {} while (0)
#endif

// Pivot order (rf::better): a NaN among the candidates wins, and the caller
// turns a NaN winner into row m - 1.

// All lanes of the warp end with the warp's best candidate.
template <typename T>
__device__ __forceinline__ void warp_best(T& best, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (better(ov, oi, best, bi)) { best = ov; bi = oi; }
  }
}

// Shared-memory layout of the tile route (see tile_smem_bytes in
// ops/batched_kernel.py): tile m x (n + 1), lcol m, then 2 * m ints.
template <typename T>
struct Tile {
  T* s;
  T* lcol;
  int* ia;  // composed permutation
  int* ib;  // m ints more, which the swap mode leaves unused
  int ld;
  __device__ Tile(unsigned char* raw, int m, int n) {
    ld = n + 1;
    s = reinterpret_cast<T*>(raw);
    lcol = s + static_cast<size_t>(m) * ld;
    ia = reinterpret_cast<int*>(lcol + m);
    ib = ia + m;
  }
};

// ---- tile route ------------------------------------------------------------
// Trace phases: 0 step start, 1 search done, 2 after the first barrier,
// 3 interchange and scale done, 4 after the second barrier, 5 update done,
// 6 after the third barrier.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) batched_lu_swap_kernel(const T* __restrict__ a, T* __restrict__ out,
                                       int* __restrict__ ipiv, int* __restrict__ perm,
                                       int* __restrict__ info, int m, int n,
                                       int pivot, int lw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_kp;
  __shared__ T s_pv;
  Tile<T> t(smem_raw, m, n);
  T* s = t.s;
  const int ld = t.ld;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int minmn = m < n ? m : n;
  const size_t mat = blockIdx.x;
  const size_t base = mat * m * n;
  const int count = m * n;
  RF_TRACE_BEGIN(minmn);

  for (int e = tid; e < count; e += nt) {
    const int i = e / n, j = e - i * n;
    s[i * ld + j] = a[base + e];
  }
  for (int i = tid; i < m; i += nt) t.ia[i] = i;
  int info_v = 0;  // kept by thread 0
  __syncthreads();

  const int rg = tid / lw, cl = tid - rg * lw, nrg = nt / lw;

  for (int k = 0; k < minmn; ++k) {
    RF_STAMP(k, 0);
    // ---- pivot search and bookkeeping: warp 0 ---------------------------
    if (tid < 32) {
      int kp = k;
      if (pivot) {
        T best = T(-1);
        int bi = INT_MAX;
        for (int i = k + lane; i < m; i += 32) {
          const T v = mag(s[i * ld + k]);
          if (better(v, i, best, bi)) { best = v; bi = i; }
        }
        warp_best(best, bi);
        kp = isnan(best) ? m - 1 : bi;
      }
      if (lane == 0) {
        const T pv = s[kp * ld + k];
        s_kp = kp;
        s_pv = pv;
        ipiv[mat * minmn + k] = kp;
        const int pk = t.ia[k];
        t.ia[k] = t.ia[kp];
        t.ia[kp] = pk;
        if (pv == T(0) && info_v == 0) info_v = pivot ? k + 1 : -(k + 1);
      }
    }
    RF_STAMP(k, 1);
    __syncthreads();
    RF_STAMP(k, 2);

    // ---- interchange rows k <-> kp, scale column k ------------------------
    const int kp = s_kp;
    const T pv = s_pv;
    const bool nz = pv != T(0);
    const bool do_swap = nz && kp != k;
    if (do_swap) {
      // every column but k: the scale loop below moves column k itself
      for (int j = tid; j < n; j += nt) {
        if (j == k) continue;
        const T x = s[k * ld + j];
        s[k * ld + j] = s[kp * ld + j];
        s[kp * ld + j] = x;
      }
    }
    const T r = nz ? rrcp(pv) : T(1);
    for (int i = k + 1 + tid; i < m; i += nt) {
      T l;
      if (do_swap && i == kp) {
        // this thread alone reads the old diagonal entry and replaces it
        l = s[k * ld + k];
        s[k * ld + k] = pv;
      } else {
        l = s[i * ld + k];
      }
      if (nz) l = rmul(l, r);
      s[i * ld + k] = l;
      t.lcol[i] = l;
    }
    RF_STAMP(k, 3);
    __syncthreads();
    RF_STAMP(k, 4);

    // ---- rank-1 update of the trailing block ------------------------------
    const T* u = s + k * ld;
    for (int i = k + 1 + rg; i < m; i += nrg) {
      const T l = t.lcol[i];
      T* row = s + i * ld;
      for (int j = k + 1 + cl; j < n; j += lw) {
        row[j] = rsub(row[j], rmul(l, u[j]));
      }
    }
    RF_STAMP(k, 5);
    __syncthreads();
    RF_STAMP(k, 6);
  }

  for (int e = tid; e < count; e += nt) {
    const int i = e / n, j = e - i * n;
    out[base + e] = s[i * ld + j];
  }
  if (perm != nullptr) {
    for (int i = tid; i < m; i += nt) perm[mat * m + i] = t.ia[i];
  }
  if (tid == 0) info[mat] = info_v;
  RF_TRACE_END(minmn);
}

// 1/p rounded once, as rrcp, by the reciprocal instruction: the same value
// (both are the correctly rounded quotient) without the division's slow-path
// call
__device__ __forceinline__ float rcp_rn(float p) { return __frcp_rn(p); }
__device__ __forceinline__ double rcp_rn(double p) { return __drcp_rn(p); }

// The pivot search as integer reductions (redux.sync): |x| of a float orders
// as its bits, and a NaN's bits lie above inf's, so the largest key is the
// largest magnitude, or a NaN when there is one (the NaN rule needs no more:
// any NaN selects row m - 1).  Candidates that are out carry key 0 and are
// left out of the row choice.
__device__ __forceinline__ unsigned mag_key(float x) { return __float_as_uint(fabsf(x)); }
__device__ __forceinline__ bool key_is_nan(unsigned k) { return k > 0x7f800000u; }

// Does this lane hold the largest key among the lanes of `mask` where `in`
// holds?  `hi_out` gets that key (f32: one word)
__device__ __forceinline__ bool max_key(unsigned mask, bool in, float x, unsigned& hi_out) {
  const unsigned k = in ? mag_key(x) : 0u;
  const unsigned mx = __reduce_max_sync(mask, k);
  hi_out = mx;
  return k == mx && in;
}

// f64: the high word first, then the low word among the lanes that share it;
// `hi_out` is the high word, or all ones for a NaN
__device__ __forceinline__ bool max_key(unsigned mask, bool in, double x, unsigned& hi_out) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(fabs(x)));
  const unsigned hi = in ? static_cast<unsigned>(b >> 32) : 0u;
  const unsigned mh = __reduce_max_sync(mask, hi);
  const bool top = in && hi == mh;
  const unsigned lo = top ? static_cast<unsigned>(b) : 0u;
  const unsigned ml = __reduce_max_sync(mask, lo);
  hi_out = mh > 0x7ff00000u || (mh == 0x7ff00000u && ml != 0u) ? 0xffffffffu : mh;
  return top && lo == ml;
}
__device__ __forceinline__ bool max_is_nan(unsigned hi_out, float) { return key_is_nan(hi_out); }

// the same order as one integer per value, for a thread's own candidates
__device__ __forceinline__ unsigned long long order_key(float x) { return mag_key(x); }
__device__ __forceinline__ unsigned long long order_key(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(x)));
}
__device__ __forceinline__ bool max_is_nan(unsigned hi_out, double) { return hi_out == 0xffffffffu; }

// 16-byte vectors for the shared-memory exchange
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float get(const float4& v, int e) {
    return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
  }
  __device__ static float4 make(const float* r) { return make_float4(r[0], r[1], r[2], r[3]); }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double get(const double2& v, int e) { return e == 0 ? v.x : v.y; }
  __device__ static double2 make(const double* r) { return make_double2(r[0], r[1]); }
};

// ---- warp route --------------------------------------------------------------
// W lanes per matrix (16 or 32), NC columns held per lane (8, 16 or 32).
// kSwap: the swap mode; without it the noswap mode (square matrices, rows in
// physical order, the pivot row of step k written to perm[k] and the rows
// written out in that order).
// Trace phases: 0 step start, 1 pivot known, 2 rows exchanged (noswap: row
// kp published), 3 update done.
constexpr int kWarpThreads = 128;

// Resident blocks per SM asked of the register allocator: at 32 f32
// columns its own choice (64 registers) spills, 6 blocks allow 85; f64
// rows take what they need.
template <typename T, int NC>
constexpr int warp_min_blocks() { return sizeof(T) == 4 && NC == 32 ? 6 : 1; }

template <typename T, int W, int NC, bool kSwap>
__global__ void __launch_bounds__(kWarpThreads, warp_min_blocks<T, NC>()) batched_lu_warp_kernel(
    const T* __restrict__ a, T* __restrict__ out, int* __restrict__ ipiv,
    int* __restrict__ perm, int* __restrict__ info, int batch, int m, int n, int pivot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V = Vec16<T>;
  using VT = typename V::type;
  constexpr int G = kWarpThreads / W;  // matrices per block
  constexpr int VL = V::n;
  // per group, the exchange buffers: two of (row k, row kp) in the swap
  // mode, two of row kp in the noswap mode (double-buffered: one __syncwarp
  // per step)
  constexpr int XB = (kSwap ? 4 : 2) * NC;
  const int lane = threadIdx.x % W;    // the row this lane holds
  const int grp = threadIdx.x / W;
  const int half = (threadIdx.x & 31) / W;  // this group's half of the warp (W = 16)
  const unsigned gmask = W == 32 ? kFull : (0xffffu << (16 * half));
  const size_t mat = static_cast<size_t>(blockIdx.x) * G + grp;
  const bool live = mat < static_cast<size_t>(batch);
  const int ld = n | 1;  // odd: a lane-per-row walk hits distinct banks
  // per group: the exchange buffers, then the staging tile m x ld
  T* xb = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(grp) * XB;
  T* st = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(G) * XB +
          static_cast<size_t>(grp) * m * ld;
  const int minmn = m < n ? m : n;
  const int count = m * n;
  const size_t base = mat * count;
  RF_TRACE_BEGIN(minmn);

  // coalesced load through shared memory; a group past the batch runs on
  // zeros and stores nothing (no lane leaves early: the warp's collective
  // operations name all 32)
  if (live) {
    for (int e = lane; e < count; e += W) {
      const int i = e / n, j = e - i * n;
      st[i * ld + j] = a[base + e];
    }
  }
  __syncwarp();
  T r[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) r[j] = (live && lane < m && j < n) ? st[lane * ld + j] : T(0);

  // swap: my_piv = ipiv[lane], p = entry `lane` of the composed permutation;
  // noswap: my_piv = the pivot row of step `lane`, used = this row is taken
  int info_v = 0, my_piv = 0;
  int p = lane;
  bool used = false;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= minmn) continue;  // no exit from the unrolled loop
    RF_STAMP(k, 0);
    // the candidates: rows k.. (swap), or the rows not used yet (noswap)
    const bool cand = kSwap ? (lane >= k && lane < m) : (!used && lane < m);
    int kp = k;
    if (pivot) {
      unsigned top;
      const bool won = max_key(gmask, cand, r[k], top);
      const unsigned who = (__ballot_sync(kFull, won) >> (W * half)) &
                           (W == 32 ? kFull : 0xffffu);
      kp = max_is_nan(top, T(0)) ? m - 1 : __ffs(who) - 1;
    }
    const T pv = __shfl_sync(kFull, r[k], kp, W);
    const bool nz = pv != T(0);
    if (!nz && info_v == 0) info_v = pivot ? k + 1 : -(k + 1);
    if (lane == k) my_piv = kp;
    const T rc = nz ? rcp_rn(pv) : T(1);
    T l = T(0);
    if constexpr (kSwap) {
      // the permutation swaps entries k and kp, zero pivot or not
      const int psrc = lane == k ? kp : (lane == kp ? k : lane);
      p = __shfl_sync(kFull, p, psrc, W);
      RF_STAMP(k, 1);

      // Rows k and kp go through shared memory: lane kp (when rows swap)
      // reads row k and keeps its own old row as U; every other lane reads
      // row kq, which is U (and row k's new content).
      const bool sw = nz && kp != k;
      const bool is_kp = sw && lane == kp;
      const bool moves = lane == k || is_kp;
      T* buf = xb + (k & 1) * 2 * NC;
      if (lane == k) {
#pragma unroll
        for (int c = 0; c < NC; c += VL) *reinterpret_cast<VT*>(buf + c) = V::make(r + c);
      }
      if (is_kp) {
#pragma unroll
        for (int c = 0; c < NC; c += VL) *reinterpret_cast<VT*>(buf + NC + c) = V::make(r + c);
      }
      __syncwarp();
      RF_STAMP(k, 2);
      const T* src = (sw && !is_kp) ? buf + NC : buf;
      const bool below = lane > k && lane < m;
      // selects, not branches: the lanes differ in every condition
#pragma unroll
      for (int c = 0; c < NC; c += VL) {
        if (c + VL <= k) {
          // columns before k: the interchange only (lanes k and kp)
          if (moves) {
            const VT v = *reinterpret_cast<const VT*>(src + c);
#pragma unroll
            for (int e = 0; e < VL; ++e) r[c + e] = V::get(v, e);
          }
          continue;
        }
        const VT v = *reinterpret_cast<const VT*>(src + c);
#pragma unroll
        for (int e = 0; e < VL; ++e) {
          const int j = c + e;
          const T x = V::get(v, e);
          if (j < k) {
            r[j] = moves ? x : r[j];
          } else if (j == k) {
            // column k: the interchange and the scale
            const T y = moves ? x : r[k];
            r[k] = (below && nz) ? rmul(y, rc) : y;
            l = r[k];
          } else {
            const T u = is_kp ? r[j] : x;
            const T y = moves ? x : r[j];
            const T z = rsub(y, rmul(l, u));
            r[j] = below ? z : y;
          }
        }
      }
    } else {
      // every other row not used yet is eliminated (a NaN pins row m - 1
      // even when it is used: then no row becomes used at this step)
      const bool elim = cand && lane != kp;
      used = used || lane == kp;
      RF_STAMP(k, 1);
      // row kp goes through shared memory, from the vector holding column k
      T* buf = xb + (k & 1) * NC;
      if (lane == kp) {
#pragma unroll
        for (int c = 0; c < NC; c += VL) {
          if (c + VL > k) *reinterpret_cast<VT*>(buf + c) = V::make(r + c);
        }
      }
      __syncwarp();
      RF_STAMP(k, 2);
#pragma unroll
      for (int c = 0; c < NC; c += VL) {
        if (c + VL <= k) continue;  // columns before k stay
        const VT v = *reinterpret_cast<const VT*>(buf + c);
#pragma unroll
        for (int e = 0; e < VL; ++e) {
          const int j = c + e;
          if (j == k) {
            r[k] = (elim && nz) ? rmul(r[k], rc) : r[k];
            l = r[k];
          } else if (j > k) {
            const T z = rsub(r[j], rmul(l, V::get(v, e)));
            r[j] = elim ? z : r[j];
          }
        }
      }
    }
    RF_STAMP(k, 3);
  }

  if (live && lane < m) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < n) st[lane * ld + j] = r[j];
    }
  }
  __syncwarp();
  if constexpr (kSwap) {
    if (live) {
      for (int e = lane; e < count; e += W) {
        const int i = e / n, j = e - i * n;
        out[base + e] = st[i * ld + j];
      }
      if (lane < minmn) ipiv[mat * minmn + lane] = my_piv;
      if (perm != nullptr && lane < m) perm[mat * m + lane] = p;
      if (lane == 0) info[mat] = info_v;
    }
  } else {
    // rows leave in pivot order, out[i] = row prow[i], gathered from the
    // staging tile (a row picked twice by the NaN rule is written twice);
    // the exchange buffers, free now, hold prow
    int* prow = reinterpret_cast<int*>(xb);
    if (lane < n) prow[lane] = my_piv;
    __syncwarp();
    if (live) {
      for (int e = lane; e < count; e += W) {
        const int i = e / n, j = e - i * n;
        out[base + e] = st[prow[i] * ld + j];
      }
      if (lane < n) perm[mat * n + lane] = my_piv;
      if (lane == 0) info[mat] = info_v;
    }
  }
  RF_TRACE_END(minmn);
}

// ---- block route -------------------------------------------------------------
// BT x BT threads (BT = 8 or 16); thread (ty, tx) holds rows ty + BT i and
// columns tx + BT j, i, j < S.  Trace phases: 0 before the first barrier,
// 1 after it, 2 pivot known, 3 row k, row kp and the multipliers published,
// 4 after the second barrier, 5 interchange, update and next candidates done.

// Shared-memory layout (see block_smem_bytes): krow, urow, lcol (BT S
// each), the candidates' values (BT), a[m - 1, k] and a[k, k] (2), then the
// candidates' rows (BT) and the composed permutation (BT S, kept by thread
// 0) as ints.
template <typename T, int BT, int S>
struct BlockSmem {
  T* krow;  // row k before the interchange
  T* urow;  // row kp before it
  T* lcol;  // the multipliers of the step
  T* cval;  // per thread row: its best candidate, signed
  T* clast; // a[m - 1, k]: the pivot when a NaN wins
  T* diag;  // a[k, k]: row kp's multiplier when the rows swap
  int* cidx;
  int* perm;
  __device__ BlockSmem(unsigned char* raw) {
    krow = reinterpret_cast<T*>(raw);
    urow = krow + BT * S;
    lcol = urow + BT * S;
    cval = lcol + BT * S;
    clast = cval + BT;
    diag = clast + 1;
    cidx = reinterpret_cast<int*>(diag + 1);
    perm = cidx + BT;
  }
};

// The whole kernel is one function body: the tile x[S][S] is indexed only
// with constants after unrolling (the step loop is unrolled over the slot
// ks of row and column k, the steps inside a slot run as a loop), so it
// stays in registers, and the slots before ks (finished) drop out.
// Resident blocks per SM asked of the register allocator: f32 tiles fit
// 128 registers (8 blocks of 64 threads, 2 of 256); f64 ones take what
// they need.
template <typename T, int BT>
constexpr int block_min_blocks() { return sizeof(T) == 4 ? (BT == 8 ? 8 : 2) : 1; }

template <typename T, int BT, int S>
__global__ void __launch_bounds__(BT * BT, block_min_blocks<T, BT>()) batched_lu_block_kernel(
    const T* __restrict__ a, T* __restrict__ out, int* __restrict__ ipiv,
    int* __restrict__ perm, int* __restrict__ info, int batch, int m, int n, int pivot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = BT * BT;
  // the pivot reduction names all 32 lanes of every warp
  static_assert(NT % 32 == 0, "the block route needs whole warps");
  BlockSmem<T, BT, S> sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid / BT, tx = tid % BT;
  const int minmn = m < n ? m : n;
  const size_t mat = blockIdx.x;
  const size_t base = mat * m * n;
  const int lrow = (m - 1) % BT, lslot = (m - 1) / BT;  // where row m - 1 lives
  RF_TRACE_BEGIN(minmn);

  T x[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int row = ty + BT * i;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int col = tx + BT * j;
      x[i][j] = (row < m && col < n) ? a[base + static_cast<size_t>(row) * n + col] : T(0);
    }
  }
  for (int i = tid; i < m; i += NT) sm.perm[i] = i;
  // the candidates of column 0 (slot 0 of the threads with tx == 0): per
  // thread row the best of rows >= 0 below m (row 0 alone without pivoting)
  if (tid == 0) sm.diag[0] = x[0][0];
  if (tx == 0) {
    // rows ascend with the slot, so a strictly larger key keeps the
    // smallest row among equals (and any NaN beats every number)
    T cb = T(0);
    int ci = INT_MAX;
    unsigned long long kb = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int row = ty + BT * i;
      const bool ok = pivot ? row < m : row == 0;
      const unsigned long long key = order_key(x[i][0]);
      if (ok && (ci == INT_MAX || key > kb)) { cb = x[i][0]; ci = row; kb = key; }
    }
    sm.cval[ty] = cb;
    sm.cidx[ty] = ci;
    if (ty == lrow) {
      T v = x[0][0];
#pragma unroll
      for (int i = 1; i < S; ++i) {
        if (i == lslot) v = x[i][0];
      }
      sm.clast[0] = v;
    }
  }
  int info_v = 0;  // kept by thread 0

#pragma unroll
  for (int ks = 0; ks < S; ++ks) {
    for (int kk = 0; kk < BT; ++kk) {
      const int k = ks * BT + kk;
      if (k >= minmn) break;
      RF_STAMP(k, 0);
      __syncthreads();  // the candidates of column k are published
      RF_STAMP(k, 1);

      // ---- the pivot: every warp reduces the BT candidates itself ---------
      // (largest key, then the smallest row holding it)
      const T cv = sm.cval[lane % BT];
      const int cr = sm.cidx[lane % BT];
      unsigned top;
      const bool won = max_key(kFull, cr != INT_MAX, cv, top);
      const int bi = static_cast<int>(__reduce_min_sync(kFull, won ? static_cast<unsigned>(cr)
                                                                   : 0xffffffffu));
      const bool nanwin = pivot && max_is_nan(top, T(0));
      const int kp = nanwin ? m - 1 : bi;
      const int kpr = kp % BT, kps = kp / BT;  // kp's thread row and slot (>= ks)
      // the winner is its thread row's candidate; a NaN winner gives row m - 1
      const T pv = nanwin ? sm.clast[0] : sm.cval[kpr];
      const bool nz = pv != T(0);
      const bool sw = nz && kp != k;
      const T rc = nz ? rcp_rn(pv) : T(1);
      if (tid == 0) {
        ipiv[mat * minmn + k] = kp;
        if (!nz && info_v == 0) info_v = pivot ? k + 1 : -(k + 1);
        // the permutation swaps entries k and kp, zero pivot or not
        const int pk = sm.perm[k];
        sm.perm[k] = sm.perm[kp];
        sm.perm[kp] = pk;
      }
      RF_STAMP(k, 2);

      // ---- publish row k, row kp and the multipliers ----------------------
      if (ty == kk) {
#pragma unroll
        for (int j = 0; j < S; ++j) sm.krow[tx + BT * j] = x[ks][j];
      }
      if (sw && ty == kpr) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          T v = x[ks][j];
#pragma unroll
          for (int i = ks + 1; i < S; ++i) {
            if (i == kps) v = x[i][j];
          }
          sm.urow[tx + BT * j] = v;
        }
      }
      if (tx == kk) {
        // column k below the diagonal; row kp, when it takes row k, gets
        // the scaled a[k, k] (set into x in the interchange below)
#pragma unroll
        for (int i = ks; i < S; ++i) {
          const int row = ty + BT * i;
          if (i > ks || ty > kk) {
            const bool takes_k = sw && row == kp;
            const T y = takes_k ? sm.diag[0] : x[i][ks];
            const T l = nz ? rmul(y, rc) : y;
            sm.lcol[row] = l;
            if (!takes_k) x[i][ks] = l;
          }
        }
      }
      RF_STAMP(k, 3);
      __syncthreads();
      RF_STAMP(k, 4);

      // ---- interchange, update, next candidates ---------------------------
      const T* ub = sw ? sm.urow : sm.krow;
      if (sw) {
        if (ty == kk) {
#pragma unroll
          for (int j = 0; j < S; ++j) x[ks][j] = sm.urow[tx + BT * j];
        }
        if (ty == kpr) {
#pragma unroll
          for (int i = ks; i < S; ++i) {
            if (i == kps) {
#pragma unroll
              for (int j = 0; j < S; ++j) x[i][j] = sm.krow[tx + BT * j];
              if (tx == kk) x[i][ks] = sm.lcol[kp];
            }
          }
        }
      }
      T u[S];
#pragma unroll
      for (int j = ks; j < S; ++j) u[j] = ub[tx + BT * j];
      // slots past ks lie wholly beyond k; in slot ks only ty / tx > kk
      // (a select: the entries at or above the diagonal stay as they are)
      const bool row_in = ty > kk, col_in = tx > kk;
#pragma unroll
      for (int i = ks; i < S; ++i) {
        const T l = sm.lcol[ty + BT * i];
#pragma unroll
        for (int j = ks; j < S; ++j) {
          const T z = rsub(x[i][j], rmul(l, u[j]));
          if (i > ks && j > ks) {
            x[i][j] = z;
          } else {
            const bool in = (i > ks || row_in) && (j > ks || col_in);
            x[i][j] = in ? z : x[i][j];
          }
        }
      }
      // the owners of column k + 1 (slot cs) publish its candidates
      const int k1 = k + 1;
      if (k1 < minmn && tx == k1 % BT) {
        const bool next_slot = kk + 1 == BT;
        T cb = T(0);
        int ci = INT_MAX;
        unsigned long long kb = 0;
        T last = T(0), dg = T(0);
#pragma unroll
        for (int i = ks; i < S; ++i) {
          const int row = ty + BT * i;
          T v = x[i][ks];
          if (ks + 1 < S && next_slot) v = x[i][ks + 1 < S ? ks + 1 : ks];
          const bool ok = pivot ? (row >= k1 && row < m) : row == k1;
          const unsigned long long key = order_key(v);
          if (ok && (ci == INT_MAX || key > kb)) { cb = v; ci = row; kb = key; }
          if (i == lslot) last = v;
          if (row == k1) dg = v;
        }
        sm.cval[ty] = cb;
        sm.cidx[ty] = ci;
        if (ty == lrow) sm.clast[0] = last;
        if (ty == k1 % BT) sm.diag[0] = dg;
      }
      RF_STAMP(k, 5);
    }
  }

#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int row = ty + BT * i;
    if (row < m) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int col = tx + BT * j;
        if (col < n) out[base + static_cast<size_t>(row) * n + col] = x[i][j];
      }
    }
  }
  if (perm != nullptr) {
    __syncthreads();  // thread 0's last swap
    for (int i = tid; i < m; i += NT) perm[mat * m + i] = sm.perm[i];
  }
  if (tid == 0) info[mat] = info_v;
  RF_TRACE_END(minmn);
}

// ---- block route, noswap mode ----------------------------------------------------
// The swap route's grid and register tile on a square matrix whose rows stay
// in physical order.  A row leaves the update when it becomes the pivot row,
// wherever it lies, so every row slot stays in the update (only the column
// slots before ks drop out), each under a used flag: bit i of `used` for row
// ty + BT i (rows past n start used).  Row kp's columns are published from
// its runtime slot as on the swap route; nothing is interchanged.  The rows
// leave in pivot order: row r goes to out[inv[r]], row n - 1 (which the NaN
// rule may pick at several steps) to every step that picked it.  Trace
// phases as on the swap route.

// Shared-memory layout (see block_smem_bytes): urow, lcol (BT S
// each), the candidates' values (BT), a[n - 1, k] (1), then as ints the
// candidates' rows (BT), the pivot row of each step (BT S, kept by thread 0)
// and, at the end, the step of each row (BT S).
template <typename T, int BT, int S>
struct NoswapSmem {
  T* urow;   // row kp from column slot ks on
  T* lcol;   // the multipliers of the step (rows being eliminated)
  T* cval;   // per thread row: its best candidate, signed
  T* clast;  // a[n - 1, k]: the pivot when a NaN wins
  int* cidx;
  int* prow;
  int* inv;
  __device__ NoswapSmem(unsigned char* raw) {
    urow = reinterpret_cast<T*>(raw);
    lcol = urow + BT * S;
    cval = lcol + BT * S;
    clast = cval + BT;
    cidx = reinterpret_cast<int*>(clast + 1);
    prow = cidx + BT;
    inv = prow + BT * S;
  }
};

// The candidates of column c, held in col[i] for the rows ty + BT i of a
// thread with tx == c % BT: per thread row the best of its rows not used yet
// (row c alone without pivoting).  Rows ascend with the slot, so a strictly
// larger key keeps the smallest row among equals (and any NaN beats every
// number).  Also publishes a[n - 1, c] from the thread row holding it.
template <typename T, int BT, int S>
__device__ __forceinline__ void noswap_candidates(const NoswapSmem<T, BT, S>& sm, const T (&col)[S],
                                                  unsigned used, int pivot, int c, int ty,
                                                  int lrow, int lslot) {
  T cb = T(0), last = T(0);
  int ci = INT_MAX;
  unsigned long long kb = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int row = ty + BT * i;
    const bool ok = pivot ? !((used >> i) & 1u) : row == c;
    const unsigned long long key = order_key(col[i]);
    if (ok && (ci == INT_MAX || key > kb)) { cb = col[i]; ci = row; kb = key; }
    if (i == lslot) last = col[i];
  }
  sm.cval[ty] = cb;
  sm.cidx[ty] = ci;
  if (ty == lrow) sm.clast[0] = last;
}

template <typename T, int BT, int S>
__global__ void __launch_bounds__(BT * BT, block_min_blocks<T, BT>()) batched_lu_block_noswap_kernel(
    const T* __restrict__ a, T* __restrict__ out, int* __restrict__ /*ipiv*/,
    int* __restrict__ perm, int* __restrict__ info, int /*batch*/, int /*m*/, int n, int pivot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = BT * BT;
  static_assert(NT % 32 == 0, "the block route needs whole warps");
  static_assert(S <= 32, "one used bit per row slot");
  NoswapSmem<T, BT, S> sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid / BT, tx = tid % BT;
  const size_t mat = blockIdx.x;
  const size_t base = mat * n * n;
  const int lrow = (n - 1) % BT, lslot = (n - 1) / BT;  // where row n - 1 lives
  RF_TRACE_BEGIN(n);

  T x[S][S];
  unsigned used = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int row = ty + BT * i;
    if (row >= n) used |= 1u << i;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int col = tx + BT * j;
      x[i][j] = (row < n && col < n) ? a[base + static_cast<size_t>(row) * n + col] : T(0);
    }
  }
  if (tx == 0) {
    T col[S];
#pragma unroll
    for (int i = 0; i < S; ++i) col[i] = x[i][0];
    noswap_candidates<T, BT, S>(sm, col, used, pivot, 0, ty, lrow, lslot);
  }
  int info_v = 0;  // kept by thread 0

#pragma unroll
  for (int ks = 0; ks < S; ++ks) {
    for (int kk = 0; kk < BT; ++kk) {
      const int k = ks * BT + kk;
      if (k >= n) break;
      RF_STAMP(k, 0);
      __syncthreads();  // the candidates of column k are published
      RF_STAMP(k, 1);

      // ---- the pivot: every warp reduces the BT candidates itself ---------
      const T cv = sm.cval[lane % BT];
      const int cr = sm.cidx[lane % BT];
      unsigned top;
      const bool won = max_key(kFull, cr != INT_MAX, cv, top);
      const int bi = static_cast<int>(__reduce_min_sync(kFull, won ? static_cast<unsigned>(cr)
                                                                   : 0xffffffffu));
      const bool nanwin = pivot && max_is_nan(top, T(0));
      const int kp = nanwin ? n - 1 : bi;
      const int kpr = kp % BT, kps = kp / BT;  // kp's thread row and slot (any)
      const T pv = nanwin ? sm.clast[0] : sm.cval[kpr];
      const bool nz = pv != T(0);
      const T rc = nz ? rcp_rn(pv) : T(1);
      if (tid == 0) {
        sm.prow[k] = kp;
        if (!nz && info_v == 0) info_v = pivot ? k + 1 : -(k + 1);
      }
      // from here on "not used" means: eliminated at this step (a NaN pins
      // row n - 1 even when it is used: then no row becomes used)
      if (ty == kpr) used |= 1u << kps;
      RF_STAMP(k, 2);

      // ---- publish row kp and the multipliers ------------------------------
      if (ty == kpr) {
#pragma unroll
        for (int j = ks; j < S; ++j) {
          T v = x[0][j];
#pragma unroll
          for (int i = 1; i < S; ++i) {
            if (i == kps) v = x[i][j];
          }
          sm.urow[tx + BT * j] = v;
        }
      }
      if (tx == kk) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          if (!((used >> i) & 1u)) {
            const T l = nz ? rmul(x[i][ks], rc) : x[i][ks];
            x[i][ks] = l;
            sm.lcol[ty + BT * i] = l;
          }
        }
      }
      RF_STAMP(k, 3);
      __syncthreads();
      RF_STAMP(k, 4);

      // ---- update, next candidates -----------------------------------------
      T u[S];
#pragma unroll
      for (int j = ks; j < S; ++j) u[j] = sm.urow[tx + BT * j];
      const bool col_in = tx > kk;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const bool el = !((used >> i) & 1u);
        const T l = sm.lcol[ty + BT * i];
#pragma unroll
        for (int j = ks; j < S; ++j) {
          const T z = rsub(x[i][j], rmul(l, u[j]));
          const bool in = el && (j > ks || col_in);
          x[i][j] = in ? z : x[i][j];
        }
      }
      const int k1 = k + 1;
      if (k1 < n && tx == k1 % BT) {
        const bool next_slot = kk + 1 == BT;
        T col[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          col[i] = x[i][ks];
          if (ks + 1 < S && next_slot) col[i] = x[i][ks + 1 < S ? ks + 1 : ks];
        }
        noswap_candidates<T, BT, S>(sm, col, used, pivot, k1, ty, lrow, lslot);
      }
      RF_STAMP(k, 5);
    }
  }

  // ---- rows out in pivot order -----------------------------------------------
  __syncthreads();  // thread 0's last pivot row
  for (int r = tid; r < n; r += NT) sm.inv[r] = -1;
  __syncthreads();
  for (int q = tid; q < n; q += NT) {
    const int r = sm.prow[q];
    if (r != n - 1) sm.inv[r] = q;
    perm[mat * n + q] = r;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int row = ty + BT * i;
    if (row >= n) continue;
    // the steps that picked this row: inv[row], or (row n - 1) each q with
    // prow[q] == n - 1
    const bool last = row == n - 1;
    for (int q = last ? 0 : sm.inv[row]; q >= 0 && q < n; q = last ? q + 1 : n) {
      if (last && sm.prow[q] != row) continue;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int col = tx + BT * j;
        if (col < n) out[base + static_cast<size_t>(q) * n + col] = x[i][j];
      }
    }
  }
  if (tid == 0) info[mat] = info_v;
  RF_TRACE_END(n);
}

// Threads of a block and lanes per row of the update, from the shape: about
// 16 tile entries per thread, between 2 and 32 warps; a row of the update
// gets as many lanes as it has columns, up to a warp.
inline void block_shape(int m, int n, int* threads, int* lw) {
  int l = 1;
  while (l < n && l < 32) l <<= 1;
  long want = (static_cast<long>(m) * n + 15) / 16;
  int th = 64;
  while (th < want && th < kMaxThreads) th <<= 1;
  *threads = th;
  *lw = l;
}

size_t smem_bytes(int m, int n, size_t elem) {
  return (static_cast<size_t>(m) * (n + 1) + m) * elem + 8 * static_cast<size_t>(m);
}

// ---- routes --------------------------------------------------------------------
// The swap mode takes three routes by shape; the noswap mode's matrices are
// square (m == n) and take the warp and block routes alone.
enum Route { kAuto = 0, kWarp = 1, kBlock = 2, kTile = 3 };

int own_route(int m, int n) {
  if (m <= 32 && n <= 32) return kWarp;
  if (m <= 128 && n <= 128) return kBlock;
  return kTile;
}

bool route_takes(int route, int m, int n) {
  if (route == kWarp) return m <= 32 && n <= 32;
  if (route == kBlock) return m <= 128 && n <= 128;
  return route == kTile;
}

int warp_lanes(int m) { return m <= 16 ? 16 : 32; }
int warp_cols(int n) { return n <= 8 ? 8 : (n <= 16 ? 16 : 32); }
// block route: thread grid side BT and slots S per thread and dimension
void block_grid(int m, int n, int* bt, int* s) {
  const int big = m > n ? m : n;
  *bt = big <= 64 ? 8 : 16;
  *s = big <= 48 ? 6 : (big <= 64 ? 8 : (big <= 96 ? 6 : 8));
}

size_t warp_smem_bytes(bool swap, int m, int n, size_t elem) {
  const size_t g = kWarpThreads / warp_lanes(m);
  const size_t xb = (swap ? 4 : 2) * static_cast<size_t>(warp_cols(n));
  return g * (xb + static_cast<size_t>(m) * (n | 1)) * elem;
}

size_t block_smem_bytes(bool swap, int m, int n, size_t elem) {
  int bt = 0, s = 0;
  block_grid(m, n, &bt, &s);
  const size_t cap = static_cast<size_t>(bt) * s;
  if (swap) return (3 * cap + bt + 2) * elem + 4 * (bt + cap);
  return (2 * cap + bt + 1) * elem + 4 * (bt + 2 * cap);
}

template <typename T>
using LuKernel = void (*)(const T*, T*, int*, int*, int*, int, int, int, int);

template <typename T, int W>
LuKernel<T> swap_warp_kernel(int nc) {
  if (nc == 8) return batched_lu_warp_kernel<T, W, 8, true>;
  if (nc == 16) return batched_lu_warp_kernel<T, W, 16, true>;
  return batched_lu_warp_kernel<T, W, 32, true>;
}

template <typename T, bool kSwap>
LuKernel<T> warp_kernel(int w, int nc) {
  if constexpr (!kSwap) {
    // square: 16 lanes hold at most 16 columns, 32 lanes more than 16
    if (w == 16) return nc == 8 ? batched_lu_warp_kernel<T, 16, 8, false>
                                : batched_lu_warp_kernel<T, 16, 16, false>;
    return batched_lu_warp_kernel<T, 32, 32, false>;
  }
  return w == 16 ? swap_warp_kernel<T, 16>(nc) : swap_warp_kernel<T, 32>(nc);
}

template <typename T, int BT, int S>
LuKernel<T> block_kernel_mode(bool swap) {
  return swap ? batched_lu_block_kernel<T, BT, S> : batched_lu_block_noswap_kernel<T, BT, S>;
}

template <typename T>
LuKernel<T> block_kernel(bool swap, int bt, int s) {
  if (bt == 8) return s == 6 ? block_kernel_mode<T, 8, 6>(swap) : block_kernel_mode<T, 8, 8>(swap);
  return s == 6 ? block_kernel_mode<T, 16, 6>(swap) : block_kernel_mode<T, 16, 8>(swap);
}

// What a launch of `route` (kAuto: the shape's own) does with (m, n) in
// either mode: the kernel, threads per block, matrices per block and dynamic
// shared memory; no kernel (fn null) for the noswap mode's tile route.
template <typename T>
struct LuPlan {
  int route = 0, threads = 0, per_block = 1, lw = 0, cap = 0;
  size_t smem = 0;
  const void* fn = nullptr;
  LuKernel<T> rk = nullptr;  // warp and block routes
};

template <typename T>
LuPlan<T> lu_plan(bool swap, int m, int n, int route) {
  LuPlan<T> p;
  p.route = route == kAuto ? own_route(m, n) : route;
  if (p.route == kWarp) {
    const int w = warp_lanes(m);
    p.cap = warp_cols(n);
    p.rk = swap ? warp_kernel<T, true>(w, p.cap) : warp_kernel<T, false>(w, p.cap);
    p.threads = kWarpThreads;
    p.per_block = kWarpThreads / w;
    p.smem = warp_smem_bytes(swap, m, n, sizeof(T));
    p.fn = reinterpret_cast<const void*>(p.rk);
  } else if (p.route == kBlock) {
    int bt = 0, s = 0;
    block_grid(m, n, &bt, &s);
    p.cap = bt * s;
    p.rk = block_kernel<T>(swap, bt, s);
    p.threads = bt * bt;
    p.smem = block_smem_bytes(swap, m, n, sizeof(T));
    p.fn = reinterpret_cast<const void*>(p.rk);
  } else {
    if (!swap) return p;  // no tile route: p.fn stays null
    block_shape(m, n, &p.threads, &p.lw);
    p.smem = smem_bytes(m, n, sizeof(T));
    p.fn = reinterpret_cast<const void*>(batched_lu_swap_kernel<T>);
  }
  return p;
}

// One launch in either mode.  The noswap mode writes the pivot rows to
// `perm` and takes no ipiv.
template <typename T>
int launch_lu(bool swap, const void* a, void* out, void* ipiv, void* perm, void* info,
              int batch, int m, int n, int pivot, int route, int smem_given,
              int device, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || (!swap && m != n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route != kAuto && !route_takes(route, m, n)) return static_cast<int>(cudaErrorInvalidValue);
  const LuPlan<T> p = lu_plan<T>(swap, m, n, route);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = prepare(p.fn, device, p.smem, smem_given);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* A = static_cast<const T*>(a);
  T* O = static_cast<T*>(out);
  int* ip = static_cast<int*>(ipiv);
  int* pe = static_cast<int*>(perm);
  int* in = static_cast<int*>(info);
  if (p.rk != nullptr) {
    const int grid = (batch + p.per_block - 1) / p.per_block;
    p.rk<<<dim3(grid), dim3(p.threads), p.smem, st>>>(A, O, ip, pe, in, batch, m, n, pivot);
  } else {
    batched_lu_swap_kernel<T><<<dim3(batch), dim3(p.threads), p.smem, st>>>(
        A, O, ip, pe, in, m, n, pivot, p.lw);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..9]: route, threads, matrices per block, dynamic shared memory,
// resident blocks per SM, registers per thread, local memory per thread
// (bytes: spills and stack), static shared memory, column capacity (warp
// route) or tile rows (block route, BT S), max threads per block
template <typename T>
int plan_lu(bool swap, int m, int n, int route, int device, int* out) {
  if (m < 1 || n < 1 || (!swap && m != n)) return static_cast<int>(cudaErrorInvalidValue);
  if (route != kAuto && !route_takes(route, m, n)) return static_cast<int>(cudaErrorInvalidValue);
  const LuPlan<T> p = lu_plan<T>(swap, m, n, route);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = prepare(p.fn, device, p.smem, static_cast<int>(p.smem));
  if (err != 0) return err;
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, p.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, p.fn, p.threads, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = p.route;
  out[1] = p.threads;
  out[2] = p.per_block;
  out[3] = static_cast<int>(p.smem);
  out[4] = resident;
  out[5] = at.numRegs;
  out[6] = static_cast<int>(at.localSizeBytes);
  out[7] = static_cast<int>(at.sharedSizeBytes);
  out[8] = p.cap;
  out[9] = at.maxThreadsPerBlock;
  return 0;
}

}  // namespace

extern "C" {

// Factor `batch` row-major (m, n) matrices at `a` into `out` (another buffer
// than `a`) on `stream`.  ipiv (batch, min(m, n)), perm (batch, m) or null, info
// (batch,), all int32.  `route` 0 takes the shape's own route (own_route),
// 1 / 2 / 3 force the warp / block / tile route (refused where the route
// does not take the shape).  `smem` is the caller's count of dynamic shared
// memory for that route and must equal the kernel's.  Returns a cudaError_t
// code (0 on success) for the launch; faults during the run surface at the
// next synchronisation.
int rf_batched_lu_swap_f32(const void* a, void* out, void* ipiv, void* perm,
                           void* info, int batch, int m, int n, int pivot,
                           int route, int smem, int device, void* stream) {
  return launch_lu<float>(true, a, out, ipiv, perm, info, batch, m, n, pivot, route,
                          smem, device, stream);
}

int rf_batched_lu_swap_f64(const void* a, void* out, void* ipiv, void* perm,
                           void* info, int batch, int m, int n, int pivot,
                           int route, int smem, int device, void* stream) {
  return launch_lu<double>(true, a, out, ipiv, perm, info, batch, m, n, pivot, route,
                           smem, device, stream);
}

// The launch plan of the swap mode for (m, n) of `elem` bytes (4 or 8) under
// `route` (as above), with the kernel's resources and occupancy on `device`:
// out[10] as plan_lu says.
int rf_batched_lu_swap_plan(int m, int n, int elem, int route, int device, int* out) {
  if (elem == 8) return plan_lu<double>(true, m, n, route, device, out);
  if (elem == 4) return plan_lu<float>(true, m, n, route, device, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for square (n, n) matrices in physical order: perm (batch, n)
// receives the pivot row of each step, and the factors leave in that order.
// The routes are the swap mode's first two (1 warp n <= 32, 2 block n <=
// 128); the tile route (3), and n > 128 on the shape's own, are refused.
int rf_batched_lu_noswap_f32(const void* a, void* out, void* perm, void* info,
                             int batch, int n, int pivot, int route, int smem, int device,
                             void* stream) {
  return launch_lu<float>(false, a, out, nullptr, perm, info, batch, n, n, pivot, route,
                          smem, device, stream);
}

int rf_batched_lu_noswap_f64(const void* a, void* out, void* perm, void* info,
                             int batch, int n, int pivot, int route, int smem, int device,
                             void* stream) {
  return launch_lu<double>(false, a, out, nullptr, perm, info, batch, n, n, pivot, route,
                           smem, device, stream);
}

int rf_batched_lu_noswap_plan(int n, int elem, int route, int device, int* out) {
  if (elem == 8) return plan_lu<double>(false, n, n, route, device, out);
  if (elem == 4) return plan_lu<float>(false, n, n, route, device, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef RF_BATCHED_TRACE
// Phase trace, for measurement (trace build only): with `buf` non-null every
// later launch of the warp or block route (either mode) writes, from thread 0
// of block 0 (the first matrix), clock64() stamps into buf[8 * step + phase]
// (the phases of each route are listed above its kernel) and into
// buf[8 * min(m, n) + {0, 1, 2, 3}] the kernel's first %globaltimer (ns),
// clock64(), last %globaltimer, clock64(); the swap mode's tile route too.
// buf holds int64s on the device; null turns the trace off.
int rf_batched_lu_set_trace(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#endif

}  // extern "C"
