// LU of a batch of small matrices on Hopper: one thread block per matrix.
//
// Replaces the TPU kernel recursivefactorization_jl_tpu/ops/batched_kernel.py
// `_lane_kernel` (reached through `batched_lu_pallas` and
// `batched_lu_pallas_noswap`) with two kernels that compute what its two
// modes compute, and agree bitwise with the package's plain versions,
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
//           is searched among the rows not used yet (ties by physical row),
//           that row becomes used, and every other unused row is scaled and
//           updated from it.  The rows are written back in pivot order, so
//           the factors come out as L @ U == A[perm, :] without a gather.
//
// Every product and difference is rounded on its own (__fmul_rn, __fsub_rn,
// and -fmad=false at build time) and the scale is x * (1/p).
//
// Design.  The TPU kernel puts 128 matrices side by side on the lane axis of
// a transposed (n, m, G) block, pads the batch to a multiple of G and masks
// whole-block vector passes.  None of that is carried over.  Here a block
// reads its matrix from the row-major (B, m, n) tensor with coalesced loads
// into a shared-memory tile whose row stride is n + 1 (so that a walk down a
// column touches m different banks), runs the whole pivot chain there, and
// writes the factors back once.  Warp 0 searches the pivot with a shuffle
// reduction over (|value|, row) pairs and does the step's bookkeeping; the
// row interchange and the column scale share one phase (the interchange
// skips column k, which the scale phase moves itself); the update is spread
// over the block with `lw` lanes per row.  Three __syncthreads() per step.
// Many blocks are resident per SM (a 64 x 64 f32 tile is 17 KB), which hides
// the barriers of one behind the work of the others.
//
// What bounds it.  By the roofline, bytes: each matrix is read and written
// once, and the 2n^3/3 operations per matrix are a fraction of that time at
// the card's rate.  In practice the n-step chain of barriers and the
// shared-memory traffic of the rank-1 updates (three accesses per multiply-
// subtract) set the time, not device memory.
//
// A later PR would: fuse the next step's pivot search into the update, keep
// several columns of the trailing block in registers, and pack several
// matrices into one block (a warp per matrix) at n <= 32.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "rf_common.cuh"

namespace {

using namespace rf;

constexpr int kMaxThreads = 1024;

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

// Shared-memory layout of both kernels (see lu_smem_bytes in
// ops/batched_kernel.py): tile m x (n + 1), lcol m, then 2 * m ints.
template <typename T>
struct Tile {
  T* s;
  T* lcol;
  int* ia;  // swap: composed permutation;  noswap: used flags
  int* ib;  // noswap: pivot row of each step
  int ld;
  __device__ Tile(unsigned char* raw, int m, int n) {
    ld = n + 1;
    s = reinterpret_cast<T*>(raw);
    lcol = s + static_cast<size_t>(m) * ld;
    ia = reinterpret_cast<int*>(lcol + m);
    ib = ia + m;
  }
};

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

  for (int e = tid; e < count; e += nt) {
    const int i = e / n, j = e - i * n;
    s[i * ld + j] = a[base + e];
  }
  for (int i = tid; i < m; i += nt) t.ia[i] = i;
  int info_v = 0;  // kept by thread 0
  __syncthreads();

  const int rg = tid / lw, cl = tid - rg * lw, nrg = nt / lw;

  for (int k = 0; k < minmn; ++k) {
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
    __syncthreads();

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
    __syncthreads();

    // ---- rank-1 update of the trailing block ------------------------------
    const T* u = s + k * ld;
    for (int i = k + 1 + rg; i < m; i += nrg) {
      const T l = t.lcol[i];
      T* row = s + i * ld;
      for (int j = k + 1 + cl; j < n; j += lw) {
        row[j] = rsub(row[j], rmul(l, u[j]));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < count; e += nt) {
    const int i = e / n, j = e - i * n;
    out[base + e] = s[i * ld + j];
  }
  if (perm != nullptr) {
    for (int i = tid; i < m; i += nt) perm[mat * m + i] = t.ia[i];
  }
  if (tid == 0) info[mat] = info_v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) batched_lu_noswap_kernel(const T* __restrict__ a, T* __restrict__ out,
                                         int* __restrict__ perm, int* __restrict__ info,
                                         int n, int pivot, int lw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_kp;
  __shared__ T s_pv;
  Tile<T> t(smem_raw, n, n);
  T* s = t.s;
  int* used = t.ia;
  int* prow = t.ib;
  const int ld = t.ld;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t mat = blockIdx.x;
  const size_t base = mat * n * n;
  const int count = n * n;

  for (int e = tid; e < count; e += nt) {
    const int i = e / n, j = e - i * n;
    s[i * ld + j] = a[base + e];
  }
  for (int i = tid; i < n; i += nt) used[i] = 0;
  int info_v = 0;  // kept by thread 0
  __syncthreads();

  const int rg = tid / lw, cl = tid - rg * lw, nrg = nt / lw;

  for (int k = 0; k < n; ++k) {
    // ---- pivot search among the unused rows: warp 0 -----------------------
    if (tid < 32) {
      int kp = k;
      if (pivot) {
        T best = T(-1);
        int bi = INT_MAX;
        for (int i = lane; i < n; i += 32) {
          if (used[i]) continue;
          const T v = mag(s[i * ld + k]);
          if (better(v, i, best, bi)) { best = v; bi = i; }
        }
        warp_best(best, bi);
        kp = (isnan(best) || bi > n - 1) ? n - 1 : bi;
      }
      __syncwarp();
      if (lane == 0) {
        const T pv = s[kp * ld + k];
        s_kp = kp;
        s_pv = pv;
        prow[k] = kp;
        // from here on "unused" means: eliminated at this step
        used[kp] = 1;
        if (pv == T(0) && info_v == 0) info_v = pivot ? k + 1 : -(k + 1);
      }
    }
    __syncthreads();

    // ---- scale column k of the rows still to eliminate --------------------
    const int kp = s_kp;
    const T pv = s_pv;
    const bool nz = pv != T(0);
    const T r = nz ? rrcp(pv) : T(1);
    for (int i = tid; i < n; i += nt) {
      if (used[i]) continue;
      T l = s[i * ld + k];
      if (nz) {
        l = rmul(l, r);
        s[i * ld + k] = l;
      }
      t.lcol[i] = l;
    }
    __syncthreads();

    // ---- rank-1 update of those rows --------------------------------------
    const T* u = s + kp * ld;
    for (int i = rg; i < n; i += nrg) {
      if (used[i]) continue;
      const T l = t.lcol[i];
      T* row = s + i * ld;
      for (int j = k + 1 + cl; j < n; j += lw) {
        row[j] = rsub(row[j], rmul(l, u[j]));
      }
    }
    __syncthreads();
  }

  // rows leave in pivot order: logical row i is physical row prow[i]
  for (int e = tid; e < count; e += nt) {
    const int i = e / n, j = e - i * n;
    out[base + e] = s[prow[i] * ld + j];
  }
  for (int i = tid; i < n; i += nt) perm[mat * n + i] = prow[i];
  if (tid == 0) info[mat] = info_v;
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

template <typename T>
int launch_swap(const void* a, void* out, void* ipiv, void* perm, void* info,
                int batch, int m, int n, int pivot, int smem_given, int device,
                void* stream) {
  if (batch < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(m, n, sizeof(T));
  int err = prepare(reinterpret_cast<const void*>(batched_lu_swap_kernel<T>), device, smem, smem_given);
  if (err != 0) return err;
  int threads = 0, lw = 0;
  block_shape(m, n, &threads, &lw);
  batched_lu_swap_kernel<T><<<dim3(batch), dim3(threads), smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), static_cast<int*>(ipiv),
      static_cast<int*>(perm), static_cast<int*>(info), m, n, pivot, lw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_noswap(const void* a, void* out, void* perm, void* info, int batch,
                  int n, int pivot, int smem_given, int device, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, n, sizeof(T));
  int err = prepare(reinterpret_cast<const void*>(batched_lu_noswap_kernel<T>), device, smem, smem_given);
  if (err != 0) return err;
  int threads = 0, lw = 0;
  block_shape(n, n, &threads, &lw);
  batched_lu_noswap_kernel<T><<<dim3(batch), dim3(threads), smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), static_cast<int*>(perm),
      static_cast<int*>(info), n, pivot, lw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Factor `batch` row-major (m, n) matrices at `a` into `out` (another buffer
// than `a`) on `stream`.  ipiv (batch, min(m, n)), perm (batch, m) or null, info
// (batch,), all int32.  `smem` is the caller's count of dynamic shared
// memory and must equal the kernel's.  Returns a cudaError_t code (0 on
// success) for the launch; faults during the run surface at the next
// synchronisation.
int rf_batched_lu_swap_f32(const void* a, void* out, void* ipiv, void* perm,
                           void* info, int batch, int m, int n, int pivot,
                           int smem, int device, void* stream) {
  return launch_swap<float>(a, out, ipiv, perm, info, batch, m, n, pivot, smem,
                            device, stream);
}

int rf_batched_lu_swap_f64(const void* a, void* out, void* ipiv, void* perm,
                           void* info, int batch, int m, int n, int pivot,
                           int smem, int device, void* stream) {
  return launch_swap<double>(a, out, ipiv, perm, info, batch, m, n, pivot, smem,
                             device, stream);
}

// The same for square (n, n) matrices in physical order; perm (batch, n).
int rf_batched_lu_noswap_f32(const void* a, void* out, void* perm, void* info,
                             int batch, int n, int pivot, int smem, int device,
                             void* stream) {
  return launch_noswap<float>(a, out, perm, info, batch, n, pivot, smem, device,
                              stream);
}

int rf_batched_lu_noswap_f64(const void* a, void* out, void* perm, void* info,
                             int batch, int n, int pivot, int smem, int device,
                             void* stream) {
  return launch_noswap<double>(a, out, perm, info, batch, n, pivot, smem, device,
                               stream);
}

}  // extern "C"
