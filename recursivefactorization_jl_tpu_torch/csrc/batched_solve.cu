// Forward and backward substitution for a batch of small LU factorizations on
// Hopper.
//
// Replaces the TPU kernel recursivefactorization_jl_tpu/ops/batched_kernel.py
// `_lane_solve_kernel` (reached through `batched_solve_pallas`).  It computes
// the same function as the package's plain version, ops/batched_kernel.py
// `batched_solve_plain`: for packed factors F (n, n) and right-hand sides
// in pivot order (brought there by the kernel itself when it is handed the
// factorization's perm or ipiv, which the TPU kernel leaves to its caller),
//   forward   k = 0 .. n-2:   x[i] = x[i] - F[i, k] * x[k]        for i > k
//   backward  k = n-1 .. 0:   x[k] = x[k] / F[k, k]
//                             x[i] = x[i] - F[i, k] * x[k]        for i < k
// with every product, difference and quotient rounded on its own (__fmul_rn,
// __fsub_rn, __fdiv_rn, and -fmad=false at build time), so the two agree
// bitwise.  A zero on U's diagonal gives inf/nan in that matrix only.
//
// Design.  The TPU kernel holds 128 factor matrices side by side on the lane
// axis of a transposed (n, n, G) block and pads the batch to a multiple of G.
// None of that is carried over.  Two routes, chosen by the shape
// (`own_route`, mirrored by ops/batched_kernel.py `solve_route`):
//
//   warp   n <= 32: N lanes per matrix (N = 8, 16 or 32, the smallest that
//          holds n), several matrices per block of 128 threads.  The factors
//          are loaded coalesced into a shared-memory tile and lane i then
//          keeps row i of F in registers (an array indexed only by constants:
//          the step loops are unrolled over N), and x[i, :] beside it, RC
//          right-hand sides at a time (RC = 1, or 4 when nrhs > 1).  Forward
//          step k broadcasts x[k] with a shuffle and every lane i > k
//          subtracts F[i, k] x[k]; backward step k divides x[k] by F[k, k] in
//          lane k, broadcasts it, and every lane i < k subtracts.  Lane i
//          reads row perm[i] of b; the ipiv swaps are first folded into that
//          permutation by shuffles, as the composed permutation of the
//          factorization is.  No barrier: one __syncwarp after the tile's
//          load.  A group past the end of the batch runs on zeros and stores
//          nothing, so that every lane reaches every shuffle.
//   wide   32 < n <= 128: one warp per matrix, 1, 2 or 4 matrices per
//          block (`wide_group`: the most resident warps by shared memory).
//          Lane l keeps rows l + 32 r (r < R = 2, 3 or 4, a template
//          parameter) of x, RC right-hand sides at a time.  The factors
//          pass through an n x 33 shared-memory tile one block of 32
//          columns at a time, copied by cp.async (a lane's whole column in
//          flight, one wait per block): the rows below the block's first
//          column for the forward sweep, the rows down to its last column
//          for the backward one.  Forward step k broadcasts x[k] from lane
//          k % 32 with a shuffle and every row i > k subtracts F[i, k] x[k],
//          F[i, k] read down the tile's column (stride 33: 32 banks);
//          backward step k broadcasts x[k], every lane divides it by F[k, k]
//          (the same operands: no divergent slow path), and every row i < k
//          subtracts.  The step loop is not unrolled (the register indices
//          r and the rhs are constants without it).  perm is read per row;
//          ipiv is folded per row by tracing every swap backwards from it
//          (a lane's rows at once, no chain across lanes).  No barrier.
//
// What bounds them.  Bytes: the factors are read once (each entry is used
// once per sweep at most), the right-hand sides read and written once; the
// 2n^2 operations per column are far below the card's rate.  In practice
// the 2n dependent steps set the time of a matrix: each step is a shuffle
// and a multiply-subtract (and in the backward sweep a division), with many
// matrices in flight per SM to hide their latency; on the wide route also
// the 2R tile copies, each one memory latency (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>

#include "rf_common.cuh"

namespace {

using namespace rf;

// ---- warp route ---------------------------------------------------------------
// N lanes per matrix (8, 16 or 32), RC right-hand sides per pass.
constexpr int kWarpThreads = 128;
constexpr int kAuto = 0, kWarp = 1, kWide = 2;
constexpr int kWarpMaxN = 32;

// Resident blocks per SM asked of the register allocator: with 32 f32
// lanes its own choice (80 registers) leaves 24 warps per SM; 8 blocks allow
// 64 registers and 32 warps.
template <typename T, int N>
constexpr int solve_min_blocks() { return sizeof(T) == 4 && N == 32 ? 8 : 1; }

template <typename T, int N, int RC>
__global__ void __launch_bounds__(kWarpThreads, solve_min_blocks<T, N>())
batched_solve_warp_kernel(const T* __restrict__ f, const T* __restrict__ b,
                          T* __restrict__ x, const int* __restrict__ perm,
                          const int* __restrict__ ipiv, int batch, int n, int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = kWarpThreads / N;  // matrices per block
  const int lane = threadIdx.x % N;    // the row this lane holds
  const int grp = threadIdx.x / N;
  const size_t mat = static_cast<size_t>(blockIdx.x) * G + grp;
  const bool live = mat < static_cast<size_t>(batch);
  const bool row = live && lane < n;
  const int ld = n | 1;  // odd: a lane-per-row walk hits distinct banks
  T* st = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(grp) * n * ld;
  const size_t fbase = mat * n * n;
  const size_t xbase = mat * n * nrhs;

  // coalesced load of the factors through shared memory, row by row (lane
  // j takes column j: no division by the runtime n)
  if (row) {
    for (int i = 0; i < n; ++i) st[i * ld + lane] = f[fbase + i * n + lane];
  }
  // the row of b this lane takes: perm[lane], or entry `lane` of the
  // permutation that the swaps k <-> ipiv[k], k = 0 .. n-1, compose
  int src = lane;
  if (perm != nullptr) {
    if (row) src = perm[mat * n + lane];
  } else if (ipiv != nullptr) {
    const int pv = row ? ipiv[mat * n + lane] : lane;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= n) continue;  // no exit from the unrolled loop
      const int pk = __shfl_sync(kFull, pv, k, N);
      src = __shfl_sync(kFull, src, lane == k ? pk : (lane == pk ? k : lane), N);
    }
  }
  __syncwarp();
  T r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = (row && j < n) ? st[lane * ld + j] : T(0);

  for (int c0 = 0; c0 < nrhs; c0 += RC) {
    T v[RC];
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int c = c0 + q;
      v[q] = (row && c < nrhs) ? b[xbase + static_cast<size_t>(src) * nrhs + c] : T(0);
    }
    // forward: unit lower
#pragma unroll
    for (int k = 0; k + 1 < N; ++k) {
      if (k + 1 >= n) continue;
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const T xk = __shfl_sync(kFull, v[q], k, N);
        const T y = rsub(v[q], rmul(r[k], xk));
        v[q] = lane > k ? y : v[q];
      }
    }
    // backward: upper; lane k divides, every lane above it subtracts
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      if (k >= n) continue;
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const T xk = __shfl_sync(kFull, rdiv(v[q], r[k]), k, N);
        const T y = rsub(v[q], rmul(r[k], xk));
        v[q] = lane == k ? xk : (lane < k ? y : v[q]);
      }
    }
    if (row) {
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int c = c0 + q;
        if (c < nrhs) x[xbase + static_cast<size_t>(lane) * nrhs + c] = v[q];
      }
    }
  }
}

int warp_lanes(int n) { return n <= 8 ? 8 : (n <= 16 ? 16 : 32); }

size_t warp_smem_bytes(int n, size_t elem) {
  return static_cast<size_t>(kWarpThreads / warp_lanes(n)) * n * (n | 1) * elem;
}

template <typename T>
using SolveKernel = void (*)(const T*, const T*, T*, const int*, const int*, int, int, int);

template <typename T, int RC>
SolveKernel<T> warp_kernel_rc(int lanes) {
  if (lanes == 8) return batched_solve_warp_kernel<T, 8, RC>;
  if (lanes == 16) return batched_solve_warp_kernel<T, 16, RC>;
  return batched_solve_warp_kernel<T, 32, RC>;
}

// ---- wide route -----------------------------------------------------------------
// One warp per matrix for 32 < n <= 32 R: lane l holds rows l + 32 r, r < R,
// of x (RC right-hand sides per pass).  The factors pass through a
// shared-memory tile of 32 columns at a time (row stride 33: a column read
// by the 32 lanes hits 32 banks): column block c, columns 32 c .. 32 c + 31,
// rows below its first column for the forward sweep, rows down to its last
// column for the backward one.  ipiv is folded into the row each lane reads
// by tracing every swap backwards from its row (no cross-lane chain).  No
// barrier; a __syncwarp around each tile load.
constexpr int kWideLd = 33;
constexpr int kWideMaxR = 4;

// One element from device to shared memory without passing through
// registers (cp.async): a lane can keep a whole tile column in flight and
// wait once.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

template <typename T, int R, int RC>
__global__ void __launch_bounds__(kWarpThreads) batched_solve_wide_kernel(
    const T* __restrict__ f, const T* __restrict__ b, T* __restrict__ x,
    const int* __restrict__ perm, const int* __restrict__ ipiv, int batch, int n, int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const size_t mat = static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + grp;
  if (mat >= static_cast<size_t>(batch)) return;  // a whole warp: no one waits for it
  T* st = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(grp) * n * kWideLd;
  const size_t fbase = mat * n * n;
  const size_t xbase = mat * n * nrhs;

  // the row of b each of my rows takes: perm[i], or entry i of the
  // permutation that the swaps k <-> ipiv[k], k = 0 .. n-1, compose (traced
  // backwards through every swap; ipiv staged in the tile)
  int src[R];
#pragma unroll
  for (int r = 0; r < R; ++r) src[r] = lane + 32 * r;
  if (perm != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (src[r] < n) src[r] = perm[mat * n + src[r]];
    }
  } else if (ipiv != nullptr) {
    int* piv = reinterpret_cast<int*>(st);
    for (int i = lane; i < n; i += 32) piv[i] = ipiv[mat * n + i];
    __syncwarp();
    for (int k = n - 1; k >= 0; --k) {
      const int p = piv[k];
#pragma unroll
      for (int r = 0; r < R; ++r) src[r] = src[r] == p ? k : (src[r] == k ? p : src[r]);
    }
    __syncwarp();
  }

  for (int c0 = 0; c0 < nrhs; c0 += RC) {
    T v[R][RC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int c = c0 + q;
        v[r][q] = (i < n && c < nrhs) ? b[xbase + static_cast<size_t>(src[r]) * nrhs + c] : T(0);
      }
    }
    // forward: unit lower, column block cb
#pragma unroll
    for (int cb = 0; cb < R; ++cb) {
      const int j0 = 32 * cb;
      if (j0 + 1 >= n) continue;
      __syncwarp();  // the last block's reads are done
      if (j0 + lane < n) {
        for (int i = j0 + 1; i < n; ++i)
          copy_async(st + i * kWideLd + lane, f + fbase + static_cast<size_t>(i) * n + j0 + lane);
      }
      copy_async_wait();
      // a loop, not unrolled: the register indices (cb, q, r) are constants
      // without it, and the code stays small
      const int kend = n - 1 - j0 < 32 ? n - 1 - j0 : 32;
      for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const T xk = __shfl_sync(kFull, v[cb][q], kk);
#pragma unroll
          for (int r = cb; r < R; ++r) {
            const int i = lane + 32 * r;
            const bool in = i < n && (r > cb || lane > kk);
            const T fik = st[(in ? i : j0) * kWideLd + kk];
            const T y = rsub(v[r][q], rmul(fik, xk));
            v[r][q] = in ? y : v[r][q];
          }
        }
      }
    }
    // backward: upper, column blocks from the last; the owner's entry is
    // broadcast first, then every lane divides the same value
#pragma unroll
    for (int cb = R - 1; cb >= 0; --cb) {
      const int j0 = 32 * cb;
      if (j0 >= n) continue;
      const int rows = j0 + 32 < n ? j0 + 32 : n;
      __syncwarp();
      if (j0 + lane < n) {
        for (int i = 0; i < rows; ++i)
          copy_async(st + i * kWideLd + lane, f + fbase + static_cast<size_t>(i) * n + j0 + lane);
      }
      copy_async_wait();
      for (int kk = rows - 1 - j0; kk >= 0; --kk) {
        const int k = j0 + kk;
        const T ukk = st[k * kWideLd + kk];
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const T xk = rdiv(__shfl_sync(kFull, v[cb][q], kk), ukk);
          if (lane == kk) v[cb][q] = xk;
#pragma unroll
          for (int r = 0; r <= cb; ++r) {
            const int i = lane + 32 * r;
            const bool in = r < cb || lane < kk;
            const T fik = st[(in ? i : 0) * kWideLd + kk];
            const T y = rsub(v[r][q], rmul(fik, xk));
            v[r][q] = in ? y : v[r][q];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int c = c0 + q;
        if (i < n && c < nrhs) x[xbase + static_cast<size_t>(i) * nrhs + c] = v[r][q];
      }
    }
  }
}

// Matrices (warps) per block of the wide route: the most resident warps per
// SM that the tile of n x 33 values per matrix allows, 1, 2 or 4 per block
// (32 blocks per SM, 64 warps, 228 KB of shared memory with 1 KB per block
// kept by the runtime), the fewest on a tie.
int wide_group(int n, size_t elem) {
  const size_t tile = static_cast<size_t>(n) * kWideLd * elem;
  int best = 1, best_warps = 0;
  for (int g = 1; g <= 4; g <<= 1) {
    const size_t per_block = g * tile + 1024;
    int blocks = static_cast<int>(233472 / per_block);
    if (blocks > 32) blocks = 32;
    int warps = blocks * g;
    if (warps > 64) warps = 64;
    if (warps > best_warps) { best = g; best_warps = warps; }
  }
  return best;
}

size_t wide_smem_bytes(int n, size_t elem) {
  return static_cast<size_t>(wide_group(n, elem)) * n * kWideLd * elem;
}

template <typename T, int RC>
SolveKernel<T> wide_kernel_rc(int n) {
  const int r = (n + 31) / 32;
  if (r <= 2) return batched_solve_wide_kernel<T, 2, RC>;
  if (r == 3) return batched_solve_wide_kernel<T, 3, RC>;
  return batched_solve_wide_kernel<T, 4, RC>;
}

// What a launch of `route` (kAuto: the shape's own) does with n and nrhs:
// the kernel, threads per block, matrices per block, dynamic shared memory
// and (warp route) lanes per matrix or (wide route) rows per lane.
template <typename T>
struct SolvePlan {
  int route = 0, threads = 0, per_block = 1, cap = 0;
  size_t smem = 0;
  SolveKernel<T> k = nullptr;
};

int own_route(int n) { return n <= kWarpMaxN ? kWarp : kWide; }

// n the kernels take (at most kWarpMaxN * kWideMaxR = 128) and, unless it
// is kAuto, a route that takes it
bool route_takes(int route, int n) {
  if (n > kWarpMaxN * kWideMaxR) return false;
  if (route == kAuto) return true;
  if (route == kWarp) return n <= kWarpMaxN;
  return route == kWide && n > kWarpMaxN;
}

template <typename T>
SolvePlan<T> solve_plan(int n, int nrhs, int route) {
  SolvePlan<T> p;
  p.route = route == kAuto ? own_route(n) : route;
  if (p.route == kWarp) {
    p.cap = warp_lanes(n);
    p.k = nrhs == 1 ? warp_kernel_rc<T, 1>(p.cap) : warp_kernel_rc<T, 4>(p.cap);
    p.threads = kWarpThreads;
    p.per_block = kWarpThreads / p.cap;
    p.smem = warp_smem_bytes(n, sizeof(T));
  } else {
    p.cap = (n + 31) / 32;
    p.k = nrhs == 1 ? wide_kernel_rc<T, 1>(n) : wide_kernel_rc<T, 4>(n);
    p.per_block = wide_group(n, sizeof(T));
    p.threads = 32 * p.per_block;
    p.smem = wide_smem_bytes(n, sizeof(T));
  }
  return p;
}

template <typename T>
int launch(const void* f, const void* b, void* x, const void* perm,
           const void* ipiv, int batch, int n, int nrhs, int route, int smem_given,
           int device, void* stream) {
  if (batch < 1 || n < 1 || nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!route_takes(route, n)) return static_cast<int>(cudaErrorInvalidValue);
  const SolvePlan<T> p = solve_plan<T>(n, nrhs, route);
  const int err = prepare(reinterpret_cast<const void*>(p.k), device, p.smem, smem_given);
  if (err != 0) return err;
  const int grid = (batch + p.per_block - 1) / p.per_block;
  p.k<<<dim3(grid), dim3(p.threads), p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<const int*>(perm), static_cast<const int*>(ipiv), batch, n, nrhs);
  return static_cast<int>(cudaGetLastError());
}

// out[0..9] as csrc/batched_lu.cu's plans: route, threads, matrices per
// block, dynamic shared memory, resident blocks per SM, registers, local
// memory per thread, static shared memory, lanes per matrix (warp) or rows
// per lane (wide), max threads per block
template <typename T>
int plan(int n, int nrhs, int route, int device, int* out) {
  if (n < 1 || nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!route_takes(route, n)) return static_cast<int>(cudaErrorInvalidValue);
  const SolvePlan<T> p = solve_plan<T>(n, nrhs, route);
  const void* fn = reinterpret_cast<const void*>(p.k);
  int err = prepare(fn, device, p.smem, static_cast<int>(p.smem));
  if (err != 0) return err;
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, p.threads, p.smem);
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

// Solve with `batch` packed (n, n) factorizations at `f` and right-hand sides
// (batch, n, nrhs) at `b` into `x` (another buffer than `b`), on `stream`.
// The rows of `b` are taken by `perm` (batch, n) int32 when it is not null,
// else exchanged by the swap sequence `ipiv` (batch, n) int32 when that is not
// null, else used as they are.  n is at most 128.  `route` 0 takes the
// shape's own route (warp for n <= 32, wide beyond), 1 / 2 force the warp /
// wide route (the warp route refuses n > 32, the wide route n <= 32).
// `smem` is the caller's count of dynamic shared memory for that route and
// must equal the kernel's.  Returns a
// cudaError_t code (0 on success) for the launch; faults during the run
// surface at the next synchronisation.
int rf_batched_solve_f32(const void* f, const void* b, void* x, const void* perm,
                         const void* ipiv, int batch, int n, int nrhs, int route, int smem,
                         int device, void* stream) {
  return launch<float>(f, b, x, perm, ipiv, batch, n, nrhs, route, smem, device, stream);
}

int rf_batched_solve_f64(const void* f, const void* b, void* x, const void* perm,
                         const void* ipiv, int batch, int n, int nrhs, int route, int smem,
                         int device, void* stream) {
  return launch<double>(f, b, x, perm, ipiv, batch, n, nrhs, route, smem, device, stream);
}

// The launch plan of `route` (as above) for n and nrhs of `elem` bytes (4
// or 8), with the kernel's resources and occupancy on `device`: out[10] as
// `plan` says.
int rf_batched_solve_plan(int n, int nrhs, int elem, int route, int device, int* out) {
  if (elem == 8) return plan<double>(n, nrhs, route, device, out);
  if (elem == 4) return plan<float>(n, nrhs, route, device, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
