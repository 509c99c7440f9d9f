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
// (`solve_route`, mirrored by ops/batched_kernel.py `solve_route`):
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
//   block  n > 32 (or forced): one thread block per matrix (the PR 2
//          design).  It reads its factor matrix with coalesced loads into a
//          shared-memory tile with row stride n + 1 (both sweeps walk down
//          columns, which then touch n different banks), keeps the
//          right-hand sides (n, nrhs) in shared memory beside it (gathered
//          by perm as they are read, or exchanged there by the ipiv
//          sequence), and runs both sweeps with one __syncthreads() per
//          step.  In the backward sweep every thread of a column divides
//          the step's entry itself and the finished value goes to a
//          separate buffer, so that no thread reads an entry another one is
//          replacing.
//
// What bounds them.  Bytes: the factors are read once (each entry is used
// once per sweep at most), the right-hand sides read and written once; the
// 2n^2 operations per column are far below the card's rate.  In practice
// the 2n dependent steps set the time of a matrix: on the block route each
// step is a barrier, on the warp route a shuffle and a multiply-subtract
// (and in the backward sweep a division), with many matrices in flight per
// SM to hide their latency.

#include <cuda_runtime.h>

#include <cstddef>

#include "rf_common.cuh"

namespace {

using namespace rf;

constexpr int kMaxThreads = 256;

// ---- block route ---------------------------------------------------------------
// `perm` (batch, n), when given, is the composed row permutation: the block
// reads row perm[i] of its right-hand sides as row i.  `ipiv` (batch, n), when
// given instead, is the LAPACK swap sequence: the block applies the
// interchanges k <-> ipiv[k], k = 0 .. n-1, to its right-hand sides in shared
// memory, one thread per column.  With neither, `b` is already in pivot order.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
batched_solve_kernel(const T* __restrict__ f, const T* __restrict__ b,
                     T* __restrict__ x, const int* __restrict__ perm,
                     const int* __restrict__ ipiv, int n, int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + 1;
  T* s = reinterpret_cast<T*>(smem_raw);          // factors, n x (n + 1)
  T* xs = s + static_cast<size_t>(n) * ld;        // working rhs, n x nrhs
  T* xo = xs + static_cast<size_t>(n) * nrhs;     // solution, n x nrhs
  int* idx = reinterpret_cast<int*>(xo + static_cast<size_t>(n) * nrhs);  // n
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t mat = blockIdx.x;
  const size_t fbase = mat * n * n;
  const size_t xbase = mat * n * nrhs;
  const int fcount = n * n, xcount = n * nrhs;

  for (int e = tid; e < fcount; e += nt) {
    const int i = e / n, j = e - i * n;
    s[i * ld + j] = f[fbase + e];
  }
  if (perm != nullptr || ipiv != nullptr) {
    const int* src = (perm != nullptr ? perm : ipiv) + mat * n;
    for (int i = tid; i < n; i += nt) idx[i] = src[i];
    __syncthreads();
  }
  if (perm != nullptr) {
    for (int e = tid; e < xcount; e += nt) {
      const int i = nrhs == 1 ? e : e / nrhs;
      const int r = e - i * nrhs;
      xs[e] = b[xbase + static_cast<size_t>(idx[i]) * nrhs + r];
    }
  } else {
    for (int e = tid; e < xcount; e += nt) xs[e] = b[xbase + e];
  }
  __syncthreads();
  if (perm == nullptr && ipiv != nullptr) {
    for (int r = tid; r < nrhs; r += nt) {
      for (int k = 0; k < n; ++k) {
        const int p = idx[k];
        const T v = xs[k * nrhs + r];
        xs[k * nrhs + r] = xs[p * nrhs + r];
        xs[p * nrhs + r] = v;
      }
    }
    __syncthreads();
  }

  // forward: unit lower
  for (int k = 0; k + 1 < n; ++k) {
    for (int e = (k + 1) * nrhs + tid; e < xcount; e += nt) {
      const int i = nrhs == 1 ? e : e / nrhs;
      const int r = e - i * nrhs;
      xs[e] = rsub(xs[e], rmul(s[i * ld + k], xs[k * nrhs + r]));
    }
    __syncthreads();
  }

  // backward: upper.  Row k of xs is read by every thread of its column and
  // replaced by none; the quotient goes to xo.
  for (int k = n - 1; k >= 0; --k) {
    const T ukk = s[k * ld + k];
    for (int e = tid; e < (k + 1) * nrhs; e += nt) {
      const int i = nrhs == 1 ? e : e / nrhs;
      const int r = e - i * nrhs;
      const T xk = rdiv(xs[k * nrhs + r], ukk);
      if (i == k) {
        xo[e] = xk;
      } else {
        xs[e] = rsub(xs[e], rmul(s[i * ld + k], xk));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < xcount; e += nt) x[xbase + e] = xo[e];
}

// ---- warp route ---------------------------------------------------------------
// N lanes per matrix (8, 16 or 32), RC right-hand sides per pass.
constexpr int kWarpThreads = 128;
constexpr int kAuto = 0, kWarp = 1, kBlock = 2;
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

// The block route's dynamic shared memory.
size_t smem_bytes(int n, int nrhs, size_t elem) {
  return (static_cast<size_t>(n) * (n + 1) + 2 * static_cast<size_t>(n) * nrhs) * elem +
         4 * static_cast<size_t>(n);
}

template <typename T>
int launch(const void* f, const void* b, void* x, const void* perm,
           const void* ipiv, int batch, int n, int nrhs, int route, int smem_given,
           int device, void* stream) {
  if (batch < 1 || n < 1 || nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kAuto) route = n <= kWarpMaxN ? kWarp : kBlock;
  if ((route != kWarp && route != kBlock) || (route == kWarp && n > kWarpMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* F = static_cast<const T*>(f);
  const T* Bv = static_cast<const T*>(b);
  T* X = static_cast<T*>(x);
  const int* pe = static_cast<const int*>(perm);
  const int* ip = static_cast<const int*>(ipiv);
  if (route == kWarp) {
    const int lanes = warp_lanes(n);
    const SolveKernel<T> k = nrhs == 1 ? warp_kernel_rc<T, 1>(lanes) : warp_kernel_rc<T, 4>(lanes);
    const size_t smem = warp_smem_bytes(n, sizeof(T));
    const int err = prepare(reinterpret_cast<const void*>(k), device, smem, smem_given);
    if (err != 0) return err;
    const int per_block = kWarpThreads / lanes;
    k<<<dim3((batch + per_block - 1) / per_block), dim3(kWarpThreads), smem, st>>>(
        F, Bv, X, pe, ip, batch, n, nrhs);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = smem_bytes(n, nrhs, sizeof(T));
  const int err = prepare(reinterpret_cast<const void*>(batched_solve_kernel<T>), device,
                          smem, smem_given);
  if (err != 0) return err;
  // enough threads to load the tile quickly and to give every entry of the
  // right-hand sides its own thread where they are few
  int threads = 64;
  while (threads < kMaxThreads && (threads < 2 * n || threads < n * nrhs)) threads <<= 1;
  batched_solve_kernel<T><<<dim3(batch), dim3(threads), smem, st>>>(F, Bv, X, pe, ip, n, nrhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Solve with `batch` packed (n, n) factorizations at `f` and right-hand sides
// (batch, n, nrhs) at `b` into `x` (another buffer than `b`), on `stream`.
// The rows of `b` are taken by `perm` (batch, n) int32 when it is not null,
// else exchanged by the swap sequence `ipiv` (batch, n) int32 when that is not
// null, else used as they are.  `route` 0 takes the shape's own route
// (warp for n <= 32, block beyond), 1 / 2 force the warp / block route
// (the warp route refuses n > 32).  `smem` is the caller's count of dynamic
// shared memory for that route and must equal the kernel's.  Returns a
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

}  // extern "C"
