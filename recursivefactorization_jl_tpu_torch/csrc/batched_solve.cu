// Forward and backward substitution for a batch of small LU factorizations on
// Hopper: one thread block per matrix.
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
// Here a block reads its factor matrix from the row-major (B, n, n) tensor
// with coalesced loads into a shared-memory tile with row stride n + 1 (both
// sweeps walk down columns, which then touch n different banks), keeps the
// right-hand sides (n, nrhs) in shared memory beside it (gathered by perm as
// they are read, or exchanged there by the ipiv sequence, so the permutation
// costs no pass over device memory and no launch), and runs both sweeps with
// one __syncthreads() per step.  In the backward sweep every thread of a
// column divides the step's entry itself and the finished value goes to a
// separate buffer, so that no thread reads an entry another one is replacing.
//
// What bounds it.  Bytes: the factors are read once (each entry is used once
// per sweep at most), the right-hand sides read and written once; the 2n^2
// operations per column are far below the card's rate.  In practice the 2n
// dependent steps, each a barrier, set the time of a block, and many
// resident blocks per SM hide it.

#include <cuda_runtime.h>

#include <cstddef>

#include "rf_common.cuh"

namespace {

using namespace rf;

constexpr int kMaxThreads = 256;

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

size_t smem_bytes(int n, int nrhs, size_t elem) {
  return (static_cast<size_t>(n) * (n + 1) + 2 * static_cast<size_t>(n) * nrhs) * elem +
         4 * static_cast<size_t>(n);
}

template <typename T>
int launch(const void* f, const void* b, void* x, const void* perm,
           const void* ipiv, int batch, int n, int nrhs, int smem_given,
           int device, void* stream) {
  if (batch < 1 || n < 1 || nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, nrhs, sizeof(T));
  const int err = prepare(reinterpret_cast<const void*>(batched_solve_kernel<T>), device,
                          smem, smem_given);
  if (err != 0) return err;
  // enough threads to load the tile quickly and to give every entry of the
  // right-hand sides its own thread where they are few
  int threads = 64;
  while (threads < kMaxThreads && (threads < 2 * n || threads < n * nrhs)) threads <<= 1;
  batched_solve_kernel<T><<<dim3(batch), dim3(threads), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<const int*>(perm), static_cast<const int*>(ipiv), n, nrhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Solve with `batch` packed (n, n) factorizations at `f` and right-hand sides
// (batch, n, nrhs) at `b` into `x` (another buffer than `b`), on `stream`.
// The rows of `b` are taken by `perm` (batch, n) int32 when it is not null,
// else exchanged by the swap sequence `ipiv` (batch, n) int32 when that is not
// null, else used as they are.  `smem` is the caller's count of dynamic shared
// memory and must equal the kernel's.  Returns a cudaError_t code (0 on
// success) for the launch; faults during the run surface at the next
// synchronisation.
int rf_batched_solve_f32(const void* f, const void* b, void* x, const void* perm,
                         const void* ipiv, int batch, int n, int nrhs, int smem,
                         int device, void* stream) {
  return launch<float>(f, b, x, perm, ipiv, batch, n, nrhs, smem, device, stream);
}

int rf_batched_solve_f64(const void* f, const void* b, void* x, const void* perm,
                         const void* ipiv, int batch, int n, int nrhs, int smem,
                         int device, void* stream) {
  return launch<double>(f, b, x, perm, ipiv, batch, n, nrhs, smem, device, stream);
}

}  // extern "C"
