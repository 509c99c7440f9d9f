// What the package's kernels share: arithmetic that rounds once per
// operation, the pivot order, the shared-memory opt-in and the C interface's
// error text.  Every source under csrc/ includes this header, and
// ops/_kernels.py hashes it with each of them.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace rf {

constexpr unsigned kFull = 0xffffffffu;

// One rounding per product, sum, difference and quotient (with -fmad=false at
// build time), as in the plain PyTorch versions the kernels are held to.
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rrcp(float p) { return __fdiv_rn(1.0f, p); }
__device__ __forceinline__ double rrcp(double p) { return __ddiv_rn(1.0, p); }
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

// Is candidate (va, ia) a better pivot than (vb, ib)?  A NaN beats numbers,
// a larger magnitude beats a smaller one, the smaller row breaks ties.  The
// empty candidate is (-1, INT_MAX) and loses to every row.
template <typename T>
__device__ __forceinline__ bool better(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

// Reduce (best, bi) over a warp by `better`; lane 0 ends with the warp's
// best candidate.  All 32 lanes call it.
template <typename T>
__device__ __forceinline__ void warp_best(T& best, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (better(ov, oi, best, bi)) { best = ov; bi = oi; }
  }
}

// The same with a tag (the block that proposed the candidate) riding along.
template <typename T>
__device__ __forceinline__ void warp_best(T& best, int& bi, int& tag) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    const int ot = __shfl_down_sync(kFull, tag, off);
    if (better(ov, oi, best, bi)) { best = ov; bi = oi; tag = ot; }
  }
}

// Reduce every thread's (best, bi) over a thread block of kWarps warps;
// thread 0 ends with the block's best candidate.  red_val and red_idx are
// shared arrays of kWarps entries.  Every thread calls it; it holds one
// __syncthreads().
template <int kWarps, typename T>
__device__ __forceinline__ void block_best(T& best, int& bi, T* red_val, int* red_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(best, bi);
  if (lane == 0) { red_val[warp] = best; red_idx[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? red_val[lane] : T(-1);
    bi = lane < kWarps ? red_idx[lane] : INT_MAX;
    warp_best(best, bi);
  }
}

// Dynamic shared memory above 48 KB has to be asked for, per kernel.
inline cudaError_t opt_in_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Before a launch: select the device, hold the caller's count of dynamic
// shared memory (from which it decided that the shape fits) to the kernel's
// own, and opt in.  Returns a cudaError_t code.
inline int prepare(const void* kernel, int device, size_t smem, int smem_given) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem != static_cast<size_t>(smem_given)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(opt_in_smem(kernel, smem));
}

}  // namespace rf

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
