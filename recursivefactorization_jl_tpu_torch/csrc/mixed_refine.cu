// The two float64 passes of mixed-precision iterative refinement as LAPACK's
// DSGESV runs it (models/mixed.py `mixed_lu` / `mixed_lu_solve`): a float32
// LU of single(A), refined against the float64 A.
//
// It replaces no TPU kernel: the JAX package has no mixed-precision solver.
// DSGESV reads the float64 A in DLANGE('I') and DLAG2S once, and in DGEMV (the
// residual), two IDAMAX and DLAG2S of r once a step; as tensor code each is a
// pass of its own.  These two kernels read A once each:
//
// * mixed_narrow_kernel (DLAG2S + DLANGE('I')): single(A) into the factor
//   workspace (round to nearest, __double2float_rn), the row sums of |A| and
//   their largest, ||A||_inf, and an overflow flag set where some |a_ij|
//   exceeds float32's largest finite value (DLAG2S's RMAX test; a NaN does
//   not set it);
// * mixed_residual_kernel (DGEMV + IDAMAX + DLAG2S): r = b - A x in float64,
//   single(r) with its overflow flag, max |r| and max |x| per right-hand side
//   and, in the last block to finish, LAPACK's stopping test written into the
//   status (state, steps).
//
// Order of the sums, fixed, so that ops/mixed_refine.py's tensor twins give the
// same bits: row i is one block of kThreads threads; thread t sums its columns
// t, t + kThreads, t + 2 kThreads, ... in that order (a product and a sum, each
// rounded on its own: rf::rmul / radd, built with -fmad=false), then the block
// adds in a fixed tree, s_t += s_{t + h} for h = kThreads / 2, ..., 1.  The
// maxima are order-free (atomicMax on the bits of non-negative doubles).
//
// Bound: bytes.  Narrowing reads 8 n^2 and writes 4 n^2 bytes (192 MiB, 60 us
// at 3.35 TB/s at n = 4096); a residual pass reads 8 n^2 (128 MiB, 40 us)
// beside 2 n^2 operations (0.5 us at 67 TFLOP/s).  A right-hand side of k
// columns is k blocks a row, each reading A's row once.

#include "rf_common.cuh"

#include <cfloat>

namespace {

constexpr int kThreads = 256;

// float32's largest finite value, DLAG2S's RMAX (SLAMCH('O')), exact in double
constexpr double kRmax = static_cast<double>(FLT_MAX);
// DLAMCH('E') for double: 2^-53
constexpr double kEps = 1.1102230246251565e-16;

__device__ __forceinline__ bool out_of_range(double v) { return v < -kRmax || v > kRmax; }

// the bits of |v|: for non-negative doubles (a NaN's too) the bit patterns are
// ordered as the values, so atomicMax on them takes the largest
__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(v)));
}

// The block's sum of `v` in the fixed tree order; valid in thread 0.
__device__ double tree_sum(double v, double* part) {
  const int t = threadIdx.x;
  part[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) part[t] = rf::radd(part[t], part[t + h]);
    __syncthreads();
  }
  if (t < 32) {
    v = part[t];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) v = rf::radd(v, __shfl_down_sync(rf::kFull, v, h));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
mixed_narrow_kernel(const double* __restrict__ a, float* __restrict__ sa,
                    unsigned long long* __restrict__ anrm, int* __restrict__ overflow, int n) {
  __shared__ double part[kThreads];
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  double s = 0.0;
  bool big = false;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const double v = a[row + j];
    big |= out_of_range(v);
    sa[row + j] = __double2float_rn(v);
    s = rf::radd(s, fabs(v));
  }
  if (big) atomicOr(overflow, 1);
  s = tree_sum(s, part);
  if (threadIdx.x == 0) atomicMax(anrm, abs_bits(s));
}

// work: [0, k) max |r| bits, [k, 2k) max |x| bits, 2k the overflow flag of
// single(r), 2k + 1 the count of blocks done; zeroed before the launch.
// status: [state, steps]; state 0 refining, 1 converged, -2 an overflow in
// narrowing, -3 the float32 factorization failed, -(itermax + 1) not
// converged in itermax steps.  Only a pass whose state is 0 changes it.
__global__ void __launch_bounds__(kThreads)
mixed_residual_kernel(const double* __restrict__ a, const double* __restrict__ x,
                      const double* __restrict__ b, const double* __restrict__ anrm,
                      double* __restrict__ r, float* __restrict__ sr, int* __restrict__ status,
                      unsigned long long* work, int n, int k, int step, int itermax) {
  __shared__ double part[kThreads];
  __shared__ bool last;
  const int i = blockIdx.x, c = blockIdx.y;
  const size_t row = static_cast<size_t>(i) * n;
  double s = 0.0;
  for (int j = threadIdx.x; j < n; j += kThreads)
    s = rf::radd(s, rf::rmul(a[row + j], x[static_cast<size_t>(j) * k + c]));
  s = tree_sum(s, part);
  if (threadIdx.x == 0) {
    const size_t at = static_cast<size_t>(i) * k + c;
    const double ri = rf::rsub(b[at], s);
    r[at] = ri;
    sr[at] = __double2float_rn(ri);
    if (out_of_range(ri)) atomicOr(&work[2 * k], 1ull);
    atomicMax(&work[c], abs_bits(ri));
    atomicMax(&work[k + c], abs_bits(x[at]));
    __threadfence();
    const unsigned long long blocks = static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    last = atomicAdd(&work[2 * k + 1], 1ull) == blocks - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  int state = status[0], steps = status[1];
  if (state != 0) return;
  if (step) ++steps;
  const volatile unsigned long long* w = work;
  // LAPACK's CTE = ANRM * EPS * SQRT(N) * BWDMAX, BWDMAX = 1, in that order
  const double cte = rf::rmul(rf::rmul(rf::rmul(anrm[0], kEps), __dsqrt_rn(static_cast<double>(n))),
                              1.0);
  bool converged = true;
  for (int col = 0; col < k; ++col) {
    const double rnrm = __longlong_as_double(static_cast<long long>(w[col]));
    const double xnrm = __longlong_as_double(static_cast<long long>(w[k + col]));
    if (rnrm > rf::rmul(xnrm, cte)) converged = false;
  }
  if (converged) state = 1;
  else if (steps >= itermax) state = -(itermax + 1);
  else if (w[2 * k] != 0) state = -2;
  status[0] = state;
  status[1] = steps;
}

}  // namespace

extern "C" {

// single(a) into `sa` (both (n, n), contiguous), ||a||_inf into `anrm` (one
// double, zero before the call) and 1 into `overflow` (one int, zero before)
// where an entry lies beyond float32's range.  Returns a cudaError_t code (0 on
// success) for the launch; faults during the run surface at the next
// synchronisation.
int rf_mixed_narrow_f64(const void* a, void* sa, void* anrm, void* overflow, int n, int device,
                        void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  mixed_narrow_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<float*>(sa),
      static_cast<unsigned long long*>(anrm), static_cast<int*>(overflow), n);
  return static_cast<int>(cudaGetLastError());
}

// r = b - a x and sr = single(r) for a (n, n) and x, b, r, sr (n, k), all
// contiguous; the stopping test of `anrm` (one double) into `status` (two
// ints) as the kernel's comment says; `work` holds 2 k + 2 zeroed 64-bit words.
// `step` is 1 for a refinement step's pass (it counts in status[1]), 0 for the
// first solve's.
int rf_mixed_residual_f64(const void* a, const void* x, const void* b, const void* anrm, void* r,
                          void* sr, void* status, void* work, int n, int k, int step, int itermax,
                          int device, void* stream) {
  if (n < 0 || k < 1 || k > 65535 || itermax < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  mixed_residual_kernel<<<dim3(n, k), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(x), static_cast<const double*>(b),
      static_cast<const double*>(anrm), static_cast<double*>(r), static_cast<float*>(sr),
      static_cast<int*>(status), static_cast<unsigned long long*>(work), n, k, step, itermax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
