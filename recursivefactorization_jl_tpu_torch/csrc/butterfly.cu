// The depth-2 random butterfly transform A~ = U^T A V of the RBT solver
// (models/butterfly.py `butterfly_mul`), in one launch.
//
// It replaces no TPU kernel: the JAX package applies the transform as plain
// XLA, which fuses the quadrant sums, scales and concatenations of its two
// levels.  The port's tensor code runs them as some hundred kernels and
// about thirty passes over the n x n matrix; this kernel reads A once and
// writes A~ once.
//
// The two levels mix each element with at most fifteen others: with
// q = n / 4 and h = n / 2, level 2 (the four h x h quadrants, each a
// butterfly on its own) mixes rows {i, q + i} with columns {j, q + j} of a
// quadrant, and level 1 (the whole matrix) rows {x, h + x} with columns
// {y, h + y}.  So rows {i, q + i, h + i, h + q + i} by columns
// {j, q + j, h + j, h + q + j} form a closed group of 16 elements.  A thread
// holds V such groups (V consecutive j, read and written as one vector per
// row and column quarter), applies level 2 and then level 1 in registers, and
// writes the 16 V results back to the same positions of `out`.
//
// Arithmetic: the operation order of `butterfly_level` applied at level 2 and
// then at level 1, each sum, difference and product rounded on its own
// (rf::radd / rsub / rmul, built with -fmad=false), so the result is bit for
// bit the tensor code's:
//   T1 = A11 + A12, T2 = A21 + A22, T3 = A11 - A12, T4 = A21 - A22,
//   C11 = (u1 * (T1 + T2)) * v1, C21 = (u2 * (T1 - T2)) * v1,
//   C12 = (u1 * (T3 + T4)) * v2, C22 = (u2 * (T3 - T4)) * v2.
//
// Bound: bytes.  A read once and A~ written once, 2 n^2 elements (128 MiB at
// n = 4096 in float32, 40 us at 3.35 TB/s), beside 8 n^2 operations (2 us at
// 67 TFLOP/s); the butterfly values (4n) stay in L1/L2.

#include "rf_common.cuh"

namespace {

constexpr int kThreads = 256;

// V consecutive elements, loaded and stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
butterfly_depth2_kernel(const T* __restrict__ a, T* __restrict__ out, const T* __restrict__ uv,
                        int n) {
  using rf::radd;
  using rf::rmul;
  using rf::rsub;
  const int q = n >> 2, h = n >> 1, qv = q / V;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(q) * qv) return;
  const int i = static_cast<int>(t / qv);
  const int j = static_cast<int>(t - static_cast<long long>(i) * qv) * V;

  // x[r][c][k]: row quarter r (row (r >> 1) h + (r & 1) q + i), column
  // quarter c (column (c >> 1) h + (c & 1) q + j + k)
  T x[4][4][V];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = static_cast<size_t>((r >> 1) * h + (r & 1) * q + i) * n;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Pack<T, V> p =
          *reinterpret_cast<const Pack<T, V>*>(a + row + (c >> 1) * h + (c & 1) * q + j);
#pragma unroll
      for (int k = 0; k < V; ++k) x[r][c][k] = p.v[k];
    }
  }

  // level 2: quadrant (R, C) by the values U_R = uv[R n : R n + h] and
  // V_C = uv[h + C n : h + C n + h]
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    const T u1 = uv[R * n + i], u2 = uv[R * n + q + i];
#pragma unroll
    for (int C = 0; C < 2; ++C) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T v1 = uv[h + C * n + j + k], v2 = uv[h + C * n + q + j + k];
        const T a11 = x[2 * R][2 * C][k], a12 = x[2 * R][2 * C + 1][k];
        const T a21 = x[2 * R + 1][2 * C][k], a22 = x[2 * R + 1][2 * C + 1][k];
        const T t1 = radd(a11, a12), t2 = radd(a21, a22);
        const T t3 = rsub(a11, a12), t4 = rsub(a21, a22);
        x[2 * R][2 * C][k] = rmul(rmul(u1, radd(t1, t2)), v1);
        x[2 * R + 1][2 * C][k] = rmul(rmul(u2, rsub(t1, t2)), v1);
        x[2 * R][2 * C + 1][k] = rmul(rmul(u1, radd(t3, t4)), v2);
        x[2 * R + 1][2 * C + 1][k] = rmul(rmul(u2, rsub(t3, t4)), v2);
      }
    }
  }

  // level 1: the whole matrix by uv[2n : 3n] and uv[3n : 4n]; the element
  // at row quarter r sits in half r >> 1 at offset (r & 1) q + i
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const T u1 = uv[2 * n + s * q + i], u2 = uv[2 * n + h + s * q + i];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T v1 = uv[3 * n + e * q + j + k], v2 = uv[3 * n + h + e * q + j + k];
        const T a11 = x[s][e][k], a12 = x[s][2 + e][k];
        const T a21 = x[2 + s][e][k], a22 = x[2 + s][2 + e][k];
        const T t1 = radd(a11, a12), t2 = radd(a21, a22);
        const T t3 = rsub(a11, a12), t4 = rsub(a21, a22);
        x[s][e][k] = rmul(rmul(u1, radd(t1, t2)), v1);
        x[2 + s][e][k] = rmul(rmul(u2, rsub(t1, t2)), v1);
        x[s][2 + e][k] = rmul(rmul(u1, radd(t3, t4)), v2);
        x[2 + s][2 + e][k] = rmul(rmul(u2, rsub(t3, t4)), v2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = static_cast<size_t>((r >> 1) * h + (r & 1) * q + i) * n;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Pack<T, V> p;
#pragma unroll
      for (int k = 0; k < V; ++k) p.v[k] = x[r][c][k];
      *reinterpret_cast<Pack<T, V>*>(out + row + (c >> 1) * h + (c & 1) * q + j) = p;
    }
  }
}

// The widest vector of `cap` elements or fewer that divides q and to which
// both matrices are aligned.
int vector_width(const void* a, const void* out, int q, int cap, size_t item) {
  for (int v = cap; v > 1; v >>= 1) {
    const size_t bytes = item * v;
    if (q % v == 0 && reinterpret_cast<size_t>(a) % bytes == 0 &&
        reinterpret_cast<size_t>(out) % bytes == 0)
      return v;
  }
  return 1;
}

template <typename T, int V>
cudaError_t launch_v(const T* a, T* out, const T* uv, int n, cudaStream_t stream) {
  const long long q = n / 4, threads = q * (q / V);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  butterfly_depth2_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, out, uv, n);
  return cudaGetLastError();
}

// 16-byte accesses: four floats or two doubles a row and column quarter.
template <typename T>
int launch(const void* a, void* out, const void* uv, int n, int device, void* stream,
           int* width) {
  if (n < 0 || n % 4 != 0 || a == out) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v = vector_width(a, out, n / 4, 16 / static_cast<int>(sizeof(T)), sizeof(T));
  if (width != nullptr) *width = v;
  if (n == 0) return 0;
  const T* pa = static_cast<const T*>(a);
  T* po = static_cast<T*>(out);
  const T* pu = static_cast<const T*>(uv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (v == 4) return static_cast<int>(launch_v<T, 4>(pa, po, pu, n, s));
  }
  if (v == 2) err = launch_v<T, 2>(pa, po, pu, n, s);
  else err = launch_v<T, 1>(pa, po, pu, n, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// out = U^T a V for the contiguous (n, n) matrix `a` and the 4n butterfly
// values `uv` (both of the entry point's type), n a multiple of 4; `out` is
// another (n, n) buffer.  `width`, when not null, receives the elements a
// thread reads per access (1, 2 or 4 by alignment and n).  Returns a
// cudaError_t code (0 on success) for the launch; faults during the run
// surface at the next synchronisation.
int rf_butterfly_depth2_f32(const void* a, void* out, const void* uv, int n, int* width,
                            int device, void* stream) {
  return launch<float>(a, out, uv, n, device, stream, width);
}

int rf_butterfly_depth2_f64(const void* a, void* out, const void* uv, int n, int* width,
                            int device, void* stream) {
  return launch<double>(a, out, uv, n, device, stream, width);
}

}  // extern "C"
