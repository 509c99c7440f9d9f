// Partial-pivot LU of a tall (m x w) complex panel, or of a whole complex
// matrix, on Hopper: complex64 and complex128, in place on interleaved
// (re, im) storage.
//
// Replaces the TPU kernel recursivefactorization_jl_tpu/ops/panel.py
// `_panel_kernel_fori_c64` (reached through `panel_factor_pallas_c64`).  It
// computes the same function as the package's plain version,
// ops/unblocked.py `unblocked_lu_cabs1`: per elimination step k
//   1. pivot by CABS1: c[i] = |re a[i, k]| + |im a[i, k]| over rows i >= k,
//      kp = the smallest row with c[i] == max c.  When a candidate is NaN the
//      maximum is NaN, no row equals it, and kp = m - 1 (the TPU kernel's
//      max / equality / clamp formulation);
//   2. rows k and kp swap across the panel's w columns, only when the pivot
//      is nonzero (re != 0 or im != 0) and kp != k; the composed row
//      permutation swaps with them;
//   3. the column below the diagonal is multiplied by conj(p) / |p|^2:
//      d = pr*pr + pi*pi, ir = pr/d, ii = -pi/d,
//      re' = re*ir - im*ii, im' = re*ii + im*ir;
//   4. complex rank-1 update for i > k, j > k (it still runs after a zero
//      pivot, with the unscaled column):
//      a_re -= l_re*u_re - l_im*u_im,  a_im -= l_re*u_im + l_im*u_re;
//   5. info is the first 1-based zero-pivot step, negated without pivoting.
// Every product, sum, difference and quotient is rounded on its own (the
// __f*_rn / __d*_rn intrinsics, and -fmad=false at build time), in the order
// written above, so the factors agree bitwise with the plain version, which
// spends one tensor op per rounding on the two planes.
//
// Limit shared with the TPU kernel: d = |p|^2 overflows or underflows for a
// pivot whose magnitude is beyond the square root of the type's range, where
// LAPACK's cladiv would still divide safely.
//
// What is not carried over from the TPU kernel: the split into two f32
// planes, the transposed (micro + 1, m) shadows, `micro`, `unroll` and the
// 4-matmul boundary Schur.  They answer Mosaic (no complex type, the lane
// layout); here a thread loads and stores one (re, im) pair at a time.
//
// Design: that of panel_lu.cu with a complex element.  The panel is split by
// rows over a cooperative grid of up to one block per SM; block b owns rows
// [b*R, (b+1)*R) and is the only block that reads or writes them.  Each step
// has ONE grid-wide barrier:
//   phase A  every block finds its local candidate and publishes (CABS1
//            value, row, perm id, the full candidate row); the owner of row
//            k publishes row k, the owner of row m - 1 publishes that row
//            (the pivot row when a NaN is among the candidates);
//                                                       -- grid.sync() --
//   phase B  every block reduces the candidates to the same winner, the
//            owners of rows k and kp write the swapped rows, and every block
//            scales and updates its own rows from the winner's row.
// The exchange buffers are double-buffered by step parity: a block can only
// reach step k+2 after every block has left step k's phase B.
//
// What bounds it: as for the real kernel, the serial pivot chain (w steps of
// a block reduction, a grid barrier, a second reduction and dependent L2
// round trips), not bytes or operations; PERF.md has its time per step.  A
// later change would keep the slab in shared memory and delay micro-block
// updates onto the tensor cores, as the note in panel_lu.cu says.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "rf_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMin = 8;  // fewest rows a block owns

// The (re, im) pair of a real type: .x is the real part, .y the imaginary.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T>
struct PanelArgs {
  using C = typename Pair<T>::type;
  C* a;           // panel, row-major with row stride lda (in complex elements)
  int m, w, lda;
  int pivot;
  int* piv;       // (min(m, w),)  0-based pivot row of each step
  int* perm;      // (m,)          composed row permutation
  int* info;      // (1,)
  C* cand_row;    // [2][G][w]     candidate rows
  C* krow;        // [2][w]        row k before the swap
  C* lrow;        // [2][w]        row m - 1 before the swap
  T* cand_val;    // [2][G]        CABS1 of each block's candidate
  int* cand_idx;  // [2][G]        candidate row index
  int* cand_pid;  // [2][G]        perm id travelling with the candidate row
  int* kpid;      // [2]           perm id of row k
  int* lpid;      // [2]           perm id of row m - 1
  int rows;       // rows per block
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_lu_c_kernel(PanelArgs<T> p) {
  using C = typename Pair<T>::type;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* urow = reinterpret_cast<C*>(smem_raw);  // winner row, w entries
  __shared__ T red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_kp, s_src;

  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = p.m, w = p.w;
  const size_t lda = static_cast<size_t>(p.lda);
  const int minmn = m < w ? m : w;
  const int r0 = b * p.rows;
  const int r1 = min(m, r0 + p.rows);
  const bool own_last = m - 1 >= r0 && m - 1 < r1;
  int info = 0;  // kept by block 0, thread 0

  for (int i = r0 + tid; i < r1; i += kThreads) p.perm[i] = i;
  __syncthreads();

  for (int k = 0; k < minmn; ++k) {
    const int par = k & 1;
    T* cval = p.cand_val + par * G;
    int* cidx = p.cand_idx + par * G;
    int* cpid = p.cand_pid + par * G;
    C* crow = p.cand_row + static_cast<size_t>(par) * G * w;
    C* krow = p.krow + static_cast<size_t>(par) * w;
    C* lrow = p.lrow + static_cast<size_t>(par) * w;
    const bool own_k = k >= r0 && k < r1;

    // ---- phase A: publish the local candidate, row k and row m - 1 ------
    if (p.pivot) {
      T best = T(-1);
      int bi = INT_MAX;
      for (int i = max(k, r0) + tid; i < r1; i += kThreads) {
        const C e = p.a[i * lda + k];
        const T v = radd(mag(e.x), mag(e.y));
        if (better(v, i, best, bi)) { best = v; bi = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(kFull, best, off);
        const int oi = __shfl_down_sync(kFull, bi, off);
        if (better(ov, oi, best, bi)) { best = ov; bi = oi; }
      }
      if (lane == 0) { red_val[warp] = best; red_idx[warp] = bi; }
      __syncthreads();
      if (warp == 0) {
        best = lane < kWarps ? red_val[lane] : T(-1);
        bi = lane < kWarps ? red_idx[lane] : INT_MAX;
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_down_sync(kFull, best, off);
          const int oi = __shfl_down_sync(kFull, bi, off);
          if (better(ov, oi, best, bi)) { best = ov; bi = oi; }
        }
        if (lane == 0) {
          cval[b] = best;  // NaN when any local candidate is NaN
          cidx[b] = bi;
          cpid[b] = bi == INT_MAX ? -1 : p.perm[bi];
          s_kp = bi;
        }
      }
      __syncthreads();
      const int ci = s_kp;
      if (ci != INT_MAX) {
        const C* src = p.a + ci * lda;
        C* dst = crow + static_cast<size_t>(b) * w;
        for (int j = tid; j < w; j += kThreads) dst[j] = src[j];
      }
      if (own_last) {
        const C* src = p.a + (m - 1) * lda;
        for (int j = tid; j < w; j += kThreads) lrow[j] = src[j];
        if (tid == 0) p.lpid[par] = p.perm[m - 1];
      }
    }
    if (own_k) {
      const C* src = p.a + k * lda;
      for (int j = tid; j < w; j += kThreads) krow[j] = src[j];
      if (tid == 0) p.kpid[par] = p.perm[k];
    }

    grid.sync();

    // ---- phase B: agree on the pivot, swap, scale, update ---------------
    if (p.pivot) {
      if (warp == 0) {
        T best = T(-1);
        int bi = INT_MAX, bb = -1;
        for (int g = lane; g < G; g += 32) {
          const T v = __ldcg(cval + g);
          const int i = __ldcg(cidx + g);
          if (better(v, i, best, bi)) { best = v; bi = i; bb = g; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_down_sync(kFull, best, off);
          const int oi = __shfl_down_sync(kFull, bi, off);
          const int ob = __shfl_down_sync(kFull, bb, off);
          if (better(ov, oi, best, bi)) { best = ov; bi = oi; bb = ob; }
        }
        if (lane == 0) {
          // a NaN maximum equals no candidate: the pivot row is m - 1
          const bool none = isnan(best);
          s_kp = none ? m - 1 : bi;
          s_src = none ? -1 : bb;
        }
      }
      __syncthreads();
    }
    const int kp = p.pivot ? s_kp : k;
    const int src_block = p.pivot ? s_src : 0;
    const C* u = !p.pivot ? krow
                 : src_block < 0 ? lrow
                                 : crow + static_cast<size_t>(src_block) * w;
    for (int j = tid; j < w; j += kThreads) urow[j] = __ldcg(u + j);
    __syncthreads();

    const C pv = urow[k];
    const bool nz = pv.x != T(0) || pv.y != T(0);
    const bool do_swap = nz && kp != k;
    if (do_swap) {
      if (own_k) {
        C* dst = p.a + k * lda;
        for (int j = tid; j < w; j += kThreads) dst[j] = urow[j];
        if (tid == 0) {
          p.perm[k] = src_block < 0 ? __ldcg(p.lpid + par)
                                    : __ldcg(cpid + src_block);
        }
      }
      if (kp >= r0 && kp < r1) {
        C* dst = p.a + kp * lda;
        for (int j = tid; j < w; j += kThreads) dst[j] = __ldcg(krow + j);
        if (tid == 0) p.perm[kp] = __ldcg(p.kpid + par);
      }
    }
    if (b == 0 && tid == 0) {
      p.piv[k] = kp;
      if (!nz && info == 0) info = p.pivot ? k + 1 : -(k + 1);
    }
    __syncthreads();

    // 1/p = conj(p) / |p|^2 = ir + i*ii
    T ir = T(0), ii = T(0);
    if (nz) {
      const T d = radd(rmul(pv.x, pv.x), rmul(pv.y, pv.y));
      ir = rdiv(pv.x, d);
      ii = rdiv(-pv.y, d);
    }
    for (int i = max(k + 1, r0) + warp; i < r1; i += kWarps) {
      C* row = p.a + i * lda;
      T lx = T(0), ly = T(0);
      if (lane == 0) {
        C l = row[k];
        if (nz) {
          const T sx = rsub(rmul(l.x, ir), rmul(l.y, ii));
          const T sy = radd(rmul(l.x, ii), rmul(l.y, ir));
          l.x = sx;
          l.y = sy;
          row[k] = l;
        }
        lx = l.x;
        ly = l.y;
      }
      lx = __shfl_sync(kFull, lx, 0);
      ly = __shfl_sync(kFull, ly, 0);
      for (int j = k + 1 + lane; j < w; j += 32) {
        C a = row[j];
        const C uj = urow[j];
        a.x = rsub(a.x, rsub(rmul(lx, uj.x), rmul(ly, uj.y)));
        a.y = rsub(a.y, radd(rmul(lx, uj.y), rmul(ly, uj.x)));
        row[j] = a;
      }
    }
    __syncthreads();
  }
  if (b == 0 && tid == 0) *p.info = info;
}

template <typename T>
int grid_for(int m, int w, int device, int* grid_out, int* rows_out) {
  using C = typename Pair<T>::type;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(w) * sizeof(C);
  err = opt_in_smem(reinterpret_cast<const void*>(panel_lu_c_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, panel_lu_c_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int g = sms;  // one block per SM at most: the barrier is the cost
  const int by_rows = (m + kRowsMin - 1) / kRowsMin;
  if (by_rows < g) g = by_rows;
  if (g < 1) g = 1;
  const int rows = (m + g - 1) / g;
  *rows_out = rows;
  *grid_out = (m + rows - 1) / rows;
  return 0;
}

template <typename T>
int launch(void* a, int m, int w, int lda, int pivot, void* piv, void* perm,
           void* info, void* ws, void* iws, int grid, int device,
           void* stream) {
  using C = typename Pair<T>::type;
  int g = 0, rows = 0;
  int err = grid_for<T>(m, w, device, &g, &rows);
  if (err != 0) return err;
  if (g != grid) return static_cast<int>(cudaErrorInvalidValue);
  PanelArgs<T> p;
  p.a = static_cast<C*>(a);
  p.m = m;
  p.w = w;
  p.lda = lda;
  p.pivot = pivot;
  p.piv = static_cast<int*>(piv);
  p.perm = static_cast<int*>(perm);
  p.info = static_cast<int*>(info);
  // the pairs first: they need the alignment of two reals
  C* c = static_cast<C*>(ws);
  p.cand_row = c;
  p.krow = p.cand_row + 2 * static_cast<size_t>(g) * w;
  p.lrow = p.krow + 2 * static_cast<size_t>(w);
  p.cand_val = reinterpret_cast<T*>(p.lrow + 2 * static_cast<size_t>(w));
  int* iw = static_cast<int*>(iws);
  p.cand_idx = iw;
  p.cand_pid = iw + 2 * g;
  p.kpid = iw + 4 * g;
  p.lpid = iw + 4 * g + 2;
  p.rows = rows;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_lu_c_kernel<T>), dim3(g), dim3(kThreads),
      args, static_cast<size_t>(w) * sizeof(C),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Grid size of a launch on an (m, w) complex panel whose real and imaginary
// parts have `real_size` bytes each (4: complex64, 8: complex128); the caller
// sizes the workspaces from it:
//   ws  (reals of the panel's type): 4*G*w + 8*w + 2*G
//   iws (int32):                     4*G + 4
// Returns G >= 1, or minus a cudaError_t code.
int rf_panel_lu_c_grid(int m, int w, int real_size, int device) {
  int g = 0, rows = 0;
  const int err = real_size == 8 ? grid_for<double>(m, w, device, &g, &rows)
                                 : grid_for<float>(m, w, device, &g, &rows);
  return err != 0 ? -err : g;
}

// Factor the panel in place on `stream`; `a` points at interleaved (re, im)
// pairs and `lda` counts complex elements.  Returns a cudaError_t code (0 on
// success) for the launch; faults during the run surface at the next
// synchronisation.
int rf_panel_lu_c64(void* a, int m, int w, int lda, int pivot, void* piv,
                    void* perm, void* info, void* ws, void* iws, int grid,
                    int device, void* stream) {
  return launch<float>(a, m, w, lda, pivot, piv, perm, info, ws, iws, grid,
                       device, stream);
}

int rf_panel_lu_c128(void* a, int m, int w, int lda, int pivot, void* piv,
                     void* perm, void* info, void* ws, void* iws, int grid,
                     int device, void* stream) {
  return launch<double>(a, m, w, lda, pivot, piv, perm, info, ws, iws, grid,
                        device, stream);
}

}  // extern "C"
