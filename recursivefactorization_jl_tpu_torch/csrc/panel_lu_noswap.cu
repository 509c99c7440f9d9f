// Physical-order (no row movement) LU of a full-height (m x w) panel on
// Hopper, for the blocked schedule `schedule='physical'`.
//
// Replaces the TPU kernel recursivefactorization_jl_tpu/ops/panel.py
// `_panel_kernel_noswap` (reached through `panel_factor_noswap_pallas`).  It
// computes the function of the package's plain version, ops/unblocked.py
// `unblocked_lu_noswap`.  Rows never move; a mask says which rows earlier
// panels and earlier steps have consumed.  Per elimination step k < min(m, w):
//   1. the pivot row prow[k] is the available row with the largest
//      |a[i, k]| (the smallest row among ties, a NaN wins over any number);
//      without pivoting it is the first available row;
//   2. the row is marked used and stays where it is: it keeps row k of U in
//      the columns k.. and its multipliers before them;
//   3. the rows still available are scaled in column k by r = 1/p, computed
//      once, and take the rank-1 update a[i, j] -= l[i] * u[j], j > k; rows
//      consumed before are neither searched nor touched;
//   4. a zero pivot means no scale, the update still runs with the unscaled
//      column, and the column still consumes its row; info is the first
//      1-based such step, negated without pivoting;
//   5. with no row left to take, prow[k] = -1 and the step does nothing.
// Every product and difference is rounded on its own (__fmul_rn, __fsub_rn,
// -fmad=false), so the factors agree bitwise with the plain version.
//
// Design.  The row split of csrc/panel_lu.cu with the mask in place of the
// swap: a cooperative grid of up to one thread block per SM, block b owns
// rows [b*R, (b+1)*R) whatever their state, ONE grid barrier per step
// (candidates published, then every block reduces them to the same winner
// and updates its own available rows from the winner's row).  Nothing is
// written outside a block's own rows, so no second exchange (row k, perm
// ids) is needed.  The split does not assume that the live rows are the
// bottom ones: a block whose rows are all consumed publishes the empty
// candidate and skips the update.  The TPU kernel's micro blocks, its
// transposed shadow, the one-hot row extraction and the repeated-squaring
// inverse answer the TPU's lane layout and are not carried over; this kernel
// is unblocked.
//
// What bounds it.  The serial pivot chain (w steps of reduction, barrier,
// reduction, dependent L2 round trips), as in csrc/panel_lu.cu; bytes and
// operations are a few microseconds at the card's rates.

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

template <typename T>
struct NoswapArgs {
  T* a;              // panel, row-major with row stride lda (unit column stride)
  int m, w, lda;
  int pivot;
  const int* used0;  // (m,)  nonzero: consumed by an earlier panel
  int* used;         // (m,)  out: used0 and this panel's pivot rows, as 0/1
  int* prow;         // (min(m, w),)  pivot row of each step, -1: none left
  int* info;         // (1,)
  T* cand_val;       // [2][G]     |candidate| per block
  T* cand_row;       // [2][G][w]  candidate rows
  int* cand_idx;     // [2][G]     candidate row index
  int rows;          // rows per block
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_lu_noswap_kernel(NoswapArgs<T> p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* urow = reinterpret_cast<T*>(smem_raw);  // winner row, w entries
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
  int info = 0;  // kept by block 0, thread 0

  for (int i = r0 + tid; i < r1; i += kThreads) p.used[i] = p.used0[i] != 0;
  __syncthreads();

  for (int k = 0; k < minmn; ++k) {
    const int par = k & 1;
    T* cval = p.cand_val + par * G;
    int* cidx = p.cand_idx + par * G;
    T* crow = p.cand_row + static_cast<size_t>(par) * G * w;

    // ---- phase A: publish the local candidate --------------------------
    {
      T best = T(-1);
      int bi = INT_MAX;
      for (int i = r0 + tid; i < r1; i += kThreads) {
        if (p.used[i]) continue;
        // without pivoting every available row weighs the same and the
        // smallest row wins
        const T v = p.pivot ? mag(p.a[i * lda + k]) : T(0);
        if (better(v, i, best, bi)) { best = v; bi = i; }
      }
      block_best<kWarps>(best, bi, red_val, red_idx);
      if (tid == 0) {
        cval[b] = best;
        cidx[b] = bi;
        s_kp = bi;
      }
      __syncthreads();
      const int ci = s_kp;
      if (ci != INT_MAX) {
        const T* src = p.a + ci * lda;
        T* dst = crow + static_cast<size_t>(b) * w;
        for (int j = tid; j < w; j += kThreads) dst[j] = src[j];
      }
    }

    grid.sync();

    // ---- phase B: agree on the pivot row, scale, update -----------------
    if (warp == 0) {
      T best = T(-1);
      int bi = INT_MAX, bb = -1;
      for (int g = lane; g < G; g += 32) {
        const T v = __ldcg(cval + g);
        const int i = __ldcg(cidx + g);
        if (better(v, i, best, bi)) { best = v; bi = i; bb = g; }
      }
      warp_best(best, bi, bb);
      if (lane == 0) { s_kp = bi; s_src = bb; }
    }
    __syncthreads();
    const int kp = s_kp;
    if (kp == INT_MAX) {  // no row left: uniform over the grid
      if (b == 0 && tid == 0) p.prow[k] = -1;
      __syncthreads();
      continue;
    }
    const T* u = crow + static_cast<size_t>(s_src) * w;
    for (int j = tid; j < w; j += kThreads) urow[j] = __ldcg(u + j);
    if (tid == 0 && kp >= r0 && kp < r1) p.used[kp] = 1;
    __syncthreads();

    const T pv = urow[k];
    const bool nz = pv != T(0);
    if (b == 0 && tid == 0) {
      p.prow[k] = kp;
      if (!nz && info == 0) info = p.pivot ? k + 1 : -(k + 1);
    }
    const T r = nz ? rrcp(pv) : T(1);
    for (int i = r0 + warp; i < r1; i += kWarps) {
      if (p.used[i]) continue;  // uniform over the warp
      T* row = p.a + i * lda;
      T l = T(0);
      if (lane == 0) {
        l = row[k];
        if (nz) {
          l = rmul(l, r);
          row[k] = l;
        }
      }
      l = __shfl_sync(kFull, l, 0);
      for (int j = k + 1 + lane; j < w; j += 32) {
        row[j] = rsub(row[j], rmul(l, urow[j]));
      }
    }
    __syncthreads();
  }
  if (b == 0 && tid == 0) *p.info = info;
}

template <typename T>
int grid_for(int m, int w, int device, int* grid_out, int* rows_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(w) * sizeof(T);
  err = opt_in_smem(reinterpret_cast<const void*>(panel_lu_noswap_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, panel_lu_noswap_kernel<T>, kThreads, smem);
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
int launch(void* a, int m, int w, int lda, int pivot, const void* used0,
           void* used, void* prow, void* info, void* ws, void* iws, int grid,
           int device, void* stream) {
  int g = 0, rows = 0;
  int err = grid_for<T>(m, w, device, &g, &rows);
  if (err != 0) return err;
  if (g != grid) return static_cast<int>(cudaErrorInvalidValue);
  NoswapArgs<T> p;
  p.a = static_cast<T*>(a);
  p.m = m;
  p.w = w;
  p.lda = lda;
  p.pivot = pivot;
  p.used0 = static_cast<const int*>(used0);
  p.used = static_cast<int*>(used);
  p.prow = static_cast<int*>(prow);
  p.info = static_cast<int*>(info);
  T* f = static_cast<T*>(ws);
  p.cand_val = f;
  p.cand_row = f + 2 * static_cast<size_t>(g);
  p.cand_idx = static_cast<int*>(iws);
  p.rows = rows;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_lu_noswap_kernel<T>), dim3(g),
      dim3(kThreads), args, static_cast<size_t>(w) * sizeof(T),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Grid size of a launch on an (m, w) panel of elements of `elem_size`
// bytes (4 or 8); the caller sizes the workspaces from it:
//   ws  (elements of the panel's type): 2*G + 2*G*w
//   iws (int32):                        2*G
// Returns G >= 1, or minus a cudaError_t code.
int rf_panel_lu_noswap_grid(int m, int w, int elem_size, int device) {
  int g = 0, rows = 0;
  const int err = elem_size == 8 ? grid_for<double>(m, w, device, &g, &rows)
                                 : grid_for<float>(m, w, device, &g, &rows);
  return err != 0 ? -err : g;
}

// Factor the panel in place on `stream`; `used0` and `used` are int32 (m,)
// and may not overlap.  Returns a cudaError_t code (0 on success) for the
// launch; faults during the run surface at the next synchronisation.
int rf_panel_lu_noswap_f32(void* a, int m, int w, int lda, int pivot,
                           const void* used0, void* used, void* prow,
                           void* info, void* ws, void* iws, int grid,
                           int device, void* stream) {
  return launch<float>(a, m, w, lda, pivot, used0, used, prow, info, ws, iws,
                       grid, device, stream);
}

int rf_panel_lu_noswap_f64(void* a, int m, int w, int lda, int pivot,
                           const void* used0, void* used, void* prow,
                           void* info, void* ws, void* iws, int grid,
                           int device, void* stream) {
  return launch<double>(a, m, w, lda, pivot, used0, used, prow, info, ws, iws,
                        grid, device, stream);
}

}  // extern "C"
