// Partial-pivot LU of a tall (m x w) panel, or of a whole matrix, on Hopper.
//
// Replaces the TPU kernel recursivefactorization_jl_tpu/ops/panel.py
// `_panel_kernel_fori` (variants fori / fori2 / fori3, reached through
// `panel_factor_pallas`).  It computes the same function as the package's
// plain version, ops/unblocked.py `unblocked_lu`: per elimination step k
//   1. first-occurrence argmax of |a[i, k]| over rows i >= k (the largest
//      magnitude, the smallest row among ties; a NaN wins over any number);
//   2. rows k and kp swap across the panel's w columns, only when the pivot
//      is nonzero and kp != k; the composed row permutation swaps with them;
//   3. the column below the diagonal is scaled by r = 1/p, computed once;
//   4. rank-1 update a[i, j] = a[i, j] - l[i] * u[j] for i > k, j > k
//      (it still runs after a zero pivot, with the unscaled column);
//   5. info is the first 1-based zero-pivot step, negated without pivoting.
// Every product and difference is rounded on its own (__fmul_rn, __fsub_rn,
// and -fmad=false at build time), so the factors agree bitwise with the
// plain version's `A - outer(l, u)` and one near-tie cannot flip a pivot.
//
// Design.  The TPU kernel keeps the whole panel in VMEM (up to 100 MiB).  An
// SM has at most 227 KB of shared memory, and one SM alone would stream the
// panel through L2 once per step (a 4096 x 128 f32 panel is 2 MiB; its 128
// rank-1 updates move ~0.26 GB through a single SM's L2 port).  So the panel
// is split by rows over a cooperative grid of up to one block per SM: block b
// owns rows [b*R, (b+1)*R) and is the only block that reads or writes them.
// The panel stays in device memory, where L2 holds it.  Each step has ONE
// grid-wide barrier:
//   phase A  every block finds its local pivot candidate and publishes
//            (|value|, row, perm id, the full candidate row); the owner of
//            row k publishes row k;                     -- grid.sync() --
//   phase B  every block reduces the candidates to the same winner, the
//            owners of rows k and kp write the swapped rows, and every block
//            scales and updates its own rows from the winner's row.
// The exchange buffers are double-buffered by step parity: a block can only
// reach step k+2 after every block has left step k's phase B.
//
// What bounds it.  Not bytes or FLOPs (a 4096 x 128 f32 panel needs ~4 MB
// of traffic and ~66 MFLOP, a few microseconds at the card's rates) but
// the serial pivot chain: w steps, each a block reduction, a grid barrier,
// a second reduction, several __syncthreads and dependent L2 round trips.
// The work per step is spread over all SMs, so the chain's latency is what
// a launch costs (6-8 us per step on an H100, PERF.md).
//
// A later PR would: keep the slab in shared memory where m*w*4 fits
// (~200 KB per block, with clusters for the exchange instead of L2), fuse
// the next step's candidate search into the current update, and delay
// micro-block updates (rank-b tiles on the tensor cores with the bitwise
// contract relaxed to a stated tolerance) so that only the narrow pivot
// chain stays serial.

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
struct PanelArgs {
  T* a;           // panel, row-major with row stride lda (unit column stride)
  int m, w, lda;
  int pivot;
  int* piv;       // (min(m, w),)  0-based pivot row of each step
  int* perm;      // (m,)          composed row permutation
  int* info;      // (1,)
  T* cand_val;    // [2][G]        |candidate| per block
  T* cand_row;    // [2][G][w]     candidate rows
  T* krow;        // [2][w]        row k before the swap
  int* cand_idx;  // [2][G]        candidate row index
  int* cand_pid;  // [2][G]        perm id travelling with the candidate row
  int* kpid;      // [2]           perm id of row k
  int rows;       // rows per block
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_lu_kernel(PanelArgs<T> p) {
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

  for (int i = r0 + tid; i < r1; i += kThreads) p.perm[i] = i;
  __syncthreads();

  for (int k = 0; k < minmn; ++k) {
    const int par = k & 1;
    T* cval = p.cand_val + par * G;
    int* cidx = p.cand_idx + par * G;
    int* cpid = p.cand_pid + par * G;
    T* crow = p.cand_row + static_cast<size_t>(par) * G * w;
    T* krow = p.krow + static_cast<size_t>(par) * w;
    const bool own_k = k >= r0 && k < r1;

    // ---- phase A: publish the local candidate and row k ----------------
    if (p.pivot) {
      T best = T(-1);
      int bi = INT_MAX;
      for (int i = max(k, r0) + tid; i < r1; i += kThreads) {
        const T v = mag(p.a[i * lda + k]);
        if (better(v, i, best, bi)) { best = v; bi = i; }
      }
      block_best<kWarps>(best, bi, red_val, red_idx);
      if (tid == 0) {
        cval[b] = best;
        cidx[b] = bi;
        cpid[b] = bi == INT_MAX ? -1 : p.perm[bi];
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
    if (own_k) {
      const T* src = p.a + k * lda;
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
        warp_best(best, bi, bb);
        if (lane == 0) { s_kp = bi; s_src = bb; }
      }
      __syncthreads();
    }
    const int kp = p.pivot ? s_kp : k;
    const T* u = p.pivot ? crow + static_cast<size_t>(s_src) * w : krow;
    for (int j = tid; j < w; j += kThreads) urow[j] = __ldcg(u + j);
    __syncthreads();

    const T pv = urow[k];
    const bool nz = pv != T(0);
    const bool do_swap = nz && kp != k;
    if (do_swap) {
      if (own_k) {
        T* dst = p.a + k * lda;
        for (int j = tid; j < w; j += kThreads) dst[j] = urow[j];
        if (tid == 0) p.perm[k] = __ldcg(cpid + s_src);
      }
      if (kp >= r0 && kp < r1) {
        T* dst = p.a + kp * lda;
        for (int j = tid; j < w; j += kThreads) dst[j] = __ldcg(krow + j);
        if (tid == 0) p.perm[kp] = __ldcg(p.kpid + par);
      }
    }
    if (b == 0 && tid == 0) {
      p.piv[k] = kp;
      if (!nz && info == 0) info = p.pivot ? k + 1 : -(k + 1);
    }
    __syncthreads();

    const T r = nz ? rrcp(pv) : T(1);
    for (int i = max(k + 1, r0) + warp; i < r1; i += kWarps) {
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
  err = opt_in_smem(reinterpret_cast<const void*>(panel_lu_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, panel_lu_kernel<T>, kThreads, smem);
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
  int g = 0, rows = 0;
  int err = grid_for<T>(m, w, device, &g, &rows);
  if (err != 0) return err;
  if (g != grid) return static_cast<int>(cudaErrorInvalidValue);
  PanelArgs<T> p;
  p.a = static_cast<T*>(a);
  p.m = m;
  p.w = w;
  p.lda = lda;
  p.pivot = pivot;
  p.piv = static_cast<int*>(piv);
  p.perm = static_cast<int*>(perm);
  p.info = static_cast<int*>(info);
  T* f = static_cast<T*>(ws);
  p.cand_val = f;
  p.cand_row = f + 2 * static_cast<size_t>(g);
  p.krow = p.cand_row + 2 * static_cast<size_t>(g) * w;
  int* iw = static_cast<int*>(iws);
  p.cand_idx = iw;
  p.cand_pid = iw + 2 * g;
  p.kpid = iw + 4 * g;
  p.rows = rows;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_lu_kernel<T>), dim3(g), dim3(kThreads),
      args, static_cast<size_t>(w) * sizeof(T),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Grid size of a launch on an (m, w) panel of elements of `elem_size`
// bytes (4 or 8); the caller sizes the workspaces from it:
//   ws  (elements of the panel's type): 2*G + 2*G*w + 2*w
//   iws (int32):                        4*G + 2
// Returns G >= 1, or minus a cudaError_t code.
int rf_panel_lu_grid(int m, int w, int elem_size, int device) {
  int g = 0, rows = 0;
  const int err = elem_size == 8 ? grid_for<double>(m, w, device, &g, &rows)
                                 : grid_for<float>(m, w, device, &g, &rows);
  return err != 0 ? -err : g;
}

// Factor the panel in place on `stream`.  Returns a cudaError_t code
// (0 on success) for the launch; faults during the run surface at the
// next synchronisation.
int rf_panel_lu_f32(void* a, int m, int w, int lda, int pivot, void* piv,
                    void* perm, void* info, void* ws, void* iws, int grid,
                    int device, void* stream) {
  return launch<float>(a, m, w, lda, pivot, piv, perm, info, ws, iws, grid,
                       device, stream);
}

int rf_panel_lu_f64(void* a, int m, int w, int lda, int pivot, void* piv,
                    void* perm, void* info, void* ws, void* iws, int grid,
                    int device, void* stream) {
  return launch<double>(a, m, w, lda, pivot, piv, perm, info, ws, iws, grid,
                        device, stream);
}

}  // extern "C"
