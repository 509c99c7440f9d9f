// Partial-pivot LU of a tall (m x w) panel, or of a whole matrix, on Hopper.
//
// Two kernels of the JAX package, one launcher (`run<T>`), and the bf16x3
// form of the first (entry points rf_panel_lu_bf16x3_*, below):
//
// * the main-path kernel (entry points rf_panel_lu_*, ofs = 0) replaces the
//   TPU kernel recursivefactorization_jl_tpu/ops/panel.py
//   `_panel_kernel_fori` (variants fori / fori2 / fori3, reached through
//   `panel_factor_pallas`); plain version: ops/unblocked.py `unblocked_lu`.
// * the offset kernel (entry points rf_offset_panel_lu_*) replaces
//   `_offset_panel_kernel` (reached through `offset_panel_factor_pallas`),
//   the panel kernel of the tensor-parallel LU (parallel/blockcyclic.py): a
//   full-height (m x w) panel whose elimination starts at the runtime row
//   `ofs`.  Column k eliminates row ofs + k, the pivot search runs over rows
//   >= ofs + k, the published pivot rows are global, perm is the composed
//   permutation of all m rows (the identity above `ofs`), and rows < ofs
//   are never read or written: the work covers only the live rows [ofs, m),
//   and one build serves every offset.  Plain version: ops/unblocked.py
//   `offset_panel_lu`.  The TPU kernel's lane-major shadow, `unroll` and
//   masked boundary matmul are not carried over.
//
// Both run on one of two routes, the cluster route or, for panels too tall
// for it, the grid route (below).  Per elimination step k (row gk = k, or
// ofs + k with the offset), both compute what the plain versions compute:
//   1. first-occurrence argmax of |a[i, k]| over rows i >= gk (the largest
//      magnitude, the smallest row among ties; a NaN wins over any number);
//   2. rows gk and kp swap across the panel's w columns, only when the pivot
//      is nonzero and kp != gk; the composed row permutation swaps with them;
//   3. the column below row gk is scaled by r = 1/p, computed once;
//   4. rank-1 update a[i, j] = a[i, j] - l[i] * u[j] for i > gk, j > k
//      (it still runs after a zero pivot, with the unscaled column);
//   5. info is the first 1-based zero-pivot step k + 1, negated without
//      pivoting.
// Every product and difference is rounded on its own (__fmul_rn, __fsub_rn,
// and -fmad=false at build time), so the factors agree bitwise with the
// plain version's `A - outer(l, u)` and one near-tie cannot flip a pivot.
//
// Design.  The chain of w elimination steps is serial; a step's work is
// small (a 4096 x 512 f32 panel needs ~4 MB of traffic and ~0.5 GFLOP in
// all).  What bounds the kernel is the latency of one step, so the design
// puts the chain where a step is cheapest: on ONE thread-block cluster,
// with the block's slab of the panel in the cluster's shared memory.
//
// The cluster route (panel_chain_kernel, panel_swap_solve_kernel,
// panel_update_kernel, in csrc/panel_cluster.cuh, which csrc/panel_lu_c64.cu
// instantiates for complex panels too) factors the panel in blocks of b
// columns.  For each block [k0, k0 + b):
//   1. chain: one cluster of C CTAs (C in 1, 2, 4, 8, 16) loads the slab,
//      the live rows [ofs + k0, m) x the block's columns, into shared
//      memory, each CTA a contiguous range of rows, and runs the block's
//      steps there with a one-column look-ahead.  Step kk:
//        a. each CTA reduces its pivot candidate in column kk, which the
//           last step brought up to date (redux.sync over each warp, then
//           over the warps: one __syncthreads());
//        b. warp 0 brings the candidate row up to date (step kk - 1's
//           update, still due in its columns > kk), writes it back and
//           sends it with (|v|, row, perm id, origin) into a slot of every
//           CTA's shared memory by DSMEM, in 16-byte st.async stores that
//           complete on the receiver's mbarrier of the step's parity; the
//           owner of row gk does the same for that row; both warps then
//           arrive on their own CTA's barrier (warp 0's arrival carries
//           the bytes the CTA expects in the step, chain_exchange_bytes);
//        c. the warps between the two sending warps apply step kk - 1's
//           update to their rows' columns > kk + 1, the two rows just sent
//           excepted; every thread then waits on its CTA's barrier
//           (try_wait.parity.acquire.cluster) until the step's data is in:
//           the bulk of the update runs inside the exchange's latency, the
//           sending warps wait for the data alone, and no barrier spans
//           the cluster;
//        d. every thread reduces the C candidates to the same winner, the
//           owners of rows gk and kp take the swapped rows from their own
//           CTA's slots, and one thread per row below gk scales column kk
//           and brings column kk + 1 up to date (step kk - 1's update where
//           it is still due, then step kk's), searching it for the next
//           step's candidate.
//      The slots are double-buffered by step parity: a CTA can only write
//      step k+2's slots after its wait of step k+1, which needs every
//      CTA's candidate of step k+1, sent after that CTA's step k+1
//      reduction, so after it read step k's; step kk - 1's pivot row,
//      which the sending warps read in step kk, they read before they send.
//      With C = 1 the wait is a __syncthreads().  The slab, piv, perm,
//      info and the list of rows that moved go back to device memory.
//   2. the delayed pass, on the whole card: the block's row moves are
//      applied to every column outside the slab (rows swap whole, as in the
//      plain version), the block's U rows are solved in the columns >= k0+b
//      (row k0+t takes steps k0 .. k0+t-1 in order), and every row below
//      the block takes the block's b rank-1 updates in step order.  With one
//      block of look-ahead (run_cluster's carry) the next block's chain does
//      this in its own b columns as it loads its slab, and the two delayed
//      kernels take the other columns on a second stream beside that chain,
//      on the SMs its cluster leaves free.
// Every element still receives its updates in step order, each product and
// difference rounded on its own: an update is deferred or delayed, never
// reordered or summed first, so the result is the plain version's bit for
// bit (tests/test_torch_panel_schedule.py emulates both orders on the CPU).
// A panel no wider than b is one block, with no delayed pass.
//
// What the H100 measured (PERF.md; `chip_smoke.py` timing phase and this
// kernel's phase trace, `chain_trace`):
// a cluster barrier costs ~0.5 us after its last arrive, and publishing a
// candidate ~0.8 us; before the look-ahead a step of ~3.0-3.4 us at C = 16
// ran the candidate reduction and publish, the barrier, the agreement and
// swap and the slab update one after another.  Every thread's redundant
// work counts 4x (4 warps per scheduler), so the phases are written for
// few instructions per thread: the argmax reductions are redux.sync on
// keys, the look-ahead column takes one thread per row (the padded slab
// keeps a column's rows on distinct banks).  A variant with the slab in
// registers (each thread whole rows) was measured slower: its row arrays
// went to local memory.
//
// Launch shape: the launcher issues the chain kernel and the two delayed
// kernels, 1 + 2 per block, with no host synchronisation (shape (b) of the
// two considered; shape (a), one cooperative kernel with a cluster dimension
// whose other CTAs wait at two grid barriers per block, was not built: (b)
// needs no grid barrier and no launch attribute beyond the cluster's).  The
// chains run in turn on the caller's stream; each block's delayed kernels
// but the panel's last run on a side stream forked and joined with events
// (edges of the graph in a stream capture), beside the next chain, which
// takes the pass in its own columns (run_cluster in csrc/panel_cluster.cuh).
//
// b and C come from the panel's live rows, w and the element size
// (`plan_for`, values from the H100 sweep `chip_smoke.py --sweep`, PERF.md);
// the C entry points take them explicitly too (0 = auto; b in 8, 16, 32,
// 64, or b >= w for one block of up to 512 columns).  A panel whose live
// rows do not fit a cluster of 16 even at b = 8 (the slab and the slots in
// 227 KB per CTA: about 92 000 f32 or 50 000 f64 rows) takes the grid
// route below; so does b < 0.
//
// The grid route (panel_lu_kernel): the panel is split by rows over a
// cooperative grid of up to one block per SM; block g owns rows
// [ofs + g*R, ofs + (g+1)*R) and the panel stays in device memory.  Each
// step has ONE grid-wide barrier:
//   phase A  every block finds its local pivot candidate and publishes
//            (|value|, row, perm id, the full candidate row); the owner of
//            row gk publishes row gk;                     -- grid.sync() --
//   phase B  every block reduces the candidates to the same winner, the
//            owners of rows gk and kp write the swapped rows, and every block
//            scales and updates its own rows from the winner's row.
// Its step costs 6-8 us on an H100 (PERF.md): a grid barrier, two block
// reductions and dependent L2 round trips.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "panel_cluster.cuh"
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
  int ofs;        // first row of the elimination (kOffset kernels only)
  int pivot;
  int* piv;       // (steps,)      0-based pivot row of each step
  int* perm;      // (m,)          composed row permutation
  int* info;      // (1,)
  T* cand_val;    // [2][G]        |candidate| per block
  T* cand_row;    // [2][G][w]     candidate rows
  T* krow;        // [2][w]        row gk before the swap
  int* cand_idx;  // [2][G]        candidate row index
  int* cand_pid;  // [2][G]        perm id travelling with the candidate row
  int* kpid;      // [2]           perm id of row gk
  int rows;       // rows per block
};

template <typename T, bool kOffset>
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
  const int ofs = kOffset ? p.ofs : 0;
  const int steps = min(m - ofs, w);
  const int r0 = ofs + b * p.rows;
  const int r1 = min(m, r0 + p.rows);
  int info = 0;  // kept by block 0, thread 0

  for (int i = r0 + tid; i < r1; i += kThreads) p.perm[i] = i;
  if (kOffset) {
    // the rows above the offset never move
    for (int i = b * kThreads + tid; i < ofs; i += G * kThreads) p.perm[i] = i;
  }
  __syncthreads();

  for (int k = 0; k < steps; ++k) {
    const int gk = ofs + k;  // the row that column k eliminates
    const int par = k & 1;
    T* cval = p.cand_val + par * G;
    int* cidx = p.cand_idx + par * G;
    int* cpid = p.cand_pid + par * G;
    T* crow = p.cand_row + static_cast<size_t>(par) * G * w;
    T* krow = p.krow + static_cast<size_t>(par) * w;
    const bool own_k = gk >= r0 && gk < r1;

    // ---- phase A: publish the local candidate and row gk ---------------
    if (p.pivot) {
      T best = T(-1);
      int bi = INT_MAX;
      for (int i = max(gk, r0) + tid; i < r1; i += kThreads) {
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
      const T* src = p.a + gk * lda;
      for (int j = tid; j < w; j += kThreads) krow[j] = src[j];
      if (tid == 0) p.kpid[par] = p.perm[gk];
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
    const int kp = p.pivot ? s_kp : gk;
    const T* u = p.pivot ? crow + static_cast<size_t>(s_src) * w : krow;
    for (int j = tid; j < w; j += kThreads) urow[j] = __ldcg(u + j);
    __syncthreads();

    const T pv = urow[k];
    const bool nz = pv != T(0);
    const bool do_swap = nz && kp != gk;
    if (do_swap) {
      if (own_k) {
        T* dst = p.a + gk * lda;
        for (int j = tid; j < w; j += kThreads) dst[j] = urow[j];
        if (tid == 0) p.perm[gk] = __ldcg(cpid + s_src);
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
    for (int i = max(gk + 1, r0) + warp; i < r1; i += kWarps) {
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

// Grid over the `m` live rows (those at and below the offset).
template <typename T, bool kOffset>
int grid_for(int m, int w, int device, int* grid_out, int* rows_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(w) * sizeof(T);
  err = opt_in_smem(reinterpret_cast<const void*>(panel_lu_kernel<T, kOffset>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, panel_lu_kernel<T, kOffset>, kThreads, smem);
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

template <typename T, bool kOffset>
int full_plan(int m, int w, int ofs, int b, int C, int device, Plan* pl) {
  if (m < 1 || w < 1 || ofs < 0 || (kOffset ? ofs + w > m : ofs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = plan_for<T>(m - ofs, w, b, C, device, pl);
  if (r != kPlanGrid) return r;
  int g = 0, rows = 0;
  const int err = grid_for<T, kOffset>(m - ofs, w, device, &g, &rows);
  if (err != 0) return err;
  pl->route = kRouteGrid;
  pl->grid = g;
  pl->ws_reals = 2 * static_cast<size_t>(g) + 2 * static_cast<size_t>(g) * w + 2 * w;
  pl->iws_ints = 4 * static_cast<size_t>(g) + 2;
  return 0;
}

template <typename T, bool kOffset>
int run(void* a, int m, int w, int lda, int pivot, int ofs, int b, int C, void* piv,
        void* perm, void* info, void* ws, void* iws, PanelStats* stats, int device,
        void* stream_) {
  *stats = PanelStats{};
  Plan pl;
  int err = full_plan<T, kOffset>(m, w, ofs, b, C, device, &pl);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  T* A = static_cast<T*>(a);
  if (pl.route == kRouteGrid) {
    PanelArgs<T> p;
    p.a = A;
    p.m = m;
    p.w = w;
    p.lda = lda;
    p.ofs = ofs;
    p.pivot = pivot;
    p.piv = static_cast<int*>(piv);
    p.perm = static_cast<int*>(perm);
    p.info = static_cast<int*>(info);
    const int g = pl.grid;
    T* f = static_cast<T*>(ws);
    p.cand_val = f;
    p.cand_row = f + 2 * static_cast<size_t>(g);
    p.krow = p.cand_row + 2 * static_cast<size_t>(g) * w;
    int* iw = static_cast<int*>(iws);
    p.cand_idx = iw;
    p.cand_pid = iw + 2 * g;
    p.kpid = iw + 4 * g;
    p.rows = (m - ofs + g - 1) / g;
    void* args[] = {&p};
    cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(panel_lu_kernel<T, kOffset>), dim3(g), dim3(kThreads), args,
        static_cast<size_t>(w) * sizeof(T), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  return run_cluster<T>(A, m, w, lda, pivot, ofs, pl, piv, perm, info, iws, stream, stats);
}

template <bool kOffset>
int plan_entry(int m, int w, int elem_size, int ofs, int b, int C, int device, int* out) {
  Plan pl;
  const int err = elem_size == 8 ? full_plan<double, kOffset>(m, w, ofs, b, C, device, &pl)
                                 : full_plan<float, kOffset>(m, w, ofs, b, C, device, &pl);
  if (err == 0) write_plan(pl, out);
  return err;
}

// ---- panel_boundary_precision='bf16x3' -----------------------------------
//
// The main-path kernel in blocks of exactly b steps (the configuration's
// panel_micro, any b >= 1; the slab takes the width at or above it), each
// block's trailing update in the bf16x3 form on the tensor cores
// (panel_update_bf16x3_tiled_kernel, csrc/panel_cluster.cuh); the chain
// and the swap / solve pass are the float32 form's.  Plain version:
// ops/unblocked.py `micro_blocked_lu(..., 'bf16x3')`.  A block whose live
// rows do not fit a cluster at width b (or whose b passes 512) runs its
// chain on the grid (panel_grid_chain_kernel), with the same bits and the
// same delayed pass, so every panel keeps its block boundaries; `chain` = 1
// puts every block's chain there.
int bf16x3_plan(int m, int w, int b, int C, int chain, int device, Plan* pl) {
  if (m < 1 || w < 1 || b < 1 || C < 0 || (chain != 0 && chain != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = plan_for<float>(m, w, b, C, device, pl, true, chain == 1);
  return r != 0 ? r : grid_chain_plan<float>(m, device, pl);
}

}  // namespace

extern "C" {

// The plan of a launch on an (m, w) panel of elements of `elem_size` bytes
// (4 or 8) whose elimination starts at row `ofs` (0 for the main-path
// kernel; 0 <= ofs <= m - w for the offset kernel), with block width `b`
// and cluster size `C` (0, 0: the launcher's choice; b < 0: the grid
// route; b >= w: one block).  Fills out[kPlanInts] as write_plan says (the
// workspaces at least one element each).  Returns a cudaError_t code, 0 on
// success; cudaErrorInvalidConfiguration when an explicit (b, C) does not
// fit the card.
int rf_panel_lu_plan(int m, int w, int elem_size, int ofs, int b, int C, int device,
                     int* out) {
  return plan_entry<false>(m, w, elem_size, ofs, b, C, device, out);
}

int rf_offset_panel_lu_plan(int m, int w, int elem_size, int ofs, int b, int C, int device,
                            int* out) {
  return plan_entry<true>(m, w, elem_size, ofs, b, C, device, out);
}

// Factor the panel in place on `stream`, with the plan's (b, C) (0, 0 for
// the launcher's choice); `stats` (host) gets the launch's PanelStats.
// Returns a cudaError_t code (0 on success) for the launches; faults during
// the run surface at the next synchronisation.
int rf_panel_lu_f32(void* a, int m, int w, int lda, int pivot, int b, int C, void* piv,
                    void* perm, void* info, void* ws, void* iws, PanelStats* stats, int device,
                    void* stream) {
  return run<float, false>(a, m, w, lda, pivot, 0, b, C, piv, perm, info, ws, iws, stats,
                           device, stream);
}

int rf_panel_lu_f64(void* a, int m, int w, int lda, int pivot, int b, int C, void* piv,
                    void* perm, void* info, void* ws, void* iws, PanelStats* stats, int device,
                    void* stream) {
  return run<double, false>(a, m, w, lda, pivot, 0, b, C, piv, perm, info, ws, iws, stats,
                            device, stream);
}

// The offset kernel: factor rows [ofs, m) of the panel in place on
// `stream`: piv (w,) holds global rows, perm (m,) the permutation of all m
// rows, info the signed panel-local step.
int rf_offset_panel_lu_f32(void* a, int m, int w, int lda, int pivot, int ofs, int b, int C,
                           void* piv, void* perm, void* info, void* ws, void* iws,
                           PanelStats* stats, int device, void* stream) {
  return run<float, true>(a, m, w, lda, pivot, ofs, b, C, piv, perm, info, ws, iws, stats,
                          device, stream);
}

int rf_offset_panel_lu_f64(void* a, int m, int w, int lda, int pivot, int ofs, int b, int C,
                           void* piv, void* perm, void* info, void* ws, void* iws,
                           PanelStats* stats, int device, void* stream) {
  return run<double, true>(a, m, w, lda, pivot, ofs, b, C, piv, perm, info, ws, iws, stats,
                           device, stream);
}

// The plan of the bf16x3 form on an (m, w) float32 panel with blocks of b
// steps (any b >= 1; b >= w: one block, no boundary), cluster size C (0:
// the launcher's choice) and `chain` 1 to run every block's chain on the
// grid (0: only the blocks too tall for a cluster).  Fills out[kPlanInts]
// (route 1, the cluster route; C 0 where no block's chain runs on a
// cluster).  Returns cudaErrorInvalidConfiguration when an explicit C does
// not fit the card.
int rf_panel_lu_bf16x3_plan(int m, int w, int b, int C, int chain, int device, int* out) {
  Plan pl;
  const int err = bf16x3_plan(m, w, b, C, chain, device, &pl);
  if (err == 0) write_plan(pl, out);
  return err;
}

// Factor the float32 panel in place on `stream` in the bf16x3 form, with the
// plan of (b, C, chain); `iws` holds the plan's iws int32s, `ws` is unused
// (the form has no grid route).  `simple` = 1 forces the simple update
// kernel (default 0: the tiled one).  `stats` (host) gets the launch's
// PanelStats.  Returns a cudaError_t code.
int rf_panel_lu_bf16x3_f32(void* a, int m, int w, int lda, int pivot, int b, int C, int simple,
                           int chain, void* piv, void* perm, void* info, void* ws, void* iws,
                           PanelStats* stats, int device, void* stream) {
  *stats = PanelStats{};
  if (simple != 0 && simple != 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = bf16x3_plan(m, w, b, C, chain, device, &pl);
  if (err != 0) return err;
  return run_cluster<float, kBf16x3>(static_cast<float*>(a), m, w, lda, pivot, 0, pl, piv,
                                     perm, info, iws, static_cast<cudaStream_t>(stream), stats,
                                     simple ? kUpdSimple : kUpdTiled);
}

// One bf16x3 update on `stream`: c (rows x cols, row stride ldc) -=
// hh + (hl + lh) of l (rows x nb, row stride ldl) and u (nb x cols, row
// stride ldu), nb >= 1 (past 64 in chunks of 64 steps); float32 device
// pointers, c disjoint from l and u.  `simple` = 1 forces the simple kernel (default 0: the tiled one
// on its plan's tile).  Returns a cudaError_t code.
int rf_panel_update_bf16x3_f32(const void* l, int ldl, const void* u, int ldu, void* c,
                               int ldc, int rows, int cols, int nb, int simple, int device,
                               void* stream) {
  if (simple != 0 && simple != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Bf16x3Args args;
  args.l = static_cast<const float*>(l);
  args.u = static_cast<const float*>(u);
  args.c = static_cast<float*>(c);
  args.ldl = ldl;
  args.ldu = ldu;
  args.ldc = ldc;
  args.rows = rows;
  args.cols = cols;
  args.nb = nb;
  return launch_update_bf16x3<float>(args, static_cast<cudaStream_t>(stream),
                                     simple ? kUpdSimple : kUpdTiled);
}

// The tiled update's plan for (rows, cols, nb): out[5] = rows and columns
// of the tile, the steps staged per chunk (nb padded to 16, at most 64),
// the grid's row and column tiles (tile_plan).
// Returns a cudaError_t code.
int rf_panel_update_bf16x3_plan(int rows, int cols, int nb, int* out) {
  if (rows < 1 || cols < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan q = tile_plan(rows, cols, nb);
  out[0] = q.tm;
  out[1] = q.tn;
  out[2] = q.kp;
  out[3] = q.gx;
  out[4] = q.gy;
  return 0;
}

// Phase trace of the cluster route's chain kernel, for measurement: with
// `buf` non-null every later chain launch writes, from CTA 0, 9 clock64()
// stamps per step into buf[9 * step + phase]: from thread 0 (warp 0, which
// publishes the candidate) phases 0-7, the step's start, after the
// candidate reduction's barrier, published (its sends and its arrival on
// the exchange's mbarrier), after its share of the deferred update, data
// in (its wait returned), after the pivot agreement, after the swap, after
// the look-ahead column (the step's end); from thread 32 (warp 1, which
// publishes nothing) phase 8, the end of its share of the deferred update.
// Per block i, buf[9 * steps + 4 * i + {0, 1, 2, 3}] = the kernel's first
// %globaltimer (ns), clock64(), last %globaltimer, clock64().  buf holds
// int64s on the device; null turns the trace off.
int rf_panel_lu_set_trace(void* buf) {
  g_trace = static_cast<long long*>(buf);
  return 0;
}

}  // extern "C"
