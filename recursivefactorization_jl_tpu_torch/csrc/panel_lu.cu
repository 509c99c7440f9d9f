// Partial-pivot LU of a tall (m x w) panel, or of a whole matrix, on Hopper.
//
// Two kernels of the JAX package, one launcher (`run<T>`):
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
// panel_update_kernel) factors the panel in blocks of b columns.  For each
// block [k0, k0 + b):
//   1. chain: one cluster of C CTAs (C in 1, 2, 4, 8, 16) loads the slab,
//      the live rows [ofs + k0, m) x the block's columns, into shared
//      memory, each CTA a contiguous range of rows, and runs the block's
//      steps there.  A step: each CTA reduces its pivot candidate (found
//      while the previous step updated the column) by shuffles, one
//      __syncthreads(); warp 0 writes it (|v|, row, perm id, the row's
//      entries) into a slot of every CTA's shared memory by DSMEM, lanes
//      spread over the CTAs, and the owner of row gk sends that row the
//      same way; ONE cluster barrier; every thread reduces the C
//      candidates to the same winner in log2(C) shuffle rounds, the owners
//      of rows gk and kp take the swapped rows from their own CTA's slots,
//      and every CTA scales and updates its rows in the slab's columns
//      only, a group of min(b, 32) lanes per row.  The slots are double-buffered by step
//      parity: a CTA can only write step k+2's slots after every CTA has
//      passed step k+1's barrier, so after it read step k's.  With C = 1
//      the barrier is a __syncthreads().  The slab, piv, perm, info and the
//      list of rows that moved go back to device memory.
//   2. the delayed pass, on the whole card: the block's row moves are
//      applied to every column outside the slab (rows swap whole, as in the
//      plain version), the block's U rows are solved in the columns >= k0+b
//      (row k0+t takes steps k0 .. k0+t-1 in order), and every row below
//      the block takes the block's b rank-1 updates in step order.
// Every element still receives its updates in step order, each product and
// difference rounded on its own: an update is delayed, never reordered or
// summed first, so the result is the plain version's bit for bit
// (tests/test_torch_panel_schedule.py emulates this order on the CPU).
// A panel no wider than b is one block, with no delayed pass.
//
// What the H100 measured (PERF.md; `chip_smoke.py` timing phase, the
// barrier microbenchmark and this kernel's phase trace): a cluster barrier
// costs ~0.65 us and a DSMEM candidate exchange 0.9-1.7 us against 1.1 us
// for a grid barrier of 132 blocks; a step of ~3-4 us splits into the
// candidate reduction and publish (~1 us), the barrier (~0.45 us), the
// agreement and swap (~0.5 us) and the slab update (~1.5 us).  Every
// thread's redundant work counts 4x (4 warps per scheduler), so the phases
// are written for few instructions per thread.  A variant with the slab in
// registers (each thread whole rows) was measured slower: its row arrays
// went to local memory.
//
// Launch shape: the launcher issues the chain kernel and the two delayed
// kernels in turn on the caller's stream, 1 + 2 per block, with no host
// synchronisation (shape (b) of the two considered; shape (a), one
// cooperative kernel with a cluster dimension whose other CTAs wait at two
// grid barriers per block, was not built: (b) needs no grid barrier and no
// launch attribute beyond the cluster's).
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

// ---- the cluster route ----------------------------------------------------

constexpr int kChainThreads = 512;
// dynamic shared memory a chain CTA may take: the SM's 227 KB less room for
// the kernel's static arrays
constexpr size_t kSmemMax = 232448 - 1024;
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kTile = 32;          // columns per CTA of the delayed pass
constexpr int kDelayThreads = 256;
constexpr int kDelayWarps = kDelayThreads / 32;
constexpr int kUpdRows = 64;       // rows per CTA of the rank-b update
constexpr int kRouteGrid = 0, kRouteCluster = 1;
constexpr int kPlanGrid = -1;  // plan_for's answer for the grid route

template <typename T>
struct ChainArgs {
  T* a;          // panel, row-major with row stride lda
  int m, lda, ofs, pivot;
  int k0;        // the block's first step
  int nb;        // its steps
  int ncol;      // the slab's columns (nb, or w when one block takes all)
  int rows;      // slab rows per CTA
  int* piv;
  int* perm;
  int* info;
  int* moved;    // [0] count, then (row, row it now holds) pairs
  // optional phase trace (rf_panel_lu_set_trace): kTracePhases clock64()
  // stamps per step from thread 0 of CTA 0, then per block the kernel's
  // first and last %globaltimer (ns) and clock64()
  long long* trace;
  int steps, blk;
};

constexpr int kTracePhases = 7;
long long* g_trace = nullptr;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A step's pivot candidate as a CTA publishes it to every CTA.
template <typename T>
struct Cand {
  T val;     // |a[row, k]|, -1 for none
  int idx;   // its global row, INT_MAX for none
  int pid;   // the perm id travelling with the row
  int src;   // the row it held when the block began
};

// Byte offsets of a chain CTA's dynamic shared memory: the slab (rows x B,
// row stride B), the exchange slots ([2][C] candidate rows, [2] copies of
// row gk, [2][C] candidates, [2] (pid, src) of row gk), then the slab rows'
// perm ids and origins.
struct ChainSmem {
  size_t crow, krow, cand, kinf, pid, src, total;
};

__host__ __device__ inline ChainSmem chain_smem(int rows, int C, int B, int sz) {
  ChainSmem s;
  size_t o = static_cast<size_t>(rows) * B * sz;
  s.crow = o; o += static_cast<size_t>(2) * C * B * sz;
  s.krow = o; o += static_cast<size_t>(2) * B * sz;
  s.cand = o; o += static_cast<size_t>(2) * C * (sz == 8 ? 24 : 16);
  s.kinf = o; o += 16;
  s.pid = o; o += static_cast<size_t>(rows) * 4;
  s.src = o; o += static_cast<size_t>(rows) * 4;
  s.total = o;
  return s;
}

// Store x at `ptr` in the shared memory of cluster CTA d (its own with a
// cluster of one: a plain shared store).
template <typename V>
__device__ __forceinline__ void put(cg::cluster_group cluster, int C, V* ptr, int d,
                                    const V& x) {
  if (C == 1) {
    *ptr = x;
  } else {
    *cluster.map_shared_rank(ptr, d) = x;
  }
}

// The pivot chain of one block on one cluster (see the note at the top).
// Thread mapping: a group of G = min(B, 32) lanes owns slab rows grp,
// grp + NG, ...; lane li owns columns li, li + G, ...  The same thread
// swaps, scales, updates and searches an element within a step, so those
// need no barrier between them.
template <typename T, int B>
__global__ void __launch_bounds__(kChainThreads)
panel_chain_kernel(ChainArgs<T> p) {
  constexpr int G = B < 32 ? B : 32;
  constexpr int PER = B / G;
  constexpr int NG = kChainThreads / G;
  // a published row: lane l sends columns l % GW + 32 t (t < VPL) to the
  // CTAs l / GW, l / GW + DSTEP, ...
  constexpr int GW = B < 32 ? B : 32;
  constexpr int VPL = B < 32 ? 1 : B / 32;
  constexpr int DSTEP = 32 / GW;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_val[kChainWarps];
  __shared__ int red_idx[kChainWarps];

  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = p.rows;
  const ChainSmem L = chain_smem(R, C, B, sizeof(T));
  T* slab = reinterpret_cast<T*>(smem_raw);
  T* crow = reinterpret_cast<T*>(smem_raw + L.crow);
  T* krow = reinterpret_cast<T*>(smem_raw + L.krow);
  Cand<T>* cand = reinterpret_cast<Cand<T>*>(smem_raw + L.cand);
  int* kinf = reinterpret_cast<int*>(smem_raw + L.kinf);
  int* pid = reinterpret_cast<int*>(smem_raw + L.pid);
  int* src = reinterpret_cast<int*>(smem_raw + L.src);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / G, li = tid % G;
  const size_t lda = static_cast<size_t>(p.lda);
  const int nb = p.nb, ncol = p.ncol, k0 = p.k0;
  const int r0 = p.ofs + k0;           // global row of slab row 0
  const int M = p.m - r0;              // slab rows
  const int s0 = rank * R;             // this CTA's first slab row
  const int own = max(0, min(M, s0 + R) - s0);
  const bool first = k0 == 0;

  if (first) {  // the rows above the offset never move
    for (int i = rank * kChainThreads + tid; i < p.ofs; i += C * kChainThreads) p.perm[i] = i;
  }
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol) slab[e] = p.a[(r0 + s0 + q) * lda + k0 + c];
  }
  for (int q = tid; q < own; q += kChainThreads) {
    const int row = r0 + s0 + q;
    pid[q] = first ? row : p.perm[row];
    src[q] = row;
  }
  __syncthreads();

  // step 0's candidate: column 0 is lane 0 of each group
  T best = T(-1);
  int bi = INT_MAX;
  if (p.pivot && li == 0) {
    for (int q = grp; q < own; q += NG) {
      const T v = mag(slab[q * B]);
      if (better(v, r0 + s0 + q, best, bi)) { best = v; bi = r0 + s0 + q; }
    }
  }
  int info = 0;
  if (rank == 0 && tid == 0 && !first) info = *p.info;

  const bool tr = p.trace != nullptr && rank == 0 && tid == 0;
  long long* stamps = tr ? p.trace + static_cast<size_t>(k0) * kTracePhases : nullptr;
  long long* ends = tr ? p.trace + static_cast<size_t>(p.steps) * kTracePhases + 4 * p.blk : nullptr;
  if (tr) { ends[0] = global_ns(); ends[1] = clock64(); }
#define RF_STAMP(phase) \
  if (tr) stamps[kk * kTracePhases + (phase)] = clock64()

  for (int kk = 0; kk < nb; ++kk) {
    const int par = kk & 1;
    const int gk = r0 + kk;
    const int owner = kk / R;  // the CTA that holds slab row kk
    const int slot = par * C + rank;
    const int lk = kk % G;     // the lane of column kk in each group
    RF_STAMP(0);

    // ---- reduce the CTA's candidate ----------------------------------------
    // lane lk of each group holds its rows' candidate (found while the last
    // step updated column kk); move it to the group's lanes, then down the
    // warp in log2(32 / G) rounds
    if (p.pivot) {
      T v = __shfl_sync(kFull, best, lk, G);
      int i = __shfl_sync(kFull, bi, lk, G);
      for (int off = 16; off >= G; off >>= 1) {
        const T ov = __shfl_down_sync(kFull, v, off);
        const int oi = __shfl_down_sync(kFull, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (lane == 0) { red_val[warp] = v; red_idx[warp] = i; }
    }
    __syncthreads();  // also orders the previous step's slab writes
    RF_STAMP(1);

    // ---- publish it and row gk to every CTA -------------------------------
    // each lane loads what it sends first and then stores, so the remote
    // stores go out back to back
    if (p.pivot && warp == 0) {
      T v = lane < kChainWarps ? red_val[lane] : T(-1);
      int i = lane < kChainWarps ? red_idx[lane] : INT_MAX;
      for (int off = kChainWarps / 2; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(kFull, v, off);
        const int oi = __shfl_down_sync(kFull, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      v = __shfl_sync(kFull, v, 0);
      i = __shfl_sync(kFull, i, 0);
      const int q = i == INT_MAX ? -1 : i - r0 - s0;
      Cand<T> cd;
      cd.val = v;
      cd.idx = i;
      cd.pid = q < 0 ? -1 : pid[q];
      cd.src = q < 0 ? -1 : src[q];
      T x[VPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        const int c = lane % GW + t * 32;
        x[t] = q >= 0 && c < ncol ? slab[q * B + c] : T(0);
      }
      if (lane < C) put(cluster, C, cand + slot, lane, cd);
      if (q >= 0) {
        for (int d = lane / GW; d < C; d += DSTEP) {
#pragma unroll
          for (int t = 0; t < VPL; ++t) {
            const int c = lane % GW + t * 32;
            if (c < ncol) put(cluster, C, crow + slot * B + c, d, x[t]);
          }
        }
      }
    }
    if (rank == owner && warp == kChainWarps - 1) {
      const int q = kk - s0;
      const int kp_id = pid[q], ks_id = src[q];
      T x[VPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        const int c = lane % GW + t * 32;
        x[t] = c < ncol ? slab[q * B + c] : T(0);
      }
      if (lane < C) {
        put(cluster, C, kinf + 2 * par, lane, kp_id);
        put(cluster, C, kinf + 2 * par + 1, lane, ks_id);
      }
      for (int d = lane / GW; d < C; d += DSTEP) {
#pragma unroll
        for (int t = 0; t < VPL; ++t) {
          const int c = lane % GW + t * 32;
          if (c < ncol) put(cluster, C, krow + par * B + c, d, x[t]);
        }
      }
    }
    RF_STAMP(2);
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    RF_STAMP(3);

    // ---- every CTA agrees on the pivot: lanes < C hold one candidate each,
    // log2(C) butterfly rounds ----------------------------------------------
    const T* urow;
    int kp, upid, usrc;
    if (p.pivot) {
      T v = T(-1);
      int i = INT_MAX, g = lane;
      if (lane < C) {
        v = cand[par * C + lane].val;
        i = cand[par * C + lane].idx;
      }
      for (int off = 1; off < C; off <<= 1) {
        const T ov = __shfl_xor_sync(kFull, v, off);
        const int oi = __shfl_xor_sync(kFull, i, off);
        const int og = __shfl_xor_sync(kFull, g, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; g = og; }
      }
      kp = __shfl_sync(kFull, i, 0);
      const int bg = __shfl_sync(kFull, g, 0);
      urow = crow + static_cast<size_t>(par * C + bg) * B;
      upid = cand[par * C + bg].pid;
      usrc = cand[par * C + bg].src;
    } else {
      kp = gk;
      urow = krow + par * B;
      upid = kinf[2 * par];
      usrc = kinf[2 * par + 1];
    }
    const T pv = urow[kk];
    const bool nz = pv != T(0);
    const bool swap = nz && kp != gk;
    const T rr = nz ? rrcp(pv) : T(1);
    if (rank == 0 && tid == 0) {
      p.piv[k0 + kk] = kp;
      if (!nz && info == 0) info = p.pivot ? k0 + kk + 1 : -(k0 + kk + 1);
    }
    RF_STAMP(4);

    // ---- swap rows kk and kp where this CTA holds them ---------------------
    if (swap) {
      const int qa = kk - s0, qb = kp - r0 - s0;
      if (qa >= 0 && qa < own && grp == qa % NG) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = li + j * G;
          if (c < ncol) slab[qa * B + c] = urow[c];
        }
        if (li == 0) { pid[qa] = upid; src[qa] = usrc; }
      }
      if (qb >= 0 && qb < own && grp == qb % NG) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = li + j * G;
          if (c < ncol) slab[qb * B + c] = krow[par * B + c];
        }
        if (li == 0) { pid[qb] = kinf[2 * par]; src[qb] = kinf[2 * par + 1]; }
      }
    }
    RF_STAMP(5);

    // ---- scale, update the slab's columns > kk, search column kk + 1 ------
    // two rows per pass; passes wholly above row kk are skipped, and the
    // trip count is uniform over the CTA, as the shuffles need
    T u[PER];
    bool act[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = li + j * G;
      u[j] = urow[c];
      act[j] = c > kk && c < ncol;
    }
    const int jn = (kk + 1) / G;
    const bool scale_lane = li == lk;
    const bool search_lane = p.pivot && kk + 1 < nb && li == (kk + 1) % G;
    best = T(-1);
    bi = INT_MAX;
    for (int q0 = max(0, kk + 1 - s0) / NG * NG; q0 < own; q0 += 2 * NG) {
      const int qa = q0 + grp, qb = qa + NG;
      const bool ona = qa < own && s0 + qa > kk;
      const bool onb = qb < own && s0 + qb > kk;
      T* ra = slab + qa * B;
      T* rb = slab + qb * B;
      T la = T(0), lb = T(0);
      if (scale_lane) {
        if (ona) {
          la = ra[kk];
          if (nz) { la = rmul(la, rr); ra[kk] = la; }
        }
        if (onb) {
          lb = rb[kk];
          if (nz) { lb = rmul(lb, rr); rb[kk] = lb; }
        }
      }
      la = __shfl_sync(kFull, la, lk, G);
      lb = __shfl_sync(kFull, lb, lk, G);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (!act[j]) continue;
        const int c = li + j * G;
        if (ona) {
          const T x = rsub(ra[c], rmul(la, u[j]));
          ra[c] = x;
          if (search_lane && j == jn && better(mag(x), r0 + s0 + qa, best, bi)) {
            best = mag(x);
            bi = r0 + s0 + qa;
          }
        }
        if (onb) {
          const T x = rsub(rb[c], rmul(lb, u[j]));
          rb[c] = x;
          if (search_lane && j == jn && better(mag(x), r0 + s0 + qb, best, bi)) {
            best = mag(x);
            bi = r0 + s0 + qb;
          }
        }
      }
    }
    RF_STAMP(6);
  }
#undef RF_STAMP

  // ---- write the slab, perm and the block's row moves back ---------------
  if (rank == 0 && tid == 0) *p.info = info;
  __syncthreads();
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol) p.a[(r0 + s0 + q) * lda + k0 + c] = slab[e];
  }
  for (int q = tid; q < own; q += kChainThreads) {
    const int row = r0 + s0 + q;
    p.perm[row] = pid[q];
    if (src[q] != row) {
      const int e = atomicAdd(p.moved, 1);
      p.moved[1 + 2 * e] = row;
      p.moved[2 + 2 * e] = src[q];
    }
  }
  // no CTA leaves while another may still write into its shared memory
  if (C > 1) cluster.sync();
  if (tr) { ends[2] = global_ns(); ends[3] = clock64(); }
}

template <typename T>
struct DelayArgs {
  T* a;
  int m, w, lda;
  int r0;          // global row of the block's first step
  int k0, nb;      // the block's columns [k0, k0 + nb)
  const int* moved;
};

// The delayed pass, part 1: one CTA per 32 columns of [0, w).  Applies the
// block's row moves to its columns outside the slab (every old value is
// read before any is written), then solves the block's U rows in its
// columns >= k0 + nb: row t takes steps 0 .. t-1 in order.
template <typename T>
__global__ void __launch_bounds__(kDelayThreads)
panel_swap_solve_kernel(DelayArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = p.nb, k1 = p.k0 + nb;
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2 nb][kTile] the moved rows' old values
  T* U = buf + 2 * nb * kTile;               // [nb][kTile]
  T* Lb = U + nb * kTile;                    // [nb][nb] the block's multipliers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kTile + lane;
  const bool outside = c < p.w && (c < p.k0 || c >= k1);
  const size_t lda = static_cast<size_t>(p.lda);
  const int moves = p.moved[0];
  for (int e = warp; e < moves; e += kDelayWarps) {
    if (outside) buf[e * kTile + lane] = p.a[p.moved[2 + 2 * e] * lda + c];
  }
  __syncthreads();
  for (int e = warp; e < moves; e += kDelayWarps) {
    if (outside) p.a[p.moved[1 + 2 * e] * lda + c] = buf[e * kTile + lane];
  }
  if ((blockIdx.x + 1) * kTile <= k1 || nb < 2) return;  // no U columns here
  __syncthreads();
  const bool right = c < p.w && c >= k1;
  for (int t = warp; t < nb; t += kDelayWarps) {
    U[t * kTile + lane] = right ? p.a[(p.r0 + t) * lda + c] : T(0);
  }
  for (int e = threadIdx.x; e < nb * nb; e += kDelayThreads) {
    const int t = e / nb, s = e % nb;
    if (s < t) Lb[e] = p.a[(p.r0 + t) * lda + p.k0 + s];
  }
  __syncthreads();
  for (int s = 0; s + 1 < nb; ++s) {
    const T us = U[s * kTile + lane];
    for (int t = s + 1 + warp; t < nb; t += kDelayWarps) {
      U[t * kTile + lane] = rsub(U[t * kTile + lane], rmul(Lb[t * nb + s], us));
    }
    __syncthreads();
  }
  if (right) {
    for (int t = 1 + warp; t < nb; t += kDelayWarps) p.a[(p.r0 + t) * lda + c] = U[t * kTile + lane];
  }
}

// The delayed pass, part 2: every row below the block takes the block's nb
// rank-1 updates in step order; one CTA per 64 rows x 32 columns >= k0+nb.
template <typename T>
__global__ void __launch_bounds__(kDelayThreads)
panel_update_kernel(DelayArgs<T> p) {
  constexpr int kPer = kUpdRows / kDelayWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = p.nb, k1 = p.k0 + nb;
  T* U = reinterpret_cast<T*>(smem_raw);  // [nb][kTile]
  T* Lr = U + nb * kTile;                  // [kUpdRows][nb]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = k1 + blockIdx.x * kTile + lane;
  const int i0 = p.r0 + nb + blockIdx.y * kUpdRows;
  const size_t lda = static_cast<size_t>(p.lda);
  for (int t = warp; t < nb; t += kDelayWarps) {
    U[t * kTile + lane] = c < p.w ? p.a[(p.r0 + t) * lda + c] : T(0);
  }
  for (int e = threadIdx.x; e < kUpdRows * nb; e += kDelayThreads) {
    const int r = e / nb, t = e % nb;
    Lr[e] = i0 + r < p.m ? p.a[(i0 + r) * lda + p.k0 + t] : T(0);
  }
  __syncthreads();
  if (c >= p.w) return;
  T x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + warp + j * kDelayWarps;
    x[j] = i < p.m ? p.a[i * lda + c] : T(0);
  }
  for (int t = 0; t < nb; ++t) {
    const T u = U[t * kTile + lane];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      x[j] = rsub(x[j], rmul(Lr[(warp + j * kDelayWarps) * nb + t], u));
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + warp + j * kDelayWarps;
    if (i < p.m) p.a[i * lda + c] = x[j];
  }
}

// ---- plan ----------------------------------------------------------------

constexpr int kWidths[] = {8, 16, 32, 64, 128, 256, 512};
constexpr int kNumWidths = 7;
constexpr int kMaxDevices = 16;

template <typename T>
using ChainFn = void (*)(ChainArgs<T>);

template <typename T>
ChainFn<T> chain_kernel_for(int B) {
  switch (B) {
    case 8: return panel_chain_kernel<T, 8>;
    case 16: return panel_chain_kernel<T, 16>;
    case 32: return panel_chain_kernel<T, 32>;
    case 64: return panel_chain_kernel<T, 64>;
    case 128: return panel_chain_kernel<T, 128>;
    case 256: return panel_chain_kernel<T, 256>;
    default: return panel_chain_kernel<T, 512>;
  }
}

int width_index(int B) {
  for (int i = 0; i < kNumWidths; ++i) if (kWidths[i] == B) return i;
  return -1;
}

cudaLaunchConfig_t chain_config(int C, size_t smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kChainThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Does the card run a cluster of C chain CTAs of width B with the most
// shared memory the route uses?  Asked once per (device, type, B, C), with
// cudaOccupancyMaxActiveClusters; sets the kernel's attributes on the way.
template <typename T>
int cluster_ok(int B, int C, int device, bool* ok) {
  static int cache[kMaxDevices][kNumWidths][5];
  static bool init = false;
  if (!init) {
    for (auto& d : cache) for (auto& b : d) for (int& c : b) c = -1;
    init = true;
  }
  int ci = 0;
  while ((1 << ci) < C) ++ci;
  const int wi = width_index(B);
  if (wi < 0 || (1 << ci) != C || ci > 4 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int& slot = cache[device][wi][ci];
  if (slot < 0) {
    const void* fn = reinterpret_cast<const void*>(chain_kernel_for<T>(B));
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemMax));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (C > 8) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = chain_config(C, kSmemMax, nullptr, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a refused size is an answer, not a sticky error
      n = 0;
    }
    slot = n > 0 ? 1 : 0;
  }
  *ok = slot == 1;
  return 0;
}

struct Plan {
  int route;      // kRouteCluster or kRouteGrid
  int b;          // steps per block (cluster route)
  int B;          // the chain kernel's slab width: b, or a power of two >= w
  int C;          // CTAs of the cluster
  int one_block;  // b >= w: the whole live panel in one slab, no delayed pass
  int blocks;
  int grid;       // blocks of the grid route
  size_t ws_reals, iws_ints;
};

int width_at_least(int w) {
  int B = 8;
  while (B < w) B <<= 1;
  return B;
}

size_t chain_bytes(int M, int B, int C, int sz) {
  const int rows = (M + C - 1) / C;
  return chain_smem(rows, C, B, sz).total;
}

// The plan of a panel with M live rows and w columns.  b_req / C_req: 0
// picks; b_req < 0 forces the grid route; b_req >= w asks for one block.
template <typename T>
int plan_for(int M, int w, int b_req, int C_req, int device, Plan* pl) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sz = sizeof(T);
  const int steps = M < w ? M : w;
  *pl = Plan{};
  auto fits = [&](int B, int C, bool* ok) -> int {
    *ok = false;
    if (chain_bytes(M, B, C, sz) > kSmemMax || C > M) return 0;
    return cluster_ok<T>(B, C, device, ok);
  };
  auto take = [&](int b, int B, int C) {
    pl->route = kRouteCluster;
    pl->b = b;
    pl->B = B;
    pl->C = C;
    pl->one_block = b >= w;
    pl->blocks = (steps + b - 1) / b;
    pl->ws_reals = 1;
    pl->iws_ints = static_cast<size_t>(pl->blocks) * (1 + 4 * B);
  };
  if (b_req < 0) return kPlanGrid;
  if (b_req > 0 && C_req > 0) {  // explicit
    const bool one = b_req >= w;
    const int B = one ? width_at_least(w) : b_req;
    if ((!one && B != 8 && B != 16 && B != 32 && B != 64) || B > 512)
      return static_cast<int>(cudaErrorInvalidValue);
    bool ok = false;
    const int err = fits(B, C_req, &ok);
    if (err != 0) return err;
    if (!ok) return static_cast<int>(cudaErrorInvalidConfiguration);
    take(one ? w : b_req, B, C_req);
    return 0;
  }
  if (b_req != 0 || C_req != 0) return static_cast<int>(cudaErrorInvalidValue);
  // auto, from the H100 sweep (PERF.md): b = 32 up to 1536 live rows, 16 up
  // to 4096, 8 above (one block when w <= b); one CTA up to 128 rows, else
  // the smallest power of two C >= M / 32, at most 16.  Narrower blocks and
  // larger clusters where that does not fit; the grid route beyond.
  const int b0 = M <= 1536 ? 32 : M <= 4096 ? 16 : 8;
  int c0 = 1;
  while (M > 128 && c0 < kMaxCluster && 32 * c0 < M) c0 *= 2;
  for (int b : {b0, 16, 8}) {
    if (b > b0) continue;
    const int bb = w <= b ? w : b;
    const int B = width_at_least(bb);
    for (int C = c0; C <= kMaxCluster; C *= 2) {
      bool ok = false;
      const int err = fits(B, C, &ok);
      if (err != 0) return err;
      if (ok) { take(bb, B, C); return 0; }
    }
  }
  return kPlanGrid;  // the grid route: the caller fills it in
}

// The delayed kernels take at most (3 * kTile * 64 + 64 * 64) reals of
// shared memory (b <= 64): opt in once.
template <typename T>
int delay_opt_in() {
  static bool done = false;
  if (done) return 0;
  cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(panel_swap_solve_kernel<T>),
                                (3 * kTile * 64 + 64 * 64) * sizeof(T));
  if (err == cudaSuccess)
    err = opt_in_smem(reinterpret_cast<const void*>(panel_update_kernel<T>),
                      (kTile * 64 + kUpdRows * 64) * sizeof(T));
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

// The whole plan: the cluster route, or the grid route's grid.
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
        void* perm, void* info, void* ws, void* iws, int device, void* stream_) {
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
  err = delay_opt_in<T>();
  if (err != 0) return err;
  int* moved = static_cast<int*>(iws);
  cudaError_t e = cudaMemsetAsync(moved, 0, pl.iws_ints * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int steps = m - ofs < w ? m - ofs : w;
  for (int k0 = 0, blk = 0; k0 < steps; k0 += pl.b, ++blk) {
    const int nb = steps - k0 < pl.b ? steps - k0 : pl.b;
    ChainArgs<T> c;
    c.a = A;
    c.m = m;
    c.lda = lda;
    c.ofs = ofs;
    c.pivot = pivot;
    c.k0 = k0;
    c.nb = nb;
    c.ncol = pl.one_block ? w : nb;
    c.rows = (m - ofs - k0 + pl.C - 1) / pl.C;
    c.piv = static_cast<int*>(piv);
    c.perm = static_cast<int*>(perm);
    c.info = static_cast<int*>(info);
    c.moved = moved + static_cast<size_t>(blk) * (1 + 4 * pl.B);
    c.trace = g_trace;
    c.steps = steps;
    c.blk = blk;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        chain_config(pl.C, chain_smem(c.rows, pl.C, pl.B, sizeof(T)).total, stream, attr);
    e = cudaLaunchKernelEx(&cfg, chain_kernel_for<T>(pl.B), c);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (pl.one_block) continue;
    DelayArgs<T> d;
    d.a = A;
    d.m = m;
    d.w = w;
    d.lda = lda;
    d.r0 = ofs + k0;
    d.k0 = k0;
    d.nb = nb;
    d.moved = c.moved;
    if (w > nb) {
      panel_swap_solve_kernel<T><<<(w + kTile - 1) / kTile, kDelayThreads,
                                   (3 * kTile * nb + nb * nb) * sizeof(T), stream>>>(d);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int cols = w - k0 - nb, rows = m - ofs - k0 - nb;
    if (cols > 0 && rows > 0) {
      const dim3 grid((cols + kTile - 1) / kTile, (rows + kUpdRows - 1) / kUpdRows);
      panel_update_kernel<T><<<grid, kDelayThreads, (kTile * nb + kUpdRows * nb) * sizeof(T),
                               stream>>>(d);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kOffset>
int plan_entry(int m, int w, int elem_size, int ofs, int b, int C, int device, int* out) {
  Plan pl;
  const int err = elem_size == 8 ? full_plan<double, kOffset>(m, w, ofs, b, C, device, &pl)
                                 : full_plan<float, kOffset>(m, w, ofs, b, C, device, &pl);
  if (err != 0) return err;
  out[0] = pl.route;
  out[1] = pl.route == kRouteCluster ? pl.b : -1;
  out[2] = pl.route == kRouteCluster ? pl.C : pl.grid;
  out[3] = pl.route == kRouteCluster ? pl.blocks : 1;
  out[4] = static_cast<int>(pl.ws_reals);
  out[5] = static_cast<int>(pl.iws_ints);
  return 0;
}

// ---- barrier microbenchmark ------------------------------------------------

__global__ void bench_grid_sync_kernel(int iters, int* sink) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = iters;
}

__global__ void __launch_bounds__(kChainThreads) bench_cluster_sync_kernel(int iters, int* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = iters;
}

__global__ void __launch_bounds__(kChainThreads) bench_syncthreads_kernel(int iters, int* sink) {
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) *sink = iters;
}

// One candidate exchange as the chain kernel makes it (f32, a 32-wide
// slab): warp 0 writes a candidate (|v|, row, perm id, origin) and its 32
// entries into a slot of every CTA, lanes spread over the CTAs; one
// cluster.sync(); every thread reduces the C candidates.
__global__ void __launch_bounds__(kChainThreads) bench_exchange_kernel(int iters, int* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Cand<float> cand[2][kMaxCluster];
  __shared__ float rows[2][kMaxCluster][32];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  int acc = 0;
  for (int i = 0; i < iters; ++i) {
    const int par = i & 1;
    if (threadIdx.x < 32) {
      if (lane < C) {
        Cand<float> cd;
        cd.val = static_cast<float>(i + rank);
        cd.idx = rank;
        cd.pid = i;
        cd.src = lane;
        *cluster.map_shared_rank(&cand[par][rank], lane) = cd;
      }
      for (int e = lane; e < C * 32; e += 32) {
        *cluster.map_shared_rank(&rows[par][rank][e % 32], e / 32) = static_cast<float>(e);
      }
    }
    cluster.sync();
    float bv = -1.0f;
    int bi = INT_MAX, bg = 0;
    for (int g = 0; g < C; ++g) {
      if (better(cand[par][g].val, cand[par][g].idx, bv, bi)) {
        bv = cand[par][g].val;
        bi = cand[par][g].idx;
        bg = g;
      }
    }
    acc += bg + static_cast<int>(rows[par][bg][lane]);
  }
  cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = acc;
}

int bench_barrier(int kind, int n, int iters, int device, void* sink, void* stream_) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int* out = static_cast<int*>(sink);
  if (kind == 0) {  // grid.sync() over n blocks of kThreads
    void* args[] = {&iters, &out};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(bench_grid_sync_kernel), dim3(n),
                                    dim3(kThreads), args, 0, stream);
  } else if (kind == 2) {  // __syncthreads() in one CTA of kChainThreads
    bench_syncthreads_kernel<<<1, kChainThreads, 0, stream>>>(iters, out);
    e = cudaGetLastError();
  } else if (kind == 1 || kind == 3) {  // cluster.sync() / exchange over n CTAs
    const void* fn = kind == 1 ? reinterpret_cast<const void*>(bench_cluster_sync_kernel)
                               : reinterpret_cast<const void*>(bench_exchange_kernel);
    if (n > 8) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n);
    cfg.blockDim = dim3(kChainThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = kind == 1 ? cudaLaunchKernelEx(&cfg, bench_cluster_sync_kernel, iters, out)
                  : cudaLaunchKernelEx(&cfg, bench_exchange_kernel, iters, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan of a launch on an (m, w) panel of elements of `elem_size` bytes
// (4 or 8) whose elimination starts at row `ofs` (0 for the main-path
// kernel; 0 <= ofs <= m - w for the offset kernel), with block width `b`
// and cluster size `C` (0, 0: the launcher's choice; b < 0: the grid
// route; b >= w: one block).  Fills out[6] = {route (1 cluster, 0 grid),
// b (-1 on the grid route), C (the grid route: its grid), blocks, ws
// reals, iws int32s}; the caller allocates the two workspaces with those
// sizes (at least one element each).  Returns a cudaError_t code, 0 on
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
// the launcher's choice).  Returns a cudaError_t code (0 on success) for
// the launches; faults during the run surface at the next synchronisation.
int rf_panel_lu_f32(void* a, int m, int w, int lda, int pivot, int b, int C, void* piv,
                    void* perm, void* info, void* ws, void* iws, int device, void* stream) {
  return run<float, false>(a, m, w, lda, pivot, 0, b, C, piv, perm, info, ws, iws, device,
                           stream);
}

int rf_panel_lu_f64(void* a, int m, int w, int lda, int pivot, int b, int C, void* piv,
                    void* perm, void* info, void* ws, void* iws, int device, void* stream) {
  return run<double, false>(a, m, w, lda, pivot, 0, b, C, piv, perm, info, ws, iws, device,
                            stream);
}

// The offset kernel: factor rows [ofs, m) of the panel in place on
// `stream`: piv (w,) holds global rows, perm (m,) the permutation of all m
// rows, info the signed panel-local step.
int rf_offset_panel_lu_f32(void* a, int m, int w, int lda, int pivot, int ofs, int b, int C,
                           void* piv, void* perm, void* info, void* ws, void* iws, int device,
                           void* stream) {
  return run<float, true>(a, m, w, lda, pivot, ofs, b, C, piv, perm, info, ws, iws, device,
                          stream);
}

int rf_offset_panel_lu_f64(void* a, int m, int w, int lda, int pivot, int ofs, int b, int C,
                           void* piv, void* perm, void* info, void* ws, void* iws, int device,
                           void* stream) {
  return run<double, true>(a, m, w, lda, pivot, ofs, b, C, piv, perm, info, ws, iws, device,
                           stream);
}

// Phase trace of the cluster route's chain kernel, for measurement: with
// `buf` non-null every later chain launch writes, from thread 0 of CTA 0,
// 7 clock64() stamps per step into buf[7 * step + phase] (phases: step
// start, after the reduction's barrier, after the publish, after the
// cluster barrier, after the pivot agreement, after the swap, after the
// update) and per block i buf[7 * steps + 4 * i + {0, 1, 2, 3}] = the
// kernel's first %globaltimer (ns), clock64(), last %globaltimer,
// clock64().  buf holds int64s on the device; null turns the trace off.
int rf_panel_lu_set_trace(void* buf) {
  g_trace = static_cast<long long*>(buf);
  return 0;
}

// Barrier microbenchmark: one launch of `iters` barriers of kind 0
// (grid.sync() over a cooperative grid of n blocks of 256 threads), 1
// (cluster.sync() over a cluster of n CTAs of 512), 2 (__syncthreads() in
// one CTA of 512) or 3 (the chain kernel's candidate exchange over a
// cluster of n: DSMEM writes to every CTA, cluster.sync(), the reduction).
// `sink` is one int32 on the device.  Time two launches with different
// `iters` to take the launch out.
int rf_bench_barrier(int kind, int n, int iters, int device, void* sink, void* stream) {
  return bench_barrier(kind, n, iters, device, sink, stream);
}

}  // extern "C"
