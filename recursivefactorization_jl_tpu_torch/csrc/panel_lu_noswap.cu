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
// Two routes, chosen by shape (`plan_for` of csrc/panel_cluster.cuh with this
// file's chain kernel), or by the caller with b < 0 for the grid route.
//
// The cluster route factors the panel in blocks of b columns, as the
// swapping kernels' cluster route does (csrc/panel_lu.cu), without row
// moves.  For each block [k0, k1):
//   1. chain (noswap_chain_kernel, one cluster of C CTAs): every CTA scans
//      the mask and lists the rows still available, in ascending physical
//      order, with no host synchronisation; the list is split into C
//      contiguous parts and CTA r loads its rows x the block's columns
//      (the slab) into shared memory.  Ascending order keeps "the smaller
//      row among ties" and "the first NaN row" first-occurrence rules in
//      slab order, so candidates compare by slab position.  A step: each
//      CTA reduces its candidate among its rows not yet taken in the block
//      (found while the previous step updated the column), writes (|v|,
//      position, physical row, the row's entries) into a slot of every
//      CTA by DSMEM, ONE cluster barrier, every thread reduces the C
//      candidates to the same winner; the owner marks the row taken (in
//      shared memory and in `used`), and every CTA scales and updates its
//      still-available rows in the slab's columns.  Nothing moves, so
//      there is no second exchange and no list of moved rows.  The slab,
//      prow and info go back to device memory; CTA 0 writes the list.
//   2. the delayed pass (noswap_solve_kernel, noswap_update_kernel, whole
//      card): the block's pivot rows prow[k0 ..], gathered by index, are
//      solved in the columns >= k1 (row t takes steps 0 .. t-1 in order),
//      then every row of the block's list still available takes the
//      block's rank-1 updates in step order.  Rows consumed before the
//      block are never touched.
// Each element still takes its updates in step order, one rounding per
// product and difference, so the result is the plain version's bit for
// bit (tests/test_torch_panel_cluster_routes.py emulates the order).
// The slab's size comes from the caller's count of available rows
// (`live`, the plan's M; m when the caller has none): the chain checks on
// the device that the mask's count fits the plan and otherwise traps, so
// the launch fails at the next synchronisation (an unspecified launch
// failure, which ends the process's CUDA context) and never computes on a
// truncated slab.  Later blocks size their slab for live - k0 rows: each
// earlier step consumed one row.
//
// The grid route (panel_lu_noswap_kernel, the grid-barrier design; panels
// too tall for a cluster, or b < 0): the row split of csrc/panel_lu.cu's
// grid route with the mask in place of the swap.  A cooperative grid of up to one
// thread block per SM, block b owns rows [b*R, (b+1)*R) whatever their
// state, ONE grid barrier per step (candidates published, then every
// block reduces them to the same winner and updates its own available rows
// from the winner's row).  A block whose rows are all consumed publishes
// the empty candidate and skips the update; every step walks all m rows.
// The TPU kernel's micro blocks, its transposed shadow, the one-hot row
// extraction and the repeated-squaring inverse answer the TPU's lane
// layout and are not carried over.
//
// What bounds both: the serial pivot chain; bytes and operations are a few
// microseconds at the card's rates.

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

// ---- the cluster route ------------------------------------------------------

template <typename T>
struct NsChainArgs {
  T* a;              // panel, row-major with row stride lda
  int m, lda, pivot;
  int k0, nb, ncol;  // the block's first step, its steps, the slab's columns
  int rows;          // slab rows per CTA
  const int* mask;   // nonzero: taken before the block (used0, then used)
  const int* used0;  // the first block copies it into used as 0/1
  int* used;
  int* list;         // out: [0] the block's row count, then its rows
  int* prow;
  int* info;
  long long* trace;  // as ChainArgs::trace (csrc/panel_cluster.cuh)
  int steps, blk;
};

// The pivot chain of one block in physical row order on one cluster.
// Thread mapping as in panel_chain_kernel: a group of G = min(B, 32) lanes
// owns slab rows grp, grp + NG, ...; lane li owns columns li, li + G, ...
// Candidates carry their slab position (ascending with the physical row);
// the physical row rides in Cand::pid.
template <typename T, int B>
__global__ void __launch_bounds__(kChainThreads)
noswap_chain_kernel(NsChainArgs<T> p) {
  constexpr int G = B < 32 ? B : 32;
  constexpr int PER = B / G;
  constexpr int NG = kChainThreads / G;
  constexpr int GW = B < 32 ? B : 32;
  constexpr int VPL = B < 32 ? 1 : B / 32;
  constexpr int DSTEP = 32 / GW;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_val[kChainWarps];
  __shared__ int red_idx[kChainWarps];
  __shared__ int scan[kChainWarps];

  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int R_ = p.rows;
  const ChainSmem L = chain_smem<T>(R_, C, B);
  T* slab = reinterpret_cast<T*>(smem_raw);
  T* crow = reinterpret_cast<T*>(smem_raw + L.crow);
  Cand<T>* cand = reinterpret_cast<Cand<T>*>(smem_raw + L.cand);
  int* row = reinterpret_cast<int*>(smem_raw + L.pid);  // physical row of each slab row
  int* tk = reinterpret_cast<int*>(smem_raw + L.src);   // taken in this block

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / G, li = tid % G;
  const size_t lda = static_cast<size_t>(p.lda);
  const int m = p.m, nb = p.nb, ncol = p.ncol, k0 = p.k0;
  const int s0 = rank * R_;  // this CTA's first slab position
  const bool first = k0 == 0;
  // the candidate's order: |v| with pivoting, else 0 (the first row wins)
  const bool pivot = p.pivot != 0;
  auto key = [pivot](T x) -> T { return pivot ? mag(x) : T(0); };

  // ---- the available rows, ascending: a chunk of the mask per thread,
  // counted, scanned over the CTA, then listed -------------------------------
  const int per = (m + kChainThreads - 1) / kChainThreads;
  const int i0 = tid * per, i1 = min(m, i0 + per);
  int cnt = 0;
  for (int i = i0; i < i1; ++i) cnt += p.mask[i] == 0;
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int total = 0, pos = incl - cnt;
  for (int v = 0; v < kChainWarps; ++v) {
    total += scan[v];
    if (v < warp) pos += scan[v];
  }
  // a slab too small for the mask's rows: the caller's count was wrong
  if (total > C * R_) __trap();
  for (int i = i0; i < i1 && pos < s0 + R_; ++i) {
    if (p.mask[i] != 0) continue;
    if (pos >= s0) row[pos - s0] = i;
    ++pos;
  }
  if (first) {
    for (int i = rank * kChainThreads + tid; i < m; i += C * kChainThreads)
      p.used[i] = p.used0[i] != 0;
  }
  const int own = max(0, min(total, s0 + R_) - s0);
  __syncthreads();
  for (int q = tid; q < own; q += kChainThreads) {
    tk[q] = 0;
    p.list[1 + s0 + q] = row[q];
  }
  if (rank == 0 && tid == 0) p.list[0] = total;
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol) slab[e] = p.a[row[q] * lda + k0 + c];
  }
  __syncthreads();

  // step 0's candidate: column 0 is lane 0 of each group
  T best = T(-1);
  int bi = INT_MAX;
  if (li == 0) {
    for (int q = grp; q < own; q += NG) {
      const T v = key(slab[q * B]);
      if (better(v, s0 + q, best, bi)) { best = v; bi = s0 + q; }
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
    const int slot = par * C + rank;
    const int lk = kk % G;
    RF_STAMP(0);

    // ---- reduce the CTA's candidate ----------------------------------------
    {
      T v = __shfl_sync(kFull, best, lk, G);
      int i = __shfl_sync(kFull, bi, lk, G);
      for (int off = 16; off >= G; off >>= 1) {
        const T ov = __shfl_down_sync(kFull, v, off);
        const int oi = __shfl_down_sync(kFull, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (lane == 0) { red_val[warp] = v; red_idx[warp] = i; }
    }
    __syncthreads();  // also orders the previous step's slab and tk writes
    RF_STAMP(1);

    // ---- publish it to every CTA ------------------------------------------
    if (warp == 0) {
      T v = lane < kChainWarps ? red_val[lane] : T(-1);
      int i = lane < kChainWarps ? red_idx[lane] : INT_MAX;
      for (int off = kChainWarps / 2; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(kFull, v, off);
        const int oi = __shfl_down_sync(kFull, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      v = __shfl_sync(kFull, v, 0);
      i = __shfl_sync(kFull, i, 0);
      const int q = i == INT_MAX ? -1 : i - s0;
      Cand<T> cd;
      cd.val = v;
      cd.idx = i;
      cd.pid = q < 0 ? -1 : row[q];
      cd.src = 0;
      T x[VPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        const int c = lane % GW + t * 32;
        x[t] = q >= 0 && c < ncol ? slab[q * B + c] : T{};
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
    RF_STAMP(2);
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    RF_STAMP(3);

    // ---- every CTA agrees on the pivot: log2(C) butterfly rounds -----------
    int kp, bg;
    {
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
      bg = __shfl_sync(kFull, g, 0);
    }
    if (kp == INT_MAX) {  // no row left: the same in every CTA
      if (rank == 0 && tid == 0) p.prow[k0 + kk] = -1;
      best = T(-1);
      bi = INT_MAX;
      continue;
    }
    const T* urow = crow + static_cast<size_t>(par * C + bg) * B;
    const int prw = cand[par * C + bg].pid;
    const T pv = urow[kk];
    const bool nz = nonzero(pv);
    const T rr = nz ? rrcp(pv) : T{};
    const int qk = kp - s0;  // the pivot's slab row, where this CTA holds it
    if (rank == 0 && tid == 0) {
      p.prow[k0 + kk] = prw;
      if (!nz && info == 0) info = pivot ? k0 + kk + 1 : -(k0 + kk + 1);
    }
    if (tid == 0 && qk >= 0 && qk < own) p.used[prw] = 1;
    RF_STAMP(4);
    RF_STAMP(5);

    // ---- scale, update the slab's columns > kk, search column kk + 1 ------
    // over the rows still available; the trip count is uniform over the
    // CTA, as the shuffles need
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
    const bool search_lane = kk + 1 < nb && li == (kk + 1) % G;
    best = T(-1);
    bi = INT_MAX;
    for (int q0 = 0; q0 < own; q0 += 2 * NG) {
      const int qa = q0 + grp, qb = qa + NG;
      const bool ona = qa < own && qa != qk && !tk[qa];
      const bool onb = qb < own && qb != qk && !tk[qb];
      T* ra = slab + qa * B;
      T* rb = slab + qb * B;
      T la = T{}, lb = T{};
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
      la = shfl(la, lk, G);
      lb = shfl(lb, lk, G);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (!act[j]) continue;
        const int c = li + j * G;
        if (ona) {
          const T x = rsub(ra[c], rmul(la, u[j]));
          ra[c] = x;
          if (search_lane && j == jn && better(key(x), s0 + qa, best, bi)) {
            best = key(x);
            bi = s0 + qa;
          }
        }
        if (onb) {
          const T x = rsub(rb[c], rmul(lb, u[j]));
          rb[c] = x;
          if (search_lane && j == jn && better(key(x), s0 + qb, best, bi)) {
            best = key(x);
            bi = s0 + qb;
          }
        }
      }
    }
    // the next step's barrier orders this write before any read of it
    if (tid == 0 && qk >= 0 && qk < own) tk[qk] = 1;
    RF_STAMP(6);
  }
#undef RF_STAMP

  // ---- write the slab and info back --------------------------------------
  if (rank == 0 && tid == 0) *p.info = info;
  __syncthreads();
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol) p.a[row[q] * lda + k0 + c] = slab[e];
  }
  // no CTA leaves while another may still write into its shared memory
  if (C > 1) cluster.sync();
  if (tr) { ends[2] = global_ns(); ends[3] = clock64(); }
}

template <typename T>
struct NsDelayArgs {
  T* a;
  int w, lda;
  int k0, nb;        // the block's columns [k0, k0 + nb)
  const int* prow;   // its pivot rows at prow[k0 ..], -1 past the last row
  const int* list;   // [0] count, then the rows the block started from
  const int* used;
};

// The steps of the block that found a row: a prefix (once no row is left,
// none is left for the rest).  pr holds the block's prow entries.
__device__ __forceinline__ int valid_steps(const int* pr, int nb) {
  int nv = 0;
  while (nv < nb && pr[nv] >= 0) ++nv;
  return nv;
}

// The delayed pass, part 1: one CTA per 32 columns >= k0 + nb.  Solves the
// block's U rows, the pivot rows gathered by index: row t takes steps
// 0 .. t-1 in order.
template <typename T>
__global__ void __launch_bounds__(kDelayThreads)
noswap_solve_kernel(NsDelayArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int pr[64];
  const int nb = p.nb, k1 = p.k0 + nb;
  T* U = reinterpret_cast<T*>(smem_raw);  // [nb][kTile]
  T* Lb = U + nb * kTile;                  // [nb][nb] the block's multipliers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = k1 + blockIdx.x * kTile + lane;
  const bool right = c < p.w;
  const size_t lda = static_cast<size_t>(p.lda);
  for (int t = threadIdx.x; t < nb; t += kDelayThreads) pr[t] = p.prow[p.k0 + t];
  __syncthreads();
  const int nv = valid_steps(pr, nb);
  if (nv < 2) return;
  for (int t = warp; t < nv; t += kDelayWarps) {
    U[t * kTile + lane] = right ? p.a[pr[t] * lda + c] : T{};
  }
  for (int e = threadIdx.x; e < nv * nv; e += kDelayThreads) {
    const int t = e / nv, s = e % nv;
    if (s < t) Lb[e] = p.a[pr[t] * lda + p.k0 + s];
  }
  __syncthreads();
  for (int s = 0; s + 1 < nv; ++s) {
    const T us = U[s * kTile + lane];
    for (int t = s + 1 + warp; t < nv; t += kDelayWarps) {
      U[t * kTile + lane] = rsub(U[t * kTile + lane], rmul(Lb[t * nv + s], us));
    }
    __syncthreads();
  }
  if (right) {
    for (int t = 1 + warp; t < nv; t += kDelayWarps) p.a[pr[t] * lda + c] = U[t * kTile + lane];
  }
}

// The delayed pass, part 2: the rows of the block's list still available
// take the block's rank-1 updates in step order; one CTA per 64 list
// entries x 32 columns >= k0 + nb.
template <typename T>
__global__ void __launch_bounds__(kDelayThreads)
noswap_update_kernel(NsDelayArgs<T> p) {
  constexpr int kPer = kUpdRows / kDelayWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int pr[64];
  __shared__ int rw[kUpdRows];
  const int nb = p.nb, k1 = p.k0 + nb;
  T* U = reinterpret_cast<T*>(smem_raw);  // [nb][kTile]
  T* Lr = U + nb * kTile;                  // [kUpdRows][nb]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = k1 + blockIdx.x * kTile + lane;
  const int total = p.list[0];
  const int i0 = blockIdx.y * kUpdRows;
  if (i0 >= total) return;  // uniform over the CTA
  const size_t lda = static_cast<size_t>(p.lda);
  for (int t = threadIdx.x; t < nb; t += kDelayThreads) pr[t] = p.prow[p.k0 + t];
  for (int r = threadIdx.x; r < kUpdRows; r += kDelayThreads) {
    int i = -1;
    if (i0 + r < total) {
      i = p.list[1 + i0 + r];
      if (p.used[i] != 0) i = -1;  // one of the block's pivot rows
    }
    rw[r] = i;
  }
  __syncthreads();
  const int nv = valid_steps(pr, nb);
  for (int t = warp; t < nv; t += kDelayWarps) {
    U[t * kTile + lane] = c < p.w ? p.a[pr[t] * lda + c] : T{};
  }
  for (int e = threadIdx.x; e < kUpdRows * nv; e += kDelayThreads) {
    const int r = e / nv, t = e % nv;
    Lr[r * nb + t] = rw[r] >= 0 ? p.a[rw[r] * lda + p.k0 + t] : T{};
  }
  __syncthreads();
  if (c >= p.w) return;
  T x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = rw[warp + j * kDelayWarps];
    x[j] = i >= 0 ? p.a[i * lda + c] : T{};
  }
  for (int t = 0; t < nv; ++t) {
    const T u = U[t * kTile + lane];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      x[j] = rsub(x[j], rmul(Lr[(warp + j * kDelayWarps) * nb + t], u));
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = rw[warp + j * kDelayWarps];
    if (i >= 0) p.a[i * lda + c] = x[j];
  }
}

template <typename T>
using NsChainFn = void (*)(NsChainArgs<T>);

template <typename T>
NsChainFn<T> ns_chain_kernel_for(int B) {
  switch (B) {
    case 8: return noswap_chain_kernel<T, 8>;
    case 16: return noswap_chain_kernel<T, 16>;
    case 32: return noswap_chain_kernel<T, 32>;
    case 64: return noswap_chain_kernel<T, 64>;
    case 128: return noswap_chain_kernel<T, 128>;
    case 256: return noswap_chain_kernel<T, 256>;
    default: return noswap_chain_kernel<T, 512>;
  }
}

template <typename T>
struct NoswapChain {
  static const void* fn(int B) { return reinterpret_cast<const void*>(ns_chain_kernel_for<T>(B)); }
};

// The plan of a launch: the cluster route for `live` available rows (its
// slab, list and grid sizes), or the grid route.
template <typename T>
int full_plan(int m, int w, int live, int b, int C, int device, Plan* pl) {
  if (m < 1 || w < 1 || live < 0 || live > m) return static_cast<int>(cudaErrorInvalidValue);
  const int M = live > 0 ? live : 1;
  const int r = plan_for<T, NoswapChain<T>>(M, w, b, C, device, pl);
  if (r == 0) {  // the list: its count, then at most C * ceil(M / C) rows
    pl->iws_ints = 1 + static_cast<size_t>(pl->C) * ((M + pl->C - 1) / pl->C);
    return 0;
  }
  if (r != kPlanGrid) return r;
  int g = 0, rows = 0;
  const int err = grid_for<T>(m, w, device, &g, &rows);
  if (err != 0) return err;
  pl->route = kRouteGrid;
  pl->grid = g;
  pl->ws_reals = 2 * static_cast<size_t>(g) + 2 * static_cast<size_t>(g) * w;
  pl->iws_ints = 2 * static_cast<size_t>(g);
  return 0;
}

// The delayed kernels take at most (kTile * 64 + 64 * 64) elements of
// dynamic shared memory (b <= 64) beside their static arrays, which can
// pass 48 KB together at exactly 48 KB of dynamic memory: opt in always.
template <typename T>
int ns_delay_opt_in() {
  static bool done = false;
  if (done) return 0;
  const int smem = static_cast<int>((kTile * 64 + 64 * 64) * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(noswap_solve_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(noswap_update_kernel<T>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <typename T>
int run_cluster_noswap(T* A, int m, int w, int lda, int pivot, int live, const Plan& pl,
                       const int* used0, int* used, int* prow, int* info, int* list,
                       cudaStream_t stream, PanelStats* stats) {
  int err = ns_delay_opt_in<T>();
  if (err != 0) return err;
  const int steps = m < w ? m : w;
  for (int k0 = 0, blk = 0; k0 < steps; k0 += pl.b, ++blk) {
    const int nb = steps - k0 < pl.b ? steps - k0 : pl.b;
    // every earlier step consumed a row: this block holds live - k0 at most
    const int M = live - k0 > 1 ? live - k0 : 1;
    NsChainArgs<T> c;
    c.a = A;
    c.m = m;
    c.lda = lda;
    c.pivot = pivot;
    c.k0 = k0;
    c.nb = nb;
    c.ncol = pl.one_block ? w : nb;
    c.rows = (M + pl.C - 1) / pl.C;
    c.mask = k0 == 0 ? used0 : used;
    c.used0 = used0;
    c.used = used;
    c.list = list;
    c.prow = prow;
    c.info = info;
    c.trace = g_trace;
    c.steps = steps;
    c.blk = blk;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        chain_config(pl.C, chain_smem<T>(c.rows, pl.C, pl.B).total, stream, attr);
    cudaError_t e = cudaLaunchKernelEx(&cfg, ns_chain_kernel_for<T>(pl.B), c);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (pl.one_block) continue;
    NsDelayArgs<T> d;
    d.a = A;
    d.w = w;
    d.lda = lda;
    d.k0 = k0;
    d.nb = nb;
    d.prow = prow;
    d.list = list;
    d.used = used;
    const int cols = w - k0 - nb;
    if (cols > 0) {
      noswap_solve_kernel<T><<<(cols + kTile - 1) / kTile, kDelayThreads,
                               (kTile * nb + nb * nb) * sizeof(T), stream>>>(d);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid((cols + kTile - 1) / kTile, (pl.C * c.rows + kUpdRows - 1) / kUpdRows);
      noswap_update_kernel<T><<<grid, kDelayThreads, (kTile * nb + kUpdRows * nb) * sizeof(T),
                                stream>>>(d);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      ++stats->updates;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(void* a, int m, int w, int lda, int pivot, int live, int b, int C, const void* used0,
        void* prow, void* used, void* info, void* ws, void* iws, PanelStats* stats, int device,
        void* stream_) {
  *stats = PanelStats{};
  Plan pl;
  int err = full_plan<T>(m, w, live, b, C, device, &pl);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (pl.route == kRouteCluster) {
    return run_cluster_noswap<T>(static_cast<T*>(a), m, w, lda, pivot, live, pl,
                                 static_cast<const int*>(used0), static_cast<int*>(used),
                                 static_cast<int*>(prow), static_cast<int*>(info),
                                 static_cast<int*>(iws), stream, stats);
  }
  const int g = pl.grid;
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
  p.rows = (m + g - 1) / g;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_lu_noswap_kernel<T>), dim3(g),
      dim3(kThreads), args, static_cast<size_t>(w) * sizeof(T), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan of a launch on an (m, w) panel of elements of `elem_size` bytes
// (4 or 8) of which `live` rows are available (0 <= live <= m; m when the
// caller has no count), with block width `b` and cluster size `C` (0, 0:
// the launcher's choice; b < 0: the grid route; b >= w: one block).
// Fills out[kPlanInts] as write_plan says (no block's chain runs on the
// grid here).  Returns a cudaError_t code, 0 on success;
// cudaErrorInvalidConfiguration when an explicit (b, C) does not fit the
// card.
int rf_panel_lu_noswap_plan(int m, int w, int elem_size, int live, int b, int C, int device,
                            int* out) {
  Plan pl;
  const int err = elem_size == 8 ? full_plan<double>(m, w, live, b, C, device, &pl)
                                 : full_plan<float>(m, w, live, b, C, device, &pl);
  if (err == 0) write_plan(pl, out);
  return err;
}

// Factor the panel in place on `stream` with the plan of (live, b, C);
// `used0` and `used` are int32 (m,) and may not overlap; `stats` (host)
// gets the launch's PanelStats (the no-swap chain counts its delayed
// updates alone).  Returns a cudaError_t code (0 on success) for the
// launches; faults during the run (a mask with more available rows than
// `live` allows among them) surface at the next synchronisation.
int rf_panel_lu_noswap_f32(void* a, int m, int w, int lda, int pivot, int live, int b, int C,
                           const void* used0, void* prow, void* used, void* info, void* ws,
                           void* iws, PanelStats* stats, int device, void* stream) {
  return run<float>(a, m, w, lda, pivot, live, b, C, used0, prow, used, info, ws, iws, stats,
                    device, stream);
}

int rf_panel_lu_noswap_f64(void* a, int m, int w, int lda, int pivot, int live, int b, int C,
                           const void* used0, void* prow, void* used, void* info, void* ws,
                           void* iws, PanelStats* stats, int device, void* stream) {
  return run<double>(a, m, w, lda, pivot, live, b, C, used0, prow, used, info, ws, iws, stats,
                     device, stream);
}

// Phase trace of the cluster route's chain kernel, as rf_panel_lu_set_trace
// of csrc/panel_lu.cu (phase 5, the swap there, is empty here).
int rf_panel_lu_noswap_set_trace(void* buf) {
  g_trace = static_cast<long long*>(buf);
  return 0;
}

}  // extern "C"
