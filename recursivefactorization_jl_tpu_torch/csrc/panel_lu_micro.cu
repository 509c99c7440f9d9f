// Micro-blocked partial-pivot LU of an (m x w) panel, or of a whole matrix,
// on Hopper: two kernels from one template.
//
// Replaces the TPU kernels recursivefactorization_jl_tpu/ops/panel.py
// `_panel_kernel_shadow` (variant "shadow", here kShadow = true) and
// `_panel_kernel` (variant "basic", kShadow = false), both reached through
// `panel_factor_pallas`.  They compute the function of the package's plain
// version, ops/unblocked.py `micro_blocked_lu`.  With blocks of `micro`
// elimination steps (the last one ragged, none beyond min(m, w)):
//   * a step finds its pivot as csrc/panel_lu.cu does (first-occurrence
//     argmax of |a[i, k]| over rows i >= k, a NaN wins), swaps rows k and kp
//     across all w columns when the pivot is nonzero, scales the column
//     below the diagonal by r = 1/p, and applies its rank-1 update to the
//     columns k+1 .. p1-1 of its own block only;
//   * at the start of the next block the finished block [q0, p0) is applied
//     to the columns p0 .. w-1: a unit-lower solve of the rows [q0, p0)
//     (row i is eliminated from the rows below it before row i + 1), then
//     the rank-`micro` update a[i, c] -= sum_j l[i, j] * u[j, c] of the rows
//     i >= p0, where the sum starts at 0 and takes j = q0 .. p0-1 in turn;
//   * a fat panel (w > m) ends with the solve of the last block against the
//     columns m .. w-1.
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, and -fmad=false at build time) in exactly this
// order, so both kernels agree bitwise with each other and with the plain
// version.  The sum is computed here, by the kernel's own threads.
//
// What differs between the two.  "basic" reads and writes the current micro
// block in place in device memory.  "shadow" stages each thread block's own
// rows of the current micro block in shared memory (rows x micro elements,
// the counterpart of the TPU kernel's VMEM scratch, not transposed: a warp
// walks a row here) and writes them back when the block is finished; pivot
// search, scale and rank-1 updates then touch shared memory only.
//
// Design.  As in csrc/panel_lu.cu the panel is split by rows over a
// cooperative grid of up to one thread block per SM; block b owns rows
// [b*R, (b+1)*R) and is the only one that writes them during the steps.  A
// step has ONE grid barrier (candidates published, then every block reduces
// them to the same winner).  The delayed update adds TWO grid barriers per
// micro block:
//   B1  after the block's last step: its rows are final everywhere;
//       then the unit-lower solve, split by COLUMNS over all threads of the
//       grid (a column's solve is independent of the others; the micro x
//       micro triangle sits in shared memory, the column in thread-local
//       storage);
//   B2  the solved U block is visible everywhere; then every thread block
//       updates its own rows (a warp per row, U staged in shared memory in
//       tiles of kColTile columns, the row's multipliers broadcast by
//       shuffles).
// The next pivot search reads only rows its own thread block just updated,
// so a block-level barrier is enough there.  Barriers per micro block:
// micro + 2 (the unblocked kernel: micro).  Rows that another thread block
// may have written are read with __ldcg (from L2, never a stale L1 line).
//
// What bounds it.  The serial pivot chain, as in csrc/panel_lu.cu; the
// micro-blocking cuts the rank-1 work inside the chain from w to at most
// micro - 1 columns per row and step and moves the rest into one pass per
// block.  The block width is limited to kMicroMax steps (thread-local column
// of the solve, two registers of multipliers per lane in the update).

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
constexpr int kRowsMin = 8;    // fewest rows a block owns
constexpr int kMicroMax = 64;  // widest micro block
constexpr int kColTile = 64;   // columns of U staged per pass of the update

template <typename T>
struct MicroArgs {
  T* a;           // panel, row-major with row stride lda (unit column stride)
  int m, w, lda;
  int pivot;
  int micro;      // block width, 1 .. kMicroMax, at most min(m, w)
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

// Dynamic shared memory, in elements of T: the winner row (w), the tile of
// the boundary (the triangle of the solve, then the U tiles of the update)
// and, for the staged kernel, the block's rows of the micro block.
__host__ __device__ inline size_t tile_elems(int micro) {
  const int side = micro > kColTile ? micro : kColTile;
  return static_cast<size_t>(micro) * side;
}

template <typename T, bool kShadow>
__host__ __device__ inline size_t smem_bytes(int w, int micro, int rows) {
  size_t n = static_cast<size_t>(w) + tile_elems(micro);
  if (kShadow) n += static_cast<size_t>(rows) * micro;
  return n * sizeof(T);
}

template <typename T, bool kShadow>
__global__ void __launch_bounds__(kThreads)
panel_lu_micro_kernel(MicroArgs<T> p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* urow = reinterpret_cast<T*>(smem_raw);  // winner row, w entries
  T* tile = urow + p.w;                      // boundary scratch
  T* shadow = tile + tile_elems(p.micro);    // rows x micro (kShadow only)
  __shared__ T red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_kp, s_src;

  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = p.m, w = p.w, micro = p.micro;
  const size_t lda = static_cast<size_t>(p.lda);
  const int minmn = m < w ? m : w;
  const int r0 = b * p.rows;
  const int r1 = min(m, r0 + p.rows);
  int info = 0;  // kept by block 0, thread 0

  // Unit-lower solve of rows [q0, pe) against columns [pe, w), split by
  // columns over the grid.  Every thread block holds the triangle.
  auto solve_block = [&](int q0, int pe) {
    const int nb = pe - q0;
    for (int idx = tid; idx < nb * nb; idx += kThreads) {
      tile[idx] = __ldcg(p.a + (q0 + idx / nb) * lda + q0 + idx % nb);
    }
    __syncthreads();
    for (int c = pe + b * kThreads + tid; c < w; c += G * kThreads) {
      T u[kMicroMax];
      for (int r = 0; r < nb; ++r) u[r] = __ldcg(p.a + (q0 + r) * lda + c);
      for (int i = 0; i + 1 < nb; ++i) {
        const T ui = u[i];
        for (int r = i + 1; r < nb; ++r) {
          u[r] = rsub(u[r], rmul(tile[r * nb + i], ui));
        }
      }
      for (int r = 1; r < nb; ++r) p.a[(q0 + r) * lda + c] = u[r];
    }
  };

  // a[i, c] -= sum_j l[i, j] * u[j, c] for the block's own rows i >= p0 and
  // the columns c >= p0, j = q0 .. p0-1 in turn from an accumulator of 0.
  auto update_block = [&](int q0, int p0) {
    const int nb = p0 - q0;
    const int i0 = max(p0, r0);
    if (i0 >= r1) return;  // uniform over the thread block
    for (int c0 = p0; c0 < w; c0 += kColTile) {
      const int ct = min(kColTile, w - c0);
      __syncthreads();
      for (int idx = tid; idx < nb * ct; idx += kThreads) {
        const int j = idx / ct, cc = idx % ct;
        tile[j * kColTile + cc] = __ldcg(p.a + (q0 + j) * lda + c0 + cc);
      }
      __syncthreads();
      for (int i = i0 + warp; i < r1; i += kWarps) {
        T* row = p.a + i * lda;
        const T l_lo = lane < nb ? row[q0 + lane] : T(0);
        const T l_hi = lane + 32 < nb ? row[q0 + 32 + lane] : T(0);
        for (int cb = 0; cb < ct; cb += 32) {
          const int cc = min(cb + lane, ct - 1);
          T acc = T(0);
          for (int j = 0; j < nb; ++j) {
            const T l = __shfl_sync(kFull, j < 32 ? l_lo : l_hi, j & 31);
            acc = radd(acc, rmul(l, tile[j * kColTile + cc]));
          }
          if (cb + lane < ct) row[c0 + cc] = rsub(row[c0 + cc], acc);
        }
      }
    }
    __syncthreads();
  };

  for (int i = r0 + tid; i < r1; i += kThreads) p.perm[i] = i;
  __syncthreads();

  for (int k = 0; k < minmn; ++k) {
    const int p0 = (k / micro) * micro;
    const int p1 = min(p0 + micro, minmn);
    const int nbk = p1 - p0;

    if (k == p0) {
      if (k > 0) {
        const int q0 = p0 - micro;
        if (kShadow) {
          // the finished block goes back to the panel
          const int i0 = max(q0, r0);
          for (int idx = tid; idx < (r1 - i0) * micro && i0 < r1; idx += kThreads) {
            const int i = i0 + idx / micro, j = idx % micro;
            p.a[i * lda + q0 + j] = shadow[(i - r0) * micro + j];
          }
        }
        grid.sync();  // B1
        solve_block(q0, p0);
        grid.sync();  // B2
        update_block(q0, p0);
      }
      if (kShadow) {
        const int i0 = max(p0, r0);
        for (int idx = tid; idx < (r1 - i0) * nbk && i0 < r1; idx += kThreads) {
          const int i = i0 + idx / nbk, j = idx % nbk;
          shadow[(i - r0) * micro + j] = p.a[i * lda + p0 + j];
        }
      }
      __syncthreads();
    }

    // element (i, j) of the current micro block, i an own row >= p0
    auto mb = [&](int i, int j) -> T& {
      return kShadow ? shadow[(i - r0) * micro + (j - p0)] : p.a[i * lda + j];
    };
    // entry j of own row i >= p0, wherever it is current
    auto cur = [&](int i, int j) -> T& {
      return (kShadow && j >= p0 && j < p1) ? shadow[(i - r0) * micro + (j - p0)]
                                            : p.a[i * lda + j];
    };

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
        const T v = mag(mb(i, k));
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
        T* dst = crow + static_cast<size_t>(b) * w;
        for (int j = tid; j < w; j += kThreads) dst[j] = cur(ci, j);
      }
    }
    if (own_k) {
      for (int j = tid; j < w; j += kThreads) krow[j] = cur(k, j);
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
        for (int j = tid; j < w; j += kThreads) cur(k, j) = urow[j];
        if (tid == 0) p.perm[k] = __ldcg(cpid + s_src);
      }
      if (kp >= r0 && kp < r1) {
        for (int j = tid; j < w; j += kThreads) cur(kp, j) = __ldcg(krow + j);
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
      T l = T(0);
      if (lane == 0) {
        l = mb(i, k);
        if (nz) {
          l = rmul(l, r);
          mb(i, k) = l;
        }
      }
      l = __shfl_sync(kFull, l, 0);
      for (int j = k + 1 + lane; j < p1; j += 32) {
        mb(i, j) = rsub(mb(i, j), rmul(l, urow[j]));
      }
    }
    __syncthreads();
  }

  const int q_last = minmn > 0 ? ((minmn - 1) / micro) * micro : 0;
  if (kShadow) {
    const int i0 = max(q_last, r0);
    const int nbl = minmn - q_last;
    for (int idx = tid; idx < (r1 - i0) * nbl && i0 < r1; idx += kThreads) {
      const int i = i0 + idx / nbl, j = idx % nbl;
      p.a[i * lda + q_last + j] = shadow[(i - r0) * micro + j];
    }
  }
  if (w > minmn) {
    // fat panel: the last block against the columns m .. w-1 (no row is
    // left below it to update)
    grid.sync();
    solve_block(q_last, minmn);
  }
  if (b == 0 && tid == 0) *p.info = info;
}

template <typename T, bool kShadow>
int grid_for(int m, int w, int micro, int device, int* grid_out, int* rows_out) {
  const int minmn = m < w ? m : w;
  if (micro < 1 || micro > kMicroMax || micro > minmn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int g = sms;  // one block per SM at most: the barrier is the cost
  const int by_rows = (m + kRowsMin - 1) / kRowsMin;
  if (by_rows < g) g = by_rows;
  if (g < 1) g = 1;
  const int rows = (m + g - 1) / g;
  g = (m + rows - 1) / rows;
  const size_t smem = smem_bytes<T, kShadow>(w, micro, rows);
  const void* kernel = reinterpret_cast<const void*>(panel_lu_micro_kernel<T, kShadow>);
  err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, panel_lu_micro_kernel<T, kShadow>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1 || per_sm * sms < g) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  *rows_out = rows;
  *grid_out = g;
  return 0;
}

template <typename T, bool kShadow>
int launch(void* a, int m, int w, int lda, int pivot, int micro, void* piv,
           void* perm, void* info, void* ws, void* iws, int grid, int device,
           void* stream) {
  int g = 0, rows = 0;
  int err = grid_for<T, kShadow>(m, w, micro, device, &g, &rows);
  if (err != 0) return err;
  if (g != grid) return static_cast<int>(cudaErrorInvalidValue);
  MicroArgs<T> p;
  p.a = static_cast<T*>(a);
  p.m = m;
  p.w = w;
  p.lda = lda;
  p.pivot = pivot;
  p.micro = micro;
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
      reinterpret_cast<void*>(panel_lu_micro_kernel<T, kShadow>), dim3(g),
      dim3(kThreads), args, smem_bytes<T, kShadow>(w, micro, rows),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The widest micro block the kernels take.
int rf_panel_lu_micro_max() { return kMicroMax; }

// Grid size of a launch on an (m, w) panel of elements of `elem_size` bytes
// (4 or 8) with blocks of `micro` steps (1 .. 64, at most min(m, w)), for the
// staged kernel (shadow != 0) or the in-place one; the caller sizes the
// workspaces from it:
//   ws  (elements of the panel's type): 2*G + 2*G*w + 2*w
//   iws (int32):                        4*G + 2
// Returns G >= 1, or minus a cudaError_t code.
int rf_panel_lu_micro_grid(int m, int w, int elem_size, int micro, int shadow,
                           int device) {
  int g = 0, rows = 0, err = 0;
  if (elem_size == 8) {
    err = shadow ? grid_for<double, true>(m, w, micro, device, &g, &rows)
                 : grid_for<double, false>(m, w, micro, device, &g, &rows);
  } else {
    err = shadow ? grid_for<float, true>(m, w, micro, device, &g, &rows)
                 : grid_for<float, false>(m, w, micro, device, &g, &rows);
  }
  return err != 0 ? -err : g;
}

// Factor the panel in place on `stream`.  Each returns a cudaError_t code
// (0 on success) for the launch; faults during the run surface at the next
// synchronisation.
#define RF_MICRO_ENTRY(name, T, kShadow)                                      \
  int name(void* a, int m, int w, int lda, int pivot, int micro, void* piv,   \
           void* perm, void* info, void* ws, void* iws, int grid, int device, \
           void* stream) {                                                    \
    return launch<T, kShadow>(a, m, w, lda, pivot, micro, piv, perm, info,    \
                              ws, iws, grid, device, stream);                 \
  }

RF_MICRO_ENTRY(rf_panel_lu_shadow_f32, float, true)
RF_MICRO_ENTRY(rf_panel_lu_shadow_f64, double, true)
RF_MICRO_ENTRY(rf_panel_lu_basic_f32, float, false)
RF_MICRO_ENTRY(rf_panel_lu_basic_f64, double, false)

#undef RF_MICRO_ENTRY

}  // extern "C"
