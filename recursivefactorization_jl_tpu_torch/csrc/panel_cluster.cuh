// The cluster route of the panel kernels: the pivot chain of each block of
// b columns on one thread-block cluster, then the delayed pass on the whole
// card, most of it beside the next block's chain (run_cluster's carry).
// csrc/panel_lu.cu (f32 / f64, main path and offset kernel; f32
// under panel_boundary_precision='bf16x3' with the trailing update split
// into bf16 halves on the tensor cores), csrc/panel_lu_c64.cu (complex64 /
// complex128) and csrc/panel_lu_micro.cu (the micro-blocked kernels: blocks
// of exactly `micro` steps, the trailing update summed first) instantiate
// it; csrc/panel_lu_noswap.cu brings its
// own chain and delayed kernels and takes the plan from here.  The design
// is described at the top of csrc/panel_lu.cu.
//
// The chain kernel (panel_chain_kernel) runs each step with a one-column
// look-ahead: the step's rank-1 update reaches only the next step's
// column, scaled and searched by one thread per row, and the rows the
// next step publishes; the rest waits for the next step, whose threads
// apply it after the step's sends and before their wait for the data,
// while the candidate exchange is in flight.  The exchange completes
// per-parity mbarriers with its data (st.async), with no cluster barrier
// per step.  Every instantiation takes both (the real and complex
// elements, the main-path, offset, micro-blocked and bf16x3 forms); the
// launcher counts the launches that do (a cluster of C > 1: with one CTA
// the wait is a __syncthreads()).
//
// The two blocked forms (the bf16x3 form and the micro-blocked kernels)
// take any block width b and any panel height.  A block whose live rows do
// not fit a cluster at its slab width (or whose b passes the widest slab,
// 512) runs its chain on the grid instead (panel_grid_chain_kernel: one
// cooperative grid, one grid barrier per step, the block's columns in
// device memory), which writes the same row moves and computes the same
// bits; the delayed pass follows unchanged.  The delayed kernels stage
// their operands in chunks, so they take any b too.
//
// The templates take the panel's element type T: float, double, or a
// complex (re, im) pair, float2 or double2.  rf_common.cuh gives each kind
// its arithmetic: the magnitude that orders the pivots (|a|, or CABS1
// |re| + |im|), the reciprocal of the pivot, the product and the
// difference, each product, sum, difference and quotient rounded once in
// the plain versions' order.  R = Elem<T>::real is the magnitude's type.
//
// The NaN rule differs between the two kinds, as it does between their
// plain versions.  Real panels (ops/unblocked.py `unblocked_lu`): a NaN
// candidate wins, the first NaN row.  Complex panels (`unblocked_lu_cabs1`):
// a NaN among a step's candidates makes the pivot row m - 1, the last row
// of the panel.  Every CTA of the cluster reduces the same candidates, so
// every CTA sees the NaN: then the owner of row m - 1 publishes that row
// (brought up to date in the look-ahead column too) and one more full
// cluster barrier, taken by all CTAs together, precedes the swap.  Steps
// without a NaN pay nothing for the rule.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "rf_common.cuh"

namespace cg = cooperative_groups;

// What a launch of a panel kernel tells its caller, in host memory; every
// entry point zeroes it first.  `lookaheads`: the chain launches on a
// cluster of C > 1, each of which takes the one-column look-ahead and
// exchanges its candidates on the per-parity mbarriers; `grid_blocks`: the
// blocks whose chain ran on the grid (panel_grid_chain_kernel); `updates`:
// the launches of the delayed trailing update; `carried`: the chain launches
// that took the previous block's delayed pass in their own columns at load
// while the rest of that pass ran beside them (run_cluster).
// ops/_kernels.py `PanelStats` mirrors it.  Outside the unnamed namespace:
// the extern "C" entry points take it, and a type with internal linkage
// would keep them out of the library's symbols.
struct PanelStats {
  int lookaheads, grid_blocks, updates, carried;
};

namespace {

using namespace rf;

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
constexpr int kMaxDevices = 16;

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
  // the previous block's delayed pass in this block's columns, taken at load
  // (run_cluster's carry): its row moves (null: no carry), first step and
  // steps, and its update's form (sum first: kSumFirst, else step order)
  const int* pmoved;
  int pk0, pnb, sum_first;
  // optional phase trace (the set_trace entry points): kChainTracePhases
  // clock64() stamps per step from CTA 0 (threads 0 and 32), then per block
  // the kernel's first and last %globaltimer (ns) and clock64()
  long long* trace;
  int steps, blk;
};

// stamps per step of the chain kernel's trace (panel_chain_kernel; the
// no-swap chain of csrc/panel_lu_noswap.cu keeps its own kTracePhases)
constexpr int kChainTracePhases = 9;
constexpr int kTracePhases = 7;
long long* g_trace = nullptr;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A step's pivot candidate as a CTA publishes it to every CTA.
template <typename R>
struct Cand {
  R val;     // its magnitude, -1 for none
  int idx;   // its global row, INT_MAX for none
  int pid;   // the perm id travelling with the row
  int src;   // the row it held when the block began
};

// Byte offsets of a chain CTA's dynamic shared memory: the slab (rows x B,
// row stride B; `padded`: one more element after every slab_rpw rows, see
// slab_rpw), the exchange slots ([2][C] candidate rows, [2] copies of
// row gk, for complex panels one copy of row m - 1, [2][C] candidates,
// [2] (pid, src) of row gk, for complex panels (pid, src) of row m - 1),
// then the slab rows' perm ids and origins.  Real panels have the layout
// they had before complex ones shared it.
struct ChainSmem {
  size_t crow, krow, lrow, cand, kinf, linf, pid, src, total;
};

// The padded slab (panel_chain_kernel) puts one spare element after every
// slab_rpw rows, the rows that a warp's groups read side by side (128 bytes
// of a row-wise access), so that those reads stay on distinct banks and a
// column read by consecutive rows on consecutive lanes does too.
__host__ __device__ constexpr int slab_rpw(int B, int elem_bytes) {
  return 128 / ((B < 32 ? B : 32) * elem_bytes) > 1 ? 128 / ((B < 32 ? B : 32) * elem_bytes) : 1;
}

template <typename T>
__host__ __device__ inline ChainSmem chain_smem(int rows, int C, int B, bool padded = false) {
  constexpr size_t sz = sizeof(T);
  constexpr bool last = Elem<T>::complex;
  ChainSmem s;
  size_t o = static_cast<size_t>(rows) * B * sz;
  if (padded) {
    const int rpw = slab_rpw(B, static_cast<int>(sz));
    o += static_cast<size_t>((rows + rpw - 1) / rpw) * sz;
    o = (o + 15) & ~static_cast<size_t>(15);
  }
  s.crow = o; o += static_cast<size_t>(2) * C * B * sz;
  s.krow = o; o += static_cast<size_t>(2) * B * sz;
  s.lrow = o; o += last ? static_cast<size_t>(B) * sz : 0;
  s.cand = o; o += static_cast<size_t>(2) * C * sizeof(Cand<typename Elem<T>::real>);
  s.kinf = o; o += 16;
  s.linf = o; o += last ? 8 : 0;
  s.pid = o; o += static_cast<size_t>(rows) * 4;
  s.src = o; o += static_cast<size_t>(rows) * 4;
  s.total = o;
  return s;
}

// The carry's shared memory (panel_chain_kernel taking the previous block's
// delayed pass at load), past the chain's own on 16 bytes: that block's U
// rows in this block's columns ([pnb][B]), its multipliers L_jj and the
// multipliers of this CTA's `rows` slab rows ([pnb + rows][pnb + 1]: a
// column of them read by consecutive rows stays on distinct banks), then
// the rows its U rows came from ([pnb]).  At most kCarryMax steps: a lane
// per U row in the solve.
constexpr int kCarryMax = 32;

__host__ __device__ constexpr size_t carry_base(size_t total) { return (total + 15) & ~size_t{15}; }

template <typename T>
__host__ __device__ constexpr size_t carry_smem(int pnb, int B, int rows) {
  return (static_cast<size_t>(pnb) * B + static_cast<size_t>(pnb + rows) * (pnb + 1)) *
             sizeof(T) +
         static_cast<size_t>(pnb) * 4;
}

// The bytes a chain CTA receives in step kk of a block on a cluster of C > 1
// (panel_chain_kernel: what its exchange mbarrier of the step's parity
// expects), for M slab rows, `rows` per CTA and slab width B: every CTA's
// candidate (empty where it has none; without pivoting it only paces the
// slots), with pivoting the candidate row of every CTA that holds a slab
// row at or below row kk (such a CTA always has a candidate), and row kk
// with its perm id and origin.  A function of the plan and the step,
// never of the data.
template <typename T>
__host__ __device__ inline unsigned chain_exchange_bytes(int M, int rows, int C, int B, int kk,
                                                         bool pivot) {
  const int holders = (M + rows - 1) / rows;  // the CTAs that hold a slab row
  const int live = (holders < C ? holders : C) - kk / rows;
  const size_t row = static_cast<size_t>(B) * sizeof(T);
  return static_cast<unsigned>(C * sizeof(Cand<typename Elem<T>::real>) + row + 8 +
                               (pivot ? live * row : 0));
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

// The cluster barrier split in two (PTX barrier.cluster, sm_90): a thread's
// arrive (here relaxed: it releases nothing) and its wait, which returns
// once every thread of the cluster has arrived.  Every thread takes both,
// in pairs, as it would take cluster.sync(); a whole warp at once
// (.aligned: the warp is converged first).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The chain's exchange (PTX, sm_90): an mbarrier in each CTA's shared
// memory that the step's data completes.  The receiver arms it with the
// bytes it expects (arrive.expect_tx); every sender's st.async to it
// counts its bytes off (complete_tx); its wait returns once the bytes and
// the arrivals are in, and acquires the data at cluster scope.  Addresses
// are 32-bit shared-window ones; `remote` maps one to cluster CTA d.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned remote(unsigned a, int d) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(d));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// one arrival that releases this thread's earlier writes; the _tx form
// raises the bytes the phase expects by tx first
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(tx)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of `parity` to complete.  A phase that never does (a
// byte count that disagrees with what was sent) traps after a second of
// %globaltimer, so the launch fails instead of spinning: the timer is read
// only once the first try has failed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 1000000000ll) __trap();
  }
}
// st.async of 16 / 8 bytes to cluster address a, completing their bytes on
// the mbarrier at cluster address bar (in the same CTA as a)
__device__ __forceinline__ void st_async16(unsigned a, const uint4& w, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(a),
      "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async8(unsigned a, unsigned x, unsigned y, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(
          a),
      "r"(x), "r"(y), "r"(bar)
      : "memory");
}
// Store x (16 bytes on 16, or a multiple of 8 on 8) at `ptr` in the shared
// memory of cluster CTA d by st.async, completing on its mbarrier `bar`
// (this CTA's address of it); with a cluster of one a plain store.
template <typename V>
__device__ __forceinline__ void put_async(int C, V* ptr, int d, const V& x, unsigned bar) {
  static_assert(sizeof(V) % 8 == 0, "st.async moves 8 or 16 bytes");
  if (C == 1) {
    *ptr = x;
    return;
  }
  const unsigned a = remote(smem_u32(ptr), d), b = remote(bar, d);
  if constexpr (sizeof(V) == 16) {
    uint4 w;
    memcpy(&w, &x, 16);
    st_async16(a, w, b);
  } else {
    unsigned w[sizeof(V) / 4];
    memcpy(w, &x, sizeof(V));
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(V) / 4); i += 2) {
      st_async8(a + 4 * i, w[i], w[i + 1], b);
    }
  }
}

// A warp's best candidate by `better` in two or three redux.sync: each
// lane's (v, i) becomes an unsigned key ordered as `better` orders values
// (0 for none, a magnitude's bits + 1, every NaN one key above all numbers;
// magnitudes are >= 0), the largest key wins, then the smallest row among
// the lanes that hold it.  Every lane ends with the winner.  Double
// magnitudes take their key in two halves.
__device__ __forceinline__ void warp_best_key(float& v, int& i) {
  const unsigned k = i == INT_MAX ? 0u : isnan(v) ? 0xffffffffu : __float_as_uint(v) + 1u;
  const unsigned mk = __reduce_max_sync(kFull, k);
  i = static_cast<int>(__reduce_min_sync(kFull, k == mk ? static_cast<unsigned>(i) : ~0u));
  v = mk == 0u ? -1.0f : mk == 0xffffffffu ? __int_as_float(0x7fffffff) : __uint_as_float(mk - 1u);
}

__device__ __forceinline__ void warp_best_key(double& v, int& i) {
  const unsigned long long k =
      i == INT_MAX ? 0ull : isnan(v) ? ~0ull : __double_as_longlong(v) + 1ull;
  const unsigned hi = static_cast<unsigned>(k >> 32), lo = static_cast<unsigned>(k);
  const unsigned mh = __reduce_max_sync(kFull, hi);
  const unsigned ml = __reduce_max_sync(kFull, hi == mh ? lo : 0u);
  const bool top = hi == mh && lo == ml;
  i = static_cast<int>(__reduce_min_sync(kFull, top ? static_cast<unsigned>(i) : ~0u));
  const unsigned long long mk = (static_cast<unsigned long long>(mh) << 32) | ml;
  v = mk == 0ull ? -1.0 : mk == ~0ull ? __longlong_as_double(0x7fffffffffffffffll)
                                      : __longlong_as_double(static_cast<long long>(mk - 1ull));
}

// One element from device to shared memory by cp.async (4, 8 or 16 bytes,
// as the element's size and alignment); cp_async_wait waits for this
// thread's copies.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = smem_u32(dst);
  if constexpr (sizeof(T) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  } else if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// carry_in's update of the slab rows: each row takes the previous block's
// pnb rank-1 updates in step order (kSumFirst: an accumulator from 0 takes
// each product, then one difference), CK columns (32 bytes; 64 of float64)
// per item, consecutive threads on consecutive rows.  Lr: the rows'
// multipliers, [own][pnb + 1]; Us: the solved U rows, [pnb][B].
template <typename T, int B, bool kSumFirst>
__device__ __forceinline__ void carry_update(T* slab, const T* Lr, const T* Us, int own, int ncol,
                                             int pnb) {
  constexpr int RPW = slab_rpw(B, sizeof(T));
  constexpr int CK = std::is_same<T, double>::value ? 8 : 32 / static_cast<int>(sizeof(T));
  constexpr int NV = CK * static_cast<int>(sizeof(T)) / 16;  // 16-byte loads of U a step
  const int nck = (ncol + CK - 1) / CK;
  for (int e = threadIdx.x; e < own * nck; e += kChainThreads) {
    const int q = e % own, c0 = e / own * CK;
    const T* lq = Lr + q * (pnb + 1);
    T* rq = slab + q * B + q / RPW;
    T x[CK], acc[CK];
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      x[j] = c0 + j < ncol ? rq[c0 + j] : T{};
      acc[j] = T{};
    }
    for (int s = 0; s < pnb; ++s) {
      const T l = lq[s];
      uint4 w[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) w[v] = reinterpret_cast<const uint4*>(Us + s * B + c0)[v];
      T u[CK];
      memcpy(u, w, sizeof(u));
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        if constexpr (kSumFirst) {
          acc[j] = radd(acc[j], rmul(l, u[j]));
        } else {
          x[j] = rsub(x[j], rmul(l, u[j]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      if constexpr (kSumFirst) x[j] = rsub(x[j], acc[j]);
      if (c0 + j < ncol) rq[c0 + j] = x[j];
    }
  }
}

// The chain's slab load with the previous block's delayed pass in this
// block's columns, as its two delayed kernels do it there (run_cluster's
// carry): the rows its moves brought, its U rows solved in step order, then
// its rank-pnb update of the slab rows in step order (sum_first: an
// accumulator from 0 takes each product, then one difference).  Every CTA
// reads the rows it needs from device memory, which no CTA writes before
// every CTA has sent its step-0 candidate, so after every load; CTA 0
// writes the U rows back at the end.  Two rounds of copies: what does not
// depend on the moves (the slab in place, its perm ids, the multipliers,
// the moves themselves), then the moved slab rows and the U rows from where
// they came (two copies to one address are ordered only by a wait between
// them).  Not inlined, so that its registers leave the step loop's as they
// were.
template <typename T, int B>
__device__ __noinline__ void carry_in(const T* a, size_t lda, const int* perm, const int* pmoved,
                                      int pk0, int pnb, int sum_first, int pr0, int r0, int s0,
                                      int own, int k0, int ncol, T* slab, int* pid, int* src, T* Us,
                                      int* ufrom) {
  constexpr int RPW = slab_rpw(B, sizeof(T));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = pnb + 1;
  T* Ls = Us + pnb * B;  // L_jj's rows, then this CTA's slab rows' ([pnb + own][ld])
  T* Lr = Ls + pnb * ld;
  auto row = [&](int q) { return slab + q * B + q / RPW; };
  // round 1: the moves (at most 2 pnb pairs) in registers, the rest by cp.async
  int mr = -1, mf = 0;
  if (tid < 2 * pnb && tid < pmoved[0]) {
    mr = pmoved[1 + 2 * tid];
    mf = pmoved[2 + 2 * tid];
  }
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol) cp_async(row(q) + c, a + (r0 + s0 + q) * lda + k0 + c);
  }
  for (int e = tid; e < (pnb + own) * kCarryMax; e += kChainThreads) {
    const int t = e / kCarryMax, s = e % kCarryMax;
    const int r = t < pnb ? pr0 + t : r0 + s0 + t - pnb;
    if (s < pnb) cp_async(Ls + t * ld + s, a + r * lda + pk0 + s);
  }
  for (int q = tid; q < own; q += kChainThreads) {
    cp_async(pid + q, perm + r0 + s0 + q);  // the slab rows' perm ids
    src[q] = -1;
  }
  for (int t = tid; t < pnb; t += kChainThreads) ufrom[t] = pr0 + t;
  cp_async_wait();  // before round 2 copies a moved row over its slot
  __syncthreads();
  if (mr >= 0) {
    const int q = mr - r0 - s0;
    if (mr < r0) {
      ufrom[mr - pr0] = mf;
    } else if (q >= 0 && q < own) {
      src[q] = mf;
    }
  }
  __syncthreads();
  // round 2: the rows that moved into the slab, the U rows
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol && src[q] >= 0) cp_async(row(q) + c, a + src[q] * lda + k0 + c);
  }
  for (int e = tid; e < pnb * B; e += kChainThreads) {
    const int t = e / B, c = e % B;
    if (c < ncol) {
      cp_async(Us + e, a + ufrom[t] * lda + k0 + c);
    } else {
      Us[e] = T{};
    }
  }
  cp_async_wait();
  __syncthreads();
  // U row t takes steps 0 .. t - 1 in order: a warp per column, lane t
  // holding row t
  for (int c = warp; c < ncol; c += kChainWarps) {
    T x = lane < pnb ? Us[lane * B + c] : T{};
    for (int s = 0; s + 1 < pnb; ++s) {
      const T us = shfl(x, s, 32);
      if (lane > s && lane < pnb) x = rsub(x, rmul(Ls[lane * ld + s], us));
    }
    if (lane < pnb) Us[lane * B + c] = x;
  }
  __syncthreads();
  // the slab rows' update, CK columns per item, consecutive threads on
  // consecutive rows
  if constexpr (!Elem<T>::complex) {
    if (sum_first) {
      carry_update<T, B, true>(slab, Lr, Us, own, ncol, pnb);
      return;
    }
  }
  carry_update<T, B, false>(slab, Lr, Us, own, ncol, pnb);
}

// The pivot chain of one block on one cluster (see the note at the top of
// csrc/panel_lu.cu).  Three thread mappings:
//   groups  a group of G = min(B, 32) lanes owns slab rows grp, grp + NG,
//           ...; lane li owns columns li, li + G, ...: the swap (and the
//           row published after a complex NaN candidate: lane l sends
//           columns l % G + 32 t, its u[t]);
//   update  the same groups of the warps between the two sending warps
//           (NGD of them): the deferred update;
//   rows    thread t owns slab rows t, t + 512, ...: the look-ahead column
//           and the candidate search.
// The slab is padded (slab_rpw) so that both read shared memory on
// distinct banks.
//
// One-column look-ahead: step kk's rank-1 update reaches column kk + 1 in
// step kk (the row threads scale column kk, bring column kk + 1 up to date
// and search it) and the rest of the row in step kk + 1: column kk + 2 as
// that step's look-ahead column, the columns past it in the deferred pass,
// which the warps between the two sending warps run before their wait,
// inside the candidate exchange (the sending warps wait for the data
// alone: they publish last, and a share of the update behind their sends
// would set the step's pace).  The rows that step kk + 1 publishes (the
// CTA's candidate, row gk + 1) take it first, in all their columns > kk + 1,
// in the sending warp, which writes them back; the deferred pass and the
// look-ahead skip them.  What a thread touches after its wait was not
// written in the step by a thread that may still be in its deferred share
// (the swap: rows gk and kp, which are the rows the deferred pass skips,
// kp being its CTA's candidate; the look-ahead: columns kk and kk + 1,
// which the deferred pass leaves alone) or was written back by a sending
// warp before its arrival (below).
//
// The exchange (C > 1): each CTA has two mbarriers, one per step parity,
// the parity of the double-buffered slots.  Every remote store of a step is
// an st.async that completes its bytes on the receiver's barrier of the
// step's parity: warp 0 sends the CTA's candidate to every CTA (always,
// empty without one: the candidates pace the slots, see below), its row
// where it has one, and row gk where that is the candidate; the owner's
// last warp sends row gk otherwise, with its (perm id, origin).  No sender
// waits for its stores.  The barrier expects two arrivals a phase, one by
// each of those two warps after it has written its rows back and sent
// them: warp 0's raises the phase's byte count by chain_exchange_bytes (a
// function of the plan and the step), the last warp's by nothing.  A
// thread's wait (try_wait.parity.acquire.cluster) returns once both have
// arrived and every byte has landed, and acquires both: the data, and the
// rows the two warps wrote back (a __syncwarp orders a warp's lanes before
// its arriving lane).  That is all the CTA-local order the exchange needs:
// no named barrier, no __syncthreads() beyond the reduction's.  A count
// that disagreed with what was sent would trap in the bounded wait
// (mbar_wait), not spin.
//
// The slots stay safe without a barrier between CTAs: a slot of parity par
// is rewritten two steps later.  A CTA sends step kk + 2's data only after
// its wait of step kk + 1, which needs every CTA's candidate of step kk + 1;
// each CTA sends that only after its reduction's __syncthreads() of step
// kk + 1, by which all its threads have left step kk and its reads of the
// parity's slots (the last pivot row's slot, read once more while step
// kk + 1's rows are written back, is read by the sending warp before it
// sends).  The reductions' per-warp slots are double-buffered by parity for
// the same reason: a warp may start step kk + 1 while another still reads
// step kk's.  The mbarriers are set up at entry, before the cluster barrier
// that every CTA passes before its first remote store; the complex NaN rule
// keeps its cluster.sync(), and so does the kernel's exit.  A cluster of one
// waits at a __syncthreads() and stores plainly.
template <typename T, int B>
__global__ void __launch_bounds__(kChainThreads)
panel_chain_kernel(ChainArgs<T> p) {
  using R = typename Elem<T>::real;
  constexpr bool kLastOnNaN = Elem<T>::complex;
  constexpr int G = B < 32 ? B : 32;
  constexpr int PER = B / G;
  constexpr int NG = kChainThreads / G;
  // a row published after a NaN candidate: lane l sends columns
  // l % G + 32 t (t < PER) to the CTAs l / G, l / G + DSTEP, ...
  constexpr int DSTEP = 32 / G;
  // any other published row goes in V pieces of 16 bytes (E16 elements):
  // lane l sends piece l % V to the CTAs l / V, l / V + DV, ... (V <= 32),
  // or pieces l, l + 32, ... (NCH of them) to every CTA
  constexpr int E16 = 16 / static_cast<int>(sizeof(T));
  constexpr int V = B / E16;
  constexpr int NCH = V > 32 ? V / 32 : 1;
  constexpr int DV = V > 32 ? 1 : 32 / V;
  constexpr int RPW = slab_rpw(B, sizeof(T));
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R red_val[2][kChainWarps];
  __shared__ int red_idx[2][kChainWarps];
  __shared__ __align__(8) unsigned long long xbar[2];  // the exchange's mbarriers

  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int R_ = p.rows;
  const ChainSmem L = chain_smem<T>(R_, C, B, true);
  T* slab = reinterpret_cast<T*>(smem_raw);
  T* crow = reinterpret_cast<T*>(smem_raw + L.crow);
  T* krow = reinterpret_cast<T*>(smem_raw + L.krow);
  T* lrow = reinterpret_cast<T*>(smem_raw + L.lrow);
  Cand<R>* cand = reinterpret_cast<Cand<R>*>(smem_raw + L.cand);
  int* kinf = reinterpret_cast<int*>(smem_raw + L.kinf);
  int* linf = reinterpret_cast<int*>(smem_raw + L.linf);
  int* pid = reinterpret_cast<int*>(smem_raw + L.pid);
  int* src = reinterpret_cast<int*>(smem_raw + L.src);
  // slab row q, padded
  auto row = [&](int q) { return slab + q * B + q / RPW; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / G, li = tid % G;
  const size_t lda = static_cast<size_t>(p.lda);
  const int nb = p.nb, ncol = p.ncol, k0 = p.k0;
  const int r0 = p.ofs + k0;           // global row of slab row 0
  const int M = p.m - r0;              // slab rows
  const int s0 = rank * R_;            // this CTA's first slab row
  const int own = max(0, min(M, s0 + R_) - s0);
  const bool first = k0 == 0;
  const unsigned bar0 = smem_u32(xbar);  // parity par's barrier: bar0 + 8 par

  if (C > 1) {
    if (tid == 0) {
      mbar_init(bar0, 2);
      mbar_init(bar0 + 8, 2);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_arrive_relaxed();  // waited for after the slab is loaded
  }
  // launched early behind the previous chain (run_cluster's carry): nothing
  // of device memory before that chain has completed
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (first) {  // the rows above the offset never move
    for (int i = rank * kChainThreads + tid; i < p.ofs; i += C * kChainThreads) p.perm[i] = i;
  }
  // the carry's shared memory (carry_smem) past the chain's own: the
  // previous block's U rows first
  auto carried_u = [&]() { return reinterpret_cast<T*>(smem_raw + carry_base(L.total)); };
  if (p.pmoved != nullptr) {
    const int pnb = p.pnb;
    T* Us = carried_u();
    carry_in<T, B>(p.a, lda, p.perm, p.pmoved, p.pk0, pnb, p.sum_first, p.ofs + p.pk0, r0, s0,
                   own, k0, ncol, slab, pid, src, Us,
                   reinterpret_cast<int*>(Us + pnb * B + (pnb + R_) * (pnb + 1)));
  } else {
    for (int e = tid; e < own * B; e += kChainThreads) {
      const int q = e / B, c = e % B;
      if (c < ncol) row(q)[c] = p.a[(r0 + s0 + q) * lda + k0 + c];
    }
    for (int q = tid; q < own; q += kChainThreads) {
      const int r = r0 + s0 + q;
      pid[q] = first ? r : p.perm[r];
    }
  }
  for (int q = tid; q < own; q += kChainThreads) src[q] = r0 + s0 + q;
  if (C > 1) cluster_wait();  // every CTA's barriers are set up
  __syncthreads();

  // step 0's candidate, by the row threads
  R best = R(-1);
  int bi = INT_MAX;
  if (p.pivot) {
    for (int q = tid; q < own; q += kChainThreads) {
      const R v = mag(row(q)[0]);
      if (better(v, r0 + s0 + q, best, bi)) { best = v; bi = r0 + s0 + q; }
    }
  }
  int info = 0;
  if (rank == 0 && tid == 0 && !first) info = *p.info;
  // the last step's pivot row: in this thread's group columns (u), and its
  // entry in the column after next (un2: step kk's look-ahead column takes
  // step kk - 1's update too)
  T u[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) u[j] = T{};
  T un2 = T{};
  const T* uprev = nullptr;  // the last pivot row's slot, for the rows published next

  // step kd's rank-1 update of this CTA's slab rows below row kd in the
  // columns >= cmin, rows qx and qy excepted (they took it early); the
  // group mapping over the warps between the two sending warps (warp 0 and
  // the last; NGD groups, dgrp this thread's), two rows per pass
  constexpr int NGD = (kChainThreads - 64) / G;
  const int dgrp = (tid - 32) / G;
  const bool dwarp = warp > 0 && warp < kChainWarps - 1;
  auto deferred = [&](int kd, int cmin, int qx, int qy) {
    if (!dwarp) return;
    bool act[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = li + j * G;
      act[j] = c >= cmin && c < ncol;
    }
    for (int q0 = max(0, kd + 1 - s0) / NGD * NGD; q0 < own; q0 += 2 * NGD) {
      const int qa = q0 + dgrp, qb = qa + NGD;
      const bool ona = qa < own && s0 + qa > kd && qa != qx && qa != qy;
      const bool onb = qb < own && s0 + qb > kd && qb != qx && qb != qy;
      T* ra = row(qa);
      T* rb = row(qb);
      const T la = ona ? ra[kd] : T{};
      const T lb = onb ? rb[kd] : T{};
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (!act[j]) continue;
        const int c = li + j * G;
        if (ona) ra[c] = rsub(ra[c], rmul(la, u[j]));
        if (onb) rb[c] = rsub(rb[c], rmul(lb, u[j]));
      }
    }
  };

  const bool tr = p.trace != nullptr && rank == 0 && (tid == 0 || tid == 32);
  long long* stamps = tr ? p.trace + static_cast<size_t>(k0) * kChainTracePhases : nullptr;
  long long* ends =
      tr ? p.trace + static_cast<size_t>(p.steps) * kChainTracePhases + 4 * p.blk : nullptr;
  if (tr && tid == 0) { ends[0] = global_ns(); ends[1] = clock64(); }
#define RF_STAMP(phase) \
  if (tr && tid == 0) stamps[kk * kChainTracePhases + (phase)] = clock64()

  for (int kk = 0; kk < nb; ++kk) {
    const int par = kk & 1;
    const int gk = r0 + kk;
    const int owner = kk / R_;  // the CTA that holds slab row kk
    const int slot = par * C + rank;
    const bool late = kk > 0;   // step kk - 1's update is due in columns > kk
    // the next chain may launch now and wait for this one's end
    if (kk == nb - 1) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    RF_STAMP(0);

    // ---- reduce the CTA's candidate ----------------------------------------
    // the row threads hold their rows' candidates in column kk (found while
    // the last step updated it): down each warp, then over the warps in
    // every warp, so that each warp knows the row the CTA publishes (the
    // deferred update skips it)
    R cv = R(-1);
    int ci = INT_MAX;
    if (p.pivot) {
      R v = best;
      int i = bi;
      warp_best_key(v, i);
      if (lane == 0) { red_val[par][warp] = v; red_idx[par][warp] = i; }
    }
    __syncthreads();  // also orders the previous step's slab writes
    RF_STAMP(1);
    if (p.pivot) {
      cv = lane < kChainWarps ? red_val[par][lane] : R(-1);
      ci = lane < kChainWarps ? red_idx[par][lane] : INT_MAX;
      warp_best_key(cv, ci);
    }
    const int qc = ci == INT_MAX ? -1 : ci - r0 - s0;  // the candidate's slab row here
    const int qk = rank == owner ? kk - s0 : -1;       // row gk's, on its owner

    // ---- publish the candidate and row gk to every CTA ---------------------
    // the sending warp brings the row up to date first (step kk - 1's update
    // in columns > kk, from its multiplier and the last pivot row, whose slot
    // nobody writes before this CTA has sent its candidate) and writes it
    // back; it sends the row in 16-byte pieces, each lane loading what it
    // sends first, so the remote stores go out back to back, each completing
    // on the receiver's barrier of the step's parity (bar, this CTA's
    // address of it)
    const unsigned bar = bar0 + 8 * par;
    auto take_row = [&](int q, T (&x)[NCH][E16]) {
      T* r = row(q);
      const T l = late ? r[kk - 1] : T{};
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const int j = V > 32 ? lane + 32 * m : lane % V;
#pragma unroll
        for (int e = 0; e < E16; ++e) {
          const int c = j * E16 + e;
          x[m][e] = c < ncol ? r[c] : T{};
          if (late && c > kk && c < ncol) x[m][e] = rsub(x[m][e], rmul(l, uprev[c]));
        }
      }
      __syncwarp();  // every lane has read the row before one writes it
      if (late && (V > 32 || lane < V)) {
#pragma unroll
        for (int m = 0; m < NCH; ++m) {
          const int j = V > 32 ? lane + 32 * m : lane;
#pragma unroll
          for (int e = 0; e < E16; ++e) {
            const int c = j * E16 + e;
            if (c > kk && c < ncol) r[c] = x[m][e];
          }
        }
      }
    };
    auto send_row = [&](T* dst, const T (&x)[NCH][E16]) {
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const int j = V > 32 ? lane + 32 * m : lane % V;
        uint4 wd;
        memcpy(&wd, x[m], 16);
        for (int d = V > 32 ? 0 : lane / V; d < C; d += DV)
          put_async(C, reinterpret_cast<uint4*>(dst + j * E16), d, wd, bar);
      }
    };
    // row gk's perm id and origin, one 8-byte store to each CTA
    auto send_kinf = [&](int id, int from) {
      if (lane < C) {
        put_async(C, reinterpret_cast<int2*>(kinf + 2 * par), lane, make_int2(id, from), bar);
      }
    };
    // the two sending warps arrive once a step, after their write-backs;
    // warp 0 with the bytes this CTA receives in the step
    auto arrive = [&](bool bytes) {
      if (C == 1) return;
      __syncwarp();
      if (lane != 0) return;
      if (bytes) {
        mbar_arrive_tx(bar, chain_exchange_bytes<T>(M, R_, C, B, kk, p.pivot != 0));
      } else {
        mbar_arrive(bar);
      }
    };
    // the candidate is row gk itself: warp 0 sends it as both
    const bool both = qc >= 0 && qc == qk;
    if (warp == 0) {
      Cand<R> cd;
      cd.val = cv;
      cd.idx = ci;
      cd.pid = qc < 0 ? -1 : pid[qc];
      cd.src = qc < 0 ? -1 : src[qc];
      T x[NCH][E16];
      if (qc >= 0) take_row(qc, x);
      if (lane < C) put_async(C, cand + slot, lane, cd, bar);
      if (qc >= 0) send_row(crow + slot * B, x);
      if (both) {
        send_kinf(cd.pid, cd.src);
        send_row(krow + par * B, x);
      }
      arrive(true);
    }
    if (warp == kChainWarps - 1) {
      if (qk >= 0 && !both) {
        T x[NCH][E16];
        send_kinf(pid[qk], src[qk]);
        take_row(qk, x);
        send_row(krow + par * B, x);
      }
      arrive(false);
    }
    RF_STAMP(2);
    // ---- step kk - 1's update in columns > kk + 1; wait for the data -------
    if (late) deferred(kk - 1, kk + 2, qc, qk);
    RF_STAMP(3);
    if (tr && tid == 32) stamps[kk * kChainTracePhases + 8] = clock64();
    if (C > 1) {
      __syncwarp();  // the warp's lanes have read their multipliers
      mbar_wait(bar, (kk >> 1) & 1);
    } else {
      __syncthreads();
    }
    RF_STAMP(4);

    // ---- every CTA agrees on the pivot: lanes < C hold one candidate each;
    // the winner's CTA follows from its row -----------------------------------
    const T* urow;
    int kp, upid, usrc;
    if (p.pivot) {
      R v = R(-1);
      int i = INT_MAX;
      if (lane < C) {
        v = cand[par * C + lane].val;
        i = cand[par * C + lane].idx;
      }
      warp_best_key(v, i);
      kp = i;
      const int bg = (kp - r0) / R_;
      urow = crow + static_cast<size_t>(par * C + bg) * B;
      upid = cand[par * C + bg].pid;
      usrc = cand[par * C + bg].src;
      if (kLastOnNaN && isnan(v)) {
        // a NaN candidate: the pivot is row m - 1, which its owner publishes
        // now, up to date (step kk - 1's update in column kk + 1 too, unless
        // it took it early); every CTA takes this branch and its barriers
        // (the first orders the deferred update's writes before the read)
        __syncthreads();
        const int ql = M - 1 - s0;
        if (ql >= 0 && ql < own && warp == 0) {
          const T* r = row(ql);
          const bool due = late && ql != qc && ql != qk;
          const T l = due ? r[kk - 1] : T{};
#pragma unroll
          for (int t = 0; t < PER; ++t) {
            const int c = lane % G + t * 32;
            T x = c < ncol ? r[c] : T{};
            if (due && c == kk + 1) x = rsub(x, rmul(l, u[t]));
            for (int d = lane / G; d < C && c < ncol; d += DSTEP) put(cluster, C, lrow + c, d, x);
          }
          if (lane < C) {
            put(cluster, C, linf, lane, pid[ql]);
            put(cluster, C, linf + 1, lane, src[ql]);
          }
        }
        if (C > 1) {
          cluster.sync();
        } else {
          __syncthreads();
        }
        kp = p.m - 1;
        urow = lrow;
        upid = linf[0];
        usrc = linf[1];
      }
    } else {
      kp = gk;
      urow = krow + par * B;
      upid = kinf[2 * par];
      usrc = kinf[2 * par + 1];
    }
    const T pv = urow[kk];
    const bool nz = nonzero(pv);
    const bool swap = nz && kp != gk;
    const T rr = nz ? rrcp(pv) : T{};
    if (rank == 0 && tid == 0) {
      p.piv[k0 + kk] = kp;
      if (!nz && info == 0) info = p.pivot ? k0 + kk + 1 : -(k0 + kk + 1);
    }
    RF_STAMP(5);

    // ---- swap rows kk and kp where this CTA holds them (row kp's columns kk
    // and kk + 1 go to its look-ahead thread instead) ------------------------
    const int qs = swap ? kp - r0 - s0 : -1;  // row kp's slab row, swapped
    if (swap) {
      const int qa = kk - s0;
      if (qa >= 0 && qa < own && grp == qa % NG) {
        T* ra = row(qa);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = li + j * G;
          if (c < ncol) ra[c] = urow[c];
        }
        if (li == 0) { pid[qa] = upid; src[qa] = usrc; }
      }
      if (qs >= 0 && qs < own && grp == qs % NG) {
        T* rb = row(qs);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = li + j * G;
          if (c < ncol && c != kk && c != kk + 1) rb[c] = krow[par * B + c];
        }
        if (li == 0) { pid[qs] = kinf[2 * par]; src[qs] = kinf[2 * par + 1]; }
      }
    }
    RF_STAMP(6);

    // ---- the row threads: scale column kk, bring column kk + 1 up to date
    // (step kk - 1's update where it is still due, then step kk's) and
    // search it --------------------------------------------------------------
#pragma unroll
    for (int j = 0; j < PER; ++j) u[j] = urow[li + j * G];
    uprev = urow;
    const bool ahead = kk + 1 < ncol;
    const bool search = p.pivot && kk + 1 < nb;
    const T un = ahead ? urow[kk + 1] : T{};
    const T unp = un2;
    un2 = kk + 2 < ncol ? urow[kk + 2] : T{};
    best = R(-1);
    bi = INT_MAX;
    for (int q = max(0, kk + 1 - s0) / kChainThreads * kChainThreads + tid; q < own;
         q += kChainThreads) {
      if (s0 + q <= kk) continue;
      T* r = row(q);
      const bool moved = q == qs;  // its row came in the swap, up to date
      T l = moved ? krow[par * B + kk] : r[kk];
      T x = ahead ? (moved ? krow[par * B + kk + 1] : r[kk + 1]) : T{};
      if (late && ahead && !moved && q != qc && q != qk) x = rsub(x, rmul(r[kk - 1], unp));
      if (nz) {  // a moved row always: the swap needs a nonzero pivot
        l = rmul(l, rr);
        r[kk] = l;
      }
      if (ahead) {
        x = rsub(x, rmul(l, un));
        r[kk + 1] = x;
        if (search && better(mag(x), r0 + s0 + q, best, bi)) {
          best = mag(x);
          bi = r0 + s0 + q;
        }
      }
    }
    RF_STAMP(7);
  }
#undef RF_STAMP
  // the last step's update in the columns past nb (one block of a panel
  // with fewer live rows than columns), once its multipliers are written
  if (ncol > nb + 1) {
    __syncthreads();
    deferred(nb - 1, nb + 1, -1, -1);
  }

  // ---- write the slab, perm and the block's row moves back ---------------
  if (rank == 0 && tid == 0) *p.info = info;
  __syncthreads();
  for (int e = tid; e < own * B; e += kChainThreads) {
    const int q = e / B, c = e % B;
    if (c < ncol) p.a[(r0 + s0 + q) * lda + k0 + c] = row(q)[c];
  }
  for (int q = tid; q < own; q += kChainThreads) {
    const int r = r0 + s0 + q;
    p.perm[r] = pid[q];
    if (src[q] != r) {
      const int e = atomicAdd(p.moved, 1);
      p.moved[1 + 2 * e] = r;
      p.moved[2 + 2 * e] = src[q];
    }
  }
  // the previous block's U rows in this block's columns, from one CTA
  if (p.pmoved != nullptr && rank == 0) {
    const T* Us = carried_u();
    for (int e = tid; e < p.pnb * ncol; e += kChainThreads) {
      const int t = e / ncol, c = e % ncol;
      p.a[(p.ofs + p.pk0 + t) * lda + k0 + c] = Us[t * B + c];
    }
  }
  // no CTA leaves while another may still write into its shared memory
  if (C > 1) cluster.sync();
  if (tr && tid == 0) { ends[2] = global_ns(); ends[3] = clock64(); }
}

// The pivot chain of one block on the whole card, for a block whose live
// rows do not fit a cluster at its slab width (the blocked forms only: the
// bf16x3 form and the micro-blocked kernels).  A cooperative grid of G
// CTAs; CTA g owns the live rows [r0 + g R, r0 + (g + 1) R), which stay in
// device memory, and only the block's ncol columns [k0, k0 + ncol) are
// read or written.  A step has ONE grid barrier, as the grid route of
// csrc/panel_lu.cu:
//   phase A  every CTA finds its candidate in column k0 + kk (first-
//            occurrence argmax over its rows >= gk, a NaN first) and
//            publishes it (|value|, row, perm id, origin) with its ncol
//            entries; the owner of row gk publishes that row;
//                                                         -- grid.sync() --
//   phase B  every CTA reduces the G candidates to the same winner; the
//            owners of rows gk and kp swap them in the block's columns
//            (with their perm ids and origins); every CTA scales its rows
//            below gk and updates them in the block's columns > kk.
// Each product and difference is the cluster chain's, rounded once, and
// the winner is the same (`better` orders every candidate), so the block
// ends as the cluster chain leaves it, bit for bit.  Every row that moved
// goes into the block's `moved` record (row, the row it held when the block
// began) as the cluster chain writes it, and the delayed pass follows
// unchanged.  Real elements only.
constexpr int kGridThreads = 256;
constexpr int kGridWarps = kGridThreads / 32;

template <typename T>
struct GridChainArgs {
  T* a;          // panel, row-major with row stride lda
  int m, lda, ofs, pivot;
  int k0, nb;    // the block's first step and its steps
  int ncol;      // its columns (nb, or w when one block takes all)
  int rows;      // live rows per CTA
  int* piv;
  int* perm;
  int* info;
  int* moved;    // [0] count, then (row, row it held when the block began) pairs
  T* cval;       // [2][G]        |candidate| per CTA
  T* crow;       // [2][G][ncol]  candidate rows
  T* krow;       // [2][ncol]     row gk before the swap
  int* cidx;     // [2][G]        candidate row
  int* cpid;     // [2][G]        its perm id
  int* csrc;     // [2][G]        its origin
  int* kinf;     // [2][2]        perm id and origin of row gk
  int* src;      // [m - ofs - k0] origin of each live row
};

template <typename T>
__global__ void __launch_bounds__(kGridThreads)
panel_grid_chain_kernel(GridChainArgs<T> p) {
  static_assert(!Elem<T>::complex, "the grid chain takes real panels");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* urow = reinterpret_cast<T*>(smem_raw);  // the pivot row's ncol entries
  __shared__ T red_val[kGridWarps];
  __shared__ int red_idx[kGridWarps];
  __shared__ int s_kp, s_src;

  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t lda = static_cast<size_t>(p.lda);
  const int nb = p.nb, ncol = p.ncol, k0 = p.k0;
  const int r0 = p.ofs + k0;  // global row of the block's first step
  const int rs = r0 + b * p.rows;
  const int re = min(p.m, rs + p.rows);
  const bool first = k0 == 0;
  T* A = p.a + k0;  // A[i * lda + j]: row i, the block's column j

  if (first) {  // the rows above the offset never move
    for (int i = b * kGridThreads + tid; i < p.ofs; i += G * kGridThreads) p.perm[i] = i;
  }
  for (int i = rs + tid; i < re; i += kGridThreads) {
    if (first) p.perm[i] = i;
    p.src[i - r0] = i;
  }
  __syncthreads();
  int info = 0;  // kept by CTA 0, thread 0
  if (b == 0 && tid == 0 && !first) info = *p.info;

  for (int kk = 0; kk < nb; ++kk) {
    const int gk = r0 + kk;
    const int par = kk & 1;
    T* cval = p.cval + par * G;
    int* cidx = p.cidx + par * G;
    int* cpid = p.cpid + par * G;
    int* csrc = p.csrc + par * G;
    T* crow = p.crow + static_cast<size_t>(par) * G * ncol;
    T* krow = p.krow + static_cast<size_t>(par) * ncol;
    int* kinf = p.kinf + 2 * par;
    const bool own_k = gk >= rs && gk < re;

    // ---- phase A: publish the CTA's candidate and row gk ----------------
    if (p.pivot) {
      T best = T(-1);
      int bi = INT_MAX;
      for (int i = max(gk, rs) + tid; i < re; i += kGridThreads) {
        const T v = mag(A[i * lda + kk]);
        if (better(v, i, best, bi)) { best = v; bi = i; }
      }
      block_best<kGridWarps>(best, bi, red_val, red_idx);
      if (tid == 0) {
        cval[b] = best;
        cidx[b] = bi;
        cpid[b] = bi == INT_MAX ? -1 : p.perm[bi];
        csrc[b] = bi == INT_MAX ? -1 : p.src[bi - r0];
        s_kp = bi;
      }
      __syncthreads();
      const int ci = s_kp;
      if (ci != INT_MAX) {
        T* dst = crow + static_cast<size_t>(b) * ncol;
        for (int j = tid; j < ncol; j += kGridThreads) dst[j] = A[ci * lda + j];
      }
    }
    if (own_k) {
      for (int j = tid; j < ncol; j += kGridThreads) krow[j] = A[gk * lda + j];
      if (tid == 0) {
        kinf[0] = p.perm[gk];
        kinf[1] = p.src[gk - r0];
      }
    }

    grid.sync();

    // ---- phase B: agree on the pivot, swap, scale, update ---------------
    int kp = gk, wb = 0;
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
      kp = s_kp;
      wb = s_src;
    }
    const T* u = p.pivot ? crow + static_cast<size_t>(wb) * ncol : krow;
    for (int j = tid; j < ncol; j += kGridThreads) urow[j] = __ldcg(u + j);
    __syncthreads();

    const T pv = urow[kk];
    const bool nz = nonzero(pv);
    if (nz && kp != gk) {
      if (own_k) {
        for (int j = tid; j < ncol; j += kGridThreads) A[gk * lda + j] = urow[j];
        if (tid == 0) {
          p.perm[gk] = __ldcg(cpid + wb);
          p.src[gk - r0] = __ldcg(csrc + wb);
        }
      }
      if (kp >= rs && kp < re) {
        for (int j = tid; j < ncol; j += kGridThreads) A[kp * lda + j] = __ldcg(krow + j);
        if (tid == 0) {
          p.perm[kp] = __ldcg(kinf);
          p.src[kp - r0] = __ldcg(kinf + 1);
        }
      }
    }
    if (b == 0 && tid == 0) {
      p.piv[k0 + kk] = kp;
      if (!nz && info == 0) info = p.pivot ? k0 + kk + 1 : -(k0 + kk + 1);
    }
    __syncthreads();

    const T rr = nz ? rrcp(pv) : T{};
    for (int i = max(gk + 1, rs) + warp; i < re; i += kGridWarps) {
      T* row = A + i * lda;
      T l = T{};
      if (lane == 0) {
        l = row[kk];
        if (nz) {
          l = rmul(l, rr);
          row[kk] = l;
        }
      }
      l = __shfl_sync(kFull, l, 0);
      for (int j = kk + 1 + lane; j < ncol; j += 32) row[j] = rsub(row[j], rmul(l, urow[j]));
    }
    __syncthreads();
  }
  if (b == 0 && tid == 0) *p.info = info;
  // the block's row moves, as the cluster chain records them
  for (int i = rs + tid; i < re; i += kGridThreads) {
    const int s = p.src[i - r0];
    if (s != i) {
      const int e = atomicAdd(p.moved, 1);
      p.moved[1 + 2 * e] = i;
      p.moved[2 + 2 * e] = s;
    }
  }
}

template <typename T>
struct DelayArgs {
  T* a;
  int m, w, lda;
  int r0;          // global row of the block's first step
  int k0, nb;      // the block's columns [k0, k0 + nb)
  int skip;        // the columns past them that the next chain takes (its carry), or 0
  const int* moved;
  int tc, S;       // panel_swap_solve_kernel: columns per CTA, steps of L per chunk
};

// The swap / solve kernel's staging (solve_plan): tc of a CTA's kTile lanes
// take a column each; the moved rows' old values ([2 nb][tc], read before
// any is written) and then, in the same shared memory, the block's U rows
// ([nb][tc]) with S of its steps' multipliers at a time ([nb][S]).  Up to
// nb = 64 that is tc = kTile and S = nb, one chunk; wider blocks take
// fewer columns per CTA and more chunks.
constexpr int kSolveChunk = 64;

struct SolvePlan {
  int tc, S;
  size_t smem;
};

template <typename T>
inline SolvePlan solve_plan(int nb) {
  for (int tc = kTile; tc >= 1; tc >>= 1) {
    for (int S = nb < kSolveChunk ? nb : kSolveChunk; S >= 1; S >>= 1) {
      const size_t moves = static_cast<size_t>(2) * nb * tc;
      const size_t solve = static_cast<size_t>(nb) * tc + static_cast<size_t>(nb) * S;
      const size_t smem = (moves > solve ? moves : solve) * sizeof(T);
      if (smem <= kSmemMax) return SolvePlan{tc, S, smem};
    }
  }
  return SolvePlan{0, 0, 0};
}

// The delayed pass, part 1: one CTA per tc columns of [0, w).  Applies the
// block's row moves to its columns outside the slab (every old value is
// read before any is written), then solves the block's U rows in its
// columns >= k0 + nb: row t takes steps 0 .. t-1 in order (the steps'
// multipliers staged S at a time, in step order).  The `skip` columns past
// the block are left to the next chain, which does the same there.
template <typename T>
__global__ void __launch_bounds__(kDelayThreads)
panel_swap_solve_kernel(DelayArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = p.nb, c1 = p.k0 + nb + p.skip, tc = p.tc, S = p.S;
  T* buf = reinterpret_cast<T*>(smem_raw);  // [moves][tc] the moved rows' old values
  T* U = buf;                                // [nb][tc] once the moves are done
  T* Lc = U + static_cast<size_t>(nb) * tc;  // [nb][S] multipliers of S steps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool on = lane < tc;
  const int c = blockIdx.x * tc + lane;
  const bool outside = on && c < p.w && (c < p.k0 || c >= c1);
  const size_t lda = static_cast<size_t>(p.lda);
  const int moves = p.moved[0];
  for (int e = warp; e < moves; e += kDelayWarps) {
    if (outside) buf[e * tc + lane] = p.a[p.moved[2 + 2 * e] * lda + c];
  }
  __syncthreads();
  for (int e = warp; e < moves; e += kDelayWarps) {
    if (outside) p.a[p.moved[1 + 2 * e] * lda + c] = buf[e * tc + lane];
  }
  if ((blockIdx.x + 1) * tc <= c1 || nb < 2) return;  // no U columns here
  __syncthreads();  // U takes the moves' buffer
  const bool right = on && c < p.w && c >= c1;
  for (int t = warp; t < nb; t += kDelayWarps) {
    if (on) U[t * tc + lane] = right ? p.a[(p.r0 + t) * lda + c] : T{};
  }
  for (int s0 = 0; s0 + 1 < nb; s0 += S) {
    const int s1 = s0 + S < nb - 1 ? s0 + S : nb - 1;  // steps [s0, s1)
    // step s's multipliers of the rows t > s
    for (int e = threadIdx.x; e < (nb - s0 - 1) * S; e += kDelayThreads) {
      const int t = s0 + 1 + e / S, s = s0 + e % S;
      if (s < s1 && s < t) Lc[t * S + (s - s0)] = p.a[(p.r0 + t) * lda + p.k0 + s];
    }
    __syncthreads();
    for (int s = s0; s < s1; ++s) {
      const T us = on ? U[s * tc + lane] : T{};
      for (int t = s + 1 + warp; t < nb; t += kDelayWarps) {
        if (on) U[t * tc + lane] = rsub(U[t * tc + lane], rmul(Lc[t * S + (s - s0)], us));
      }
      __syncthreads();
    }
  }
  if (right) {
    for (int t = 1 + warp; t < nb; t += kDelayWarps) p.a[(p.r0 + t) * lda + c] = U[t * tc + lane];
  }
}

// The form of the delayed rank-b update, one per launcher instantiation:
//   kStepOrder  every row below the block takes the block's nb rank-1
//               updates in step order (panel_update_kernel): the plain
//               version's bits, csrc/panel_lu.cu and csrc/panel_lu_c64.cu;
//   kSumFirst   the order of ops/unblocked.py `_delayed_update`
//               (panel_update_kernel, real elements only): the micro-blocked
//               kernels of csrc/panel_lu_micro.cu;
//   kBf16x3     C -= hh + (hl + lh) on the tensor cores
//               (panel_update_bf16x3_tiled_kernel, float only; the simple
//               panel_update_bf16x3_kernel where forced): csrc/panel_lu.cu
//               under panel_boundary_precision='bf16x3'.
enum UpdateForm { kStepOrder, kSumFirst, kBf16x3 };

// The delayed pass, part 2: every row below the block takes the block's nb
// rank-1 updates in step order; one CTA per 64 rows x 32 columns >= k0 + nb
// + skip (the columns between, the next chain's own, it takes at load).
// kSumFirst (the micro-blocked kernels, real elements only): the order of
// ops/unblocked.py `_delayed_update` instead, an accumulator from 0 takes
// l[i, j] * u[j, c] for j = k0 .. k0+nb-1 in turn, each product and sum
// rounded once, then one difference.  Up to kUpdK steps the block's U rows
// and the CTA's L rows are staged once (kWide false); a wider block stages
// them kUpdK steps at a time (kWide true), x (step order) or the
// accumulator (sum first) carrying over from one chunk to the next, so the
// order is the same for every nb.  Two instantiations, so that the narrow
// one keeps its registers (the chunk loop holds x and the accumulator
// across the staging).
constexpr int kUpdK = 64;

// panel_update_kernel's staging of steps [q0, q0 + qn) of the block: its U
// rows in the CTA's columns ([qn][kTile]) and the CTA's L rows
// ([kUpdRows][kc]).
template <typename T>
__device__ __forceinline__ void update_stage(const DelayArgs<T>& p, T* U, T* Lr, int kc, int q0,
                                             int qn, int c, bool on, int i0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t lda = static_cast<size_t>(p.lda);
  for (int t = warp; t < qn; t += kDelayWarps) {
    U[t * kTile + lane] = on ? p.a[(p.r0 + q0 + t) * lda + c] : T{};
  }
  for (int e = threadIdx.x; e < kUpdRows * qn; e += kDelayThreads) {
    const int r = e / qn, t = e % qn;
    Lr[r * kc + t] = i0 + r < p.m ? p.a[(i0 + r) * lda + p.k0 + q0 + t] : T{};
  }
}

// The staged steps taken in step order by this thread's kPer rows: into x
// (kStepOrder) or into the accumulator (kSumFirst).
template <typename T, int kForm, int kPer>
__device__ __forceinline__ void update_take(T (&x)[kPer], T (&acc)[kPer], const T* U,
                                            const T* Lr, int kc, int qn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < qn; ++t) {
    const T u = U[t * kTile + lane];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const T l = Lr[(warp + j * kDelayWarps) * kc + t];
      if constexpr (kForm == kSumFirst) {
        acc[j] = radd(acc[j], rmul(l, u));
      } else {
        x[j] = rsub(x[j], rmul(l, u));
      }
    }
  }
}

template <typename T, int kForm = kStepOrder, bool kWide = false>
__global__ void __launch_bounds__(kDelayThreads)
panel_update_kernel(DelayArgs<T> p) {
  static_assert(kForm == kStepOrder || kForm == kSumFirst, "see panel_update_bf16x3_kernel");
  constexpr int kPer = kUpdRows / kDelayWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = p.nb, c1 = p.k0 + nb + p.skip;
  const int kc = kWide ? kUpdK : nb;       // steps staged per chunk
  T* U = reinterpret_cast<T*>(smem_raw);  // [kc][kTile]
  T* Lr = U + kc * kTile;                  // [kUpdRows][kc]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c1 + blockIdx.x * kTile + lane;
  const bool on = c < p.w;
  const int i0 = p.r0 + nb + blockIdx.y * kUpdRows;
  const size_t lda = static_cast<size_t>(p.lda);
  T x[kPer], acc[kPer];
  if constexpr (!kWide) {  // one chunk; x read once it is staged
    update_stage(p, U, Lr, kc, 0, nb, c, on, i0);
    __syncthreads();
    if (!on) return;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = i0 + warp + j * kDelayWarps;
      x[j] = i < p.m ? p.a[i * lda + c] : T{};
      acc[j] = T{};
    }
    update_take<T, kForm, kPer>(x, acc, U, Lr, kc, nb);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = i0 + warp + j * kDelayWarps;
      x[j] = on && i < p.m ? p.a[i * lda + c] : T{};
      acc[j] = T{};
    }
    for (int q0 = 0; q0 < nb; q0 += kc) {
      const int qn = nb - q0 < kc ? nb - q0 : kc;
      if (q0 > 0) __syncthreads();  // the last chunk is read
      update_stage(p, U, Lr, kc, q0, qn, c, on, i0);
      __syncthreads();
      if (on) update_take<T, kForm, kPer>(x, acc, U, Lr, kc, qn);
    }
    if (!on) return;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + warp + j * kDelayWarps;
    if constexpr (kForm == kSumFirst) x[j] = rsub(x[j], acc[j]);
    if (i < p.m) p.a[i * lda + c] = x[j];
  }
}

// The delayed pass, part 2 in its bf16x3 form (float panels): the port of
// the TPU kernel's `mmb` boundary Schur update (ops/panel.py:472-502 and
// :700-706 of the JAX package) and of ops/schur.py's split,
//   C -= hh + (hl + lh),  a = ah + al, ah = bf16(a), al = bf16(a - ah),
// for L (rows x nb) and U (nb x cols), each value split once, rounding to
// nearest; the three products are bf16 x bf16 with f32 accumulation on the
// tensor cores (mma.sync m16n8k16): hh into one accumulator, hl and lh into
// a second, then one sum and one difference, each rounded once.  The ll
// term is dropped, as in ops/schur.py.  An inf in L or U makes its low half
// NaN (inf - inf), as in the plain version.  The tensor cores sum in their
// own order, so the kernel agrees with its plain version to the bf16x3
// class, not bitwise; chip_smoke.py (phase 2g) holds it to the exact sum of
// the three products within (K + 2) * 2^-24 of the sum of their magnitudes.
//
// This is the simple route, forced only: the tiled kernel below computes
// the same bits faster.  A CTA of four warps takes a 64 x 64 tile of C, a
// warp 32 x 32 of it (two 16-row by four 8-column fragments).  It stages the split halves of its L
// rows (row-major, k contiguous) and U columns (column-major, k contiguous)
// in shared memory, kTcKMax steps of K at a time (the last chunk's steps
// zero-padded to a multiple of 16; both accumulators carry over from one
// chunk to the next); a staged row of kTcLd = 72 bf16 (36 words) puts the
// eight rows of a fragment load on distinct banks.
constexpr int kTcTile = 64, kTcThreads = 128, kTcKMax = 64, kTcLd = kTcKMax + 8;

struct Bf16x3Args {
  const float* l;  // rows x nb, row stride ldl
  const float* u;  // nb x cols, row stride ldu
  float* c;        // rows x cols, row stride ldc
  int ldl, ldu, ldc, rows, cols, nb;
};

__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(h)));
}

// two consecutive bf16 of a staged row: one 32-bit fragment register
__device__ __forceinline__ unsigned pair_at(const __nv_bfloat16* s, int row, int k) {
  return *reinterpret_cast<const unsigned*>(s + row * kTcLd + k);
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
panel_update_bf16x3_kernel(Bf16x3Args p) {
  static_assert(std::is_same<T, float>::value, "the bf16x3 update takes float panels");
  __shared__ __align__(16) __nv_bfloat16 lh[kTcTile * kTcLd], ll[kTcTile * kTcLd];
  __shared__ __align__(16) __nv_bfloat16 uh[kTcTile * kTcLd], ul[kTcTile * kTcLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * kTcTile, c0 = blockIdx.x * kTcTile;
  // the fragment layout of mma.m16n8k16 (PTX ISA): lane = 4 g + t
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float hi[2][4][4], lo[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[i][j][q] = lo[i][j][q] = 0.0f;
  for (int kc0 = 0; kc0 < p.nb; kc0 += kTcKMax) {
    const int nb = p.nb - kc0 < kTcKMax ? p.nb - kc0 : kTcKMax, kp = (nb + 15) & ~15;
    if (kc0 > 0) __syncthreads();  // every warp has read the last chunk
    for (int e = tid; e < kTcTile * kp; e += kTcThreads) {
      const int r = e / kp, k = e % kp;
      const float x =
          r0 + r < p.rows && k < nb ? p.l[static_cast<size_t>(r0 + r) * p.ldl + kc0 + k] : 0.0f;
      split_bf16(x, &lh[r * kTcLd + k], &ll[r * kTcLd + k]);
    }
    for (int e = tid; e < kp * kTcTile; e += kTcThreads) {
      const int k = e / kTcTile, c = e % kTcTile;
      const float x = k < nb && c0 + c < p.cols
                          ? p.u[static_cast<size_t>(kc0 + k) * p.ldu + c0 + c] : 0.0f;
      split_bf16(x, &uh[c * kTcLd + k], &ul[c * kTcLd + k]);
    }
    __syncthreads();
    for (int k0 = 0; k0 < kp; k0 += 16) {
      const int ka = k0 + 2 * t, kb = ka + 8;
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        ah[i][0] = pair_at(lh, r, ka);
        ah[i][1] = pair_at(lh, r + 8, ka);
        ah[i][2] = pair_at(lh, r, kb);
        ah[i][3] = pair_at(lh, r + 8, kb);
        al[i][0] = pair_at(ll, r, ka);
        al[i][1] = pair_at(ll, r + 8, ka);
        al[i][2] = pair_at(ll, r, kb);
        al[i][3] = pair_at(ll, r + 8, kb);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        bh[j][0] = pair_at(uh, c, ka);
        bh[j][1] = pair_at(uh, c, kb);
        bl[j][0] = pair_at(ul, c, ka);
        bl[j][1] = pair_at(ul, c, kb);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(hi[i][j], ah[i], bh[j]);
          mma_bf16(lo[i][j], ah[i], bl[j]);
          mma_bf16(lo[i][j], al[i], bh[j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm + 16 * i + g + 8 * h;
        const int c = c0 + wn + 8 * j + 2 * t;
        if (r >= p.rows) continue;
        float* row = p.c + static_cast<size_t>(r) * p.ldc;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (c + q < p.cols)
            row[c + q] = __fsub_rn(row[c + q], __fadd_rn(hi[i][j][2 * h + q], lo[i][j][2 * h + q]));
        }
      }
}

// The bf16x3 update tiled for the memory path (panel_update_bf16x3_tiled_
// kernel, the route the panel takes; the kernel above stays as the simple
// route, forced only).  It runs the same products in the same order: per
// element K in chunks of 16 ascending on mma.sync m16n8k16 with the same
// fragments (staged KP <= 64 steps at a time, past 64 in chunks of 64 as the
// simple kernel stages them), hh into one accumulator, hl then lh into a
// second, then one sum and one difference.  So the two kernels agree bit for
// bit at every shape.
//
// What bounds the update is bytes: C read and written once is ~12x the
// three products' time at the bf16 tensor-core peak (1504 x 480 x 32: 5.8 MB,
// 1.7 us at 3.35 TB/s, against 0.14 us).  The design serves the memory path:
//   * each warp's 16 C rows go into shared memory by cp.async at entry, so
//     their latency overlaps the staging and the products; the result
//     leaves through the same rows in 16-byte row-contiguous stores;
//   * L and U are read with 16-byte loads (all of a thread's loads before
//     its first split), split once, and stored as they lie: L's halves
//     row-major, k contiguous, U's halves k-major, n contiguous; ldmatrix
//     (.trans for U) reads the fragments without bank conflicts from rows
//     of KP + 8 and TN + 8 bf16;
//   * the tile is TM x TN (TM / 16 warps, a warp takes 16 rows and all TN
//     columns), chosen from (rows, cols) by tile_plan; each CTA splits its
//     own L rows and U columns again (L2 hits: the panel is in L2).
// Operands off 16 bytes, or a row stride that is not a multiple of 4, take
// 4-byte copies and loads in the same pattern.
template <int TM, int TN, int KP>
struct TcTile {
  static constexpr int kThreads = 2 * TM;  // a warp per 16 rows
  static constexpr int kCld = TN + 8;      // floats per staged C row
  static constexpr int kLld = KP + 8;      // bf16 per staged L row
  static constexpr int kUld = TN + 8;      // bf16 per staged U row
  static constexpr size_t kCBytes = static_cast<size_t>(TM) * kCld * 4;
  static constexpr size_t kLBytes = static_cast<size_t>(TM) * kLld * 2;  // one half
  static constexpr size_t kUBytes = static_cast<size_t>(KP) * kUld * 2;  // one half
  static constexpr size_t kSmem = kCBytes + 2 * kLBytes + 2 * kUBytes;
};

// four 8 x 8 bf16 matrices from shared memory, lane l addressing row l % 8
// of matrix l / 8; .trans hands each lane a column pair instead of a row pair
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// row[c .. c + 3], the columns at or past n read as 0 (a row outside the
// operand: row == nullptr): one 16-byte load where vec and all four lie inside
__device__ __forceinline__ float4 tc_load4(const float* row, int c, int n, bool vec) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row == nullptr) return x;
  if (vec && c + 3 < n) return *reinterpret_cast<const float4*>(row + c);
  if (c < n) x.x = row[c];
  if (c + 1 < n) x.y = row[c + 1];
  if (c + 2 < n) x.z = row[c + 2];
  if (c + 3 < n) x.w = row[c + 3];
  return x;
}

// the halves of four floats, one 8-byte store each
__device__ __forceinline__ void tc_split4(const float4& x, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  union { __nv_bfloat16 h[4]; uint2 u; } h, l;
  split_bf16(x.x, &h.h[0], &l.h[0]);
  split_bf16(x.y, &h.h[1], &l.h[1]);
  split_bf16(x.z, &h.h[2], &l.h[2]);
  split_bf16(x.w, &h.h[3], &l.h[3]);
  *reinterpret_cast<uint2*>(hi) = h.u;
  *reinterpret_cast<uint2*>(lo) = l.u;
}

// The tiled kernel's staging of steps [kc0, kc0 + nb) (nb <= KP): the
// tile's L rows and U columns, split into bf16 halves (steps past nb zero).
template <int TM, int TN, int KP>
__device__ __forceinline__ void tc_stage(const Bf16x3Args& p, int vec, int kc0, int nb, int r0,
                                         int c0, __nv_bfloat16* lh, __nv_bfloat16* ll,
                                         __nv_bfloat16* uh, __nv_bfloat16* ul) {
  using S = TcTile<TM, TN, KP>;
  constexpr int kThreads = S::kThreads;
  constexpr int CV = TN / 4;                   // 4-float vectors per C or U row
  constexpr int LV = KP / 4;                   // 4-float vectors per L row
  constexpr int NL = TM * LV / kThreads;       // L vectors per thread
  constexpr int NU = (KP * CV + kThreads - 1) / kThreads;  // U vectors per thread, at most
  constexpr int kBatch = NU < 8 ? NU : 8;      // U vectors loaded before a split
  static_assert(NL * kThreads == TM * LV && TN % 16 == 0, "tile shapes");
  const int tid = threadIdx.x, rows = p.rows, cols = p.cols;
  const float* lsrc = p.l + kc0;
  const float* usrc = p.u + static_cast<size_t>(kc0) * p.ldu;
  float4 xl[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int v = tid + i * kThreads, r = v / LV;
    xl[i] = tc_load4(r0 + r < rows ? lsrc + static_cast<size_t>(r0 + r) * p.ldl : nullptr,
                     (v % LV) * 4, nb, vec);
  }
#pragma unroll
  for (int i0 = 0; i0 < NU; i0 += kBatch) {
    float4 xu[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch && i0 + i < NU; ++i) {
      const int v = tid + (i0 + i) * kThreads, k = v / CV;
      xu[i] = tc_load4(k < nb && v < KP * CV ? usrc + static_cast<size_t>(k) * p.ldu + c0 : nullptr,
                       (v % CV) * 4, cols - c0, vec);
    }
    if (i0 == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int v = tid + i * kThreads, e = (v / LV) * S::kLld + (v % LV) * 4;
        tc_split4(xl[i], lh + e, ll + e);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch && i0 + i < NU; ++i) {
      const int v = tid + (i0 + i) * kThreads, e = (v / CV) * S::kUld + (v % CV) * 4;
      if (v < KP * CV) tc_split4(xu[i], uh + e, ul + e);
    }
  }
}

// The staged steps' products into the warp's accumulators, the first kp
// steps (a multiple of 16) in chunks of 16 ascending (the fragment layout
// of mma.m16n8k16: lane = 4 g + t).  A: lanes 0-15 address rows 0-15 at k,
// lanes 16-31 the same rows at k + 8; B (.trans): lanes 0-15 address k rows
// 0-15 at column n, 16-31 at n + 8.
template <int TM, int TN, int KP>
__device__ __forceinline__ void tc_products(float (&hi)[TN / 8][4], float (&lo)[TN / 8][4],
                                            const __nv_bfloat16* lh, const __nv_bfloat16* ll,
                                            const __nv_bfloat16* uh, const __nv_bfloat16* ul,
                                            int kp) {
  using S = TcTile<TM, TN, KP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ao = (warp * 16 + (lane & 15)) * S::kLld + (lane >> 4) * 8;
  const int bo = (lane & 15) * S::kUld + (lane >> 4) * 8;
#pragma unroll
  for (int k0 = 0; k0 < KP; k0 += 16) {
    if (k0 >= kp) break;
    unsigned ah[4], al[4];
    ldsm_x4(ah, lh + ao + k0);
    ldsm_x4(al, ll + ao + k0);
#pragma unroll
    for (int j = 0; j < TN / 8; j += 2) {
      unsigned bh[4], bl[4];
      ldsm_x4_trans(bh, uh + bo + k0 * S::kUld + 8 * j);
      ldsm_x4_trans(bl, ul + bo + k0 * S::kUld + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_bf16(hi[j + h], ah, bh + 2 * h);
        mma_bf16(lo[j + h], ah, bl + 2 * h);
        mma_bf16(lo[j + h], al, bh + 2 * h);
      }
    }
  }
}

// kWide false: K = nb <= KP staged once; kWide true (KP = 64): K in chunks
// of KP, both accumulators carrying over.  Two instantiations, so that the
// narrow one keeps its registers (a chunk loop holds the accumulators
// across the staging).
template <int TM, int TN, int KP, bool kWide = false>
__global__ void __launch_bounds__(TcTile<TM, TN, KP>::kThreads)
panel_update_bf16x3_tiled_kernel(Bf16x3Args p, int vec) {
  using S = TcTile<TM, TN, KP>;
  constexpr int CV = TN / 4;  // 4-float vectors per C row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* lh = reinterpret_cast<__nv_bfloat16*>(smem_raw + S::kCBytes);
  __nv_bfloat16* ll = lh + TM * S::kLld;
  __nv_bfloat16* uh = ll + TM * S::kLld;
  __nv_bfloat16* ul = uh + KP * S::kUld;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TM, c0 = blockIdx.y * TN;
  const int rows = p.rows, cols = p.cols;

  // ---- this warp's 16 C rows into shared memory, in flight from here on ---
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const int v = lane + 32 * i, r = warp * 16 + v / CV, c = (v % CV) * 4;
    if (r0 + r >= rows) continue;
    const float* g = p.c + static_cast<size_t>(r0 + r) * p.ldc + c0 + c;
    float* s = cs + r * S::kCld + c;
    if (vec && c0 + c + 3 < cols) {
      cp_async(reinterpret_cast<uint4*>(s), reinterpret_cast<const uint4*>(g));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + c + q < cols) cp_async(s + q, g + q);
    }
  }

  // ---- L's rows and U's columns of the tile, split into bf16 halves, then
  // the products ------------------------------------------------------------
  float hi[TN / 8][4], lo[TN / 8][4];
  if constexpr (!kWide) {
    tc_stage<TM, TN, KP>(p, vec, 0, p.nb, r0, c0, lh, ll, uh, ul);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[j][q] = lo[j][q] = 0.0f;
    tc_products<TM, TN, KP>(hi, lo, lh, ll, uh, ul, KP);
  } else {
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[j][q] = lo[j][q] = 0.0f;
    for (int kc0 = 0; kc0 < p.nb; kc0 += KP) {
      const int nb = p.nb - kc0 < KP ? p.nb - kc0 : KP;  // the chunk's steps
      if (kc0 > 0) __syncthreads();  // every warp has read the last chunk
      tc_stage<TM, TN, KP>(p, vec, kc0, nb, r0, c0, lh, ll, uh, ul);
      __syncthreads();
      tc_products<TM, TN, KP>(hi, lo, lh, ll, uh, ul, (nb + 15) & ~15);
    }
  }

  // ---- C - (hi + lo) in this warp's staged rows, then out -----------------
  cp_async_wait();
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* s = reinterpret_cast<float2*>(cs + (warp * 16 + g + 8 * h) * S::kCld + 8 * j + 2 * t);
      float2 x = *s;
      x.x = __fsub_rn(x.x, __fadd_rn(hi[j][2 * h], lo[j][2 * h]));
      x.y = __fsub_rn(x.y, __fadd_rn(hi[j][2 * h + 1], lo[j][2 * h + 1]));
      *s = x;
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const int v = lane + 32 * i, r = warp * 16 + v / CV, c = (v % CV) * 4;
    if (r0 + r >= rows) continue;
    float* g2 = p.c + static_cast<size_t>(r0 + r) * p.ldc + c0 + c;
    const float* s = cs + r * S::kCld + c;
    if (vec && c0 + c + 3 < cols) {
      *reinterpret_cast<float4*>(g2) = *reinterpret_cast<const float4*>(s);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + c + q < cols) g2[q] = s[q];
    }
  }
}

// The tiled kernel's plan: TN = 16 for at most 32 columns (a panel's last
// boundary), else 32; TM = 128 past 2048 rows, else 64; KP = nb rounded up
// to 16, at most 64 (wider blocks go through K in chunks of 64).  Grid: x
// row tiles, y column tiles.  Chosen by measurement on an
// H100 (PERF.md, row 1b): a CTA's time is the latency of its staging, which
// a taller tile shares among more warps, so fewer and taller CTAs beat a
// grid sized to fill the SMs.  Only these tiles are built.
struct TcPlan {
  int tm, tn, kp, gx, gy;
};

inline TcPlan tile_plan(int rows, int cols, int nb) {
  TcPlan q;
  q.kp = nb < kTcKMax ? (nb + 15) & ~15 : kTcKMax;
  q.tn = cols <= 32 ? 16 : 32;
  q.tm = rows > 2048 ? 128 : 64;
  q.gx = (rows + q.tm - 1) / q.tm;
  q.gy = (cols + q.tn - 1) / q.tn;
  return q;
}

template <int TM, int TN, int KP, bool kWide = false>
int launch_tiled(const Bf16x3Args& a, const TcPlan& q, int vec, cudaStream_t stream) {
  using S = TcTile<TM, TN, KP>;
  if constexpr (S::kSmem > 48 * 1024) {  // past the default: opt in once per device
    static bool opted[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices)) e = cudaErrorInvalidDevice;
    if (e == cudaSuccess && !opted[dev]) {
      e = opt_in_smem(
          reinterpret_cast<const void*>(panel_update_bf16x3_tiled_kernel<TM, TN, KP, kWide>),
          S::kSmem);
      opted[dev] = e == cudaSuccess;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  panel_update_bf16x3_tiled_kernel<TM, TN, KP, kWide>
      <<<dim3(q.gx, q.gy), S::kThreads, S::kSmem, stream>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int TN>
int launch_tiled_kp(const Bf16x3Args& a, const TcPlan& q, int vec, cudaStream_t stream) {
  switch (q.kp) {
    case 16: return launch_tiled<TM, TN, 16>(a, q, vec, stream);
    case 32: return launch_tiled<TM, TN, 32>(a, q, vec, stream);
    case 48: return launch_tiled<TM, TN, 48>(a, q, vec, stream);
    default:
      return a.nb > 64 ? launch_tiled<TM, TN, 64, true>(a, q, vec, stream)
                       : launch_tiled<TM, TN, 64>(a, q, vec, stream);
  }
}

template <int TN>
int launch_tiled_tm(const Bf16x3Args& a, const TcPlan& q, int vec, cudaStream_t stream) {
  return q.tm == 64 ? launch_tiled_kp<64, TN>(a, q, vec, stream)
                    : launch_tiled_kp<128, TN>(a, q, vec, stream);
}

// The routes of the bf16x3 update: kUpdTiled (tile_plan's tile), kUpdSimple
// (panel_update_bf16x3_kernel, forced only).
constexpr int kUpdTiled = 0, kUpdSimple = 1;

// Launch the bf16x3 update of `a` (nb >= 1) on `stream` on `route`.  T =
// float; a template so that only the sources that launch it build it.
template <typename T>
int launch_update_bf16x3(const Bf16x3Args& a, cudaStream_t stream, int route = kUpdTiled) {
  if (a.nb < 1 || a.rows < 0 || a.cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows == 0 || a.cols == 0) return 0;
  if (route == kUpdSimple) {
    const dim3 grid((a.cols + kTcTile - 1) / kTcTile, (a.rows + kTcTile - 1) / kTcTile);
    panel_update_bf16x3_kernel<T><<<grid, kTcThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kUpdTiled) return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan q = tile_plan(a.rows, a.cols, a.nb);
  if (q.gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto aligned = [](const void* ptr, int ld) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && ld % 4 == 0;
  };
  const int vec = aligned(a.l, a.ldl) && aligned(a.u, a.ldu) && aligned(a.c, a.ldc);
  return q.tn == 16 ? launch_tiled_tm<16>(a, q, vec, stream)
                    : launch_tiled_tm<32>(a, q, vec, stream);
}

// ---- plan ----------------------------------------------------------------

constexpr int kWidths[] = {8, 16, 32, 64, 128, 256, 512};
constexpr int kNumWidths = 7;

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

inline int width_index(int B) {
  for (int i = 0; i < kNumWidths; ++i) if (kWidths[i] == B) return i;
  return -1;
}

// A chain launch on a cluster of C; `early` (attr holds two entries): a
// programmatic dependent launch, which may start once the kernel before it
// on the stream has triggered (griddepcontrol.launch_dependents) and waits
// for that kernel's completion at its griddepcontrol.wait.
inline cudaLaunchConfig_t chain_config(int C, size_t smem, cudaStream_t stream,
                                       cudaLaunchAttribute* attr, bool early = false) {
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
  if (early) {
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.numAttrs = 2;
  }
  return cfg;
}

// The chain kernels a plan is made for: the swapping chain above by
// default; csrc/panel_lu_noswap.cu passes its own (a type with the same
// static fn(B)).
template <typename T>
struct SwapChain {
  static const void* fn(int B) { return reinterpret_cast<const void*>(chain_kernel_for<T>(B)); }
  static constexpr bool padded = true;  // its slab takes chain_smem's padding
};

// Does chain family K pad its slab (K::padded; a family without it does not)?
template <typename K, typename = void>
struct PaddedSlab : std::false_type {};
template <typename K>
struct PaddedSlab<K, std::void_t<decltype(K::padded)>> : std::bool_constant<K::padded> {};

// Does the card run a cluster of C chain CTAs of width B with the most
// shared memory the route uses?  Asked once per (device, chain kernel, B,
// C), with cudaOccupancyMaxActiveClusters; sets the kernel's attributes on
// the way.
template <typename T, typename K = SwapChain<T>>
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
    const void* fn = K::fn(B);
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
  int C;          // CTAs of the cluster (0: no block's chain runs on one)
  int one_block;  // b >= w: the whole live panel in one slab, no delayed pass
  int blocks;
  int grid;       // blocks of the grid route
  size_t ws_reals, iws_ints;
  // the blocked forms: the leading blocks whose chain runs on the grid
  // (panel_grid_chain_kernel, on gchain CTAs), and where that chain's
  // workspace starts in iws (int32s)
  int grid_blocks;
  int gchain;
  size_t gws;
};

// The plan as every panel family's rf_*_plan hands it out, kPlanInts
// int32s: route (1 cluster, 0 grid), b (-1 on the grid route), C (the grid
// route: its grid), blocks, ws reals, iws int32s, and the blocks whose chain
// runs on the grid (0 where the family has no grid chain).  The caller
// allocates the two workspaces with those sizes.
constexpr int kPlanInts = 7;

inline void write_plan(const Plan& pl, int* out) {
  const bool cluster = pl.route == kRouteCluster;
  out[0] = pl.route;
  out[1] = cluster ? pl.b : -1;
  out[2] = cluster ? pl.C : pl.grid;
  out[3] = cluster ? pl.blocks : 1;
  out[4] = static_cast<int>(pl.ws_reals);
  out[5] = static_cast<int>(pl.iws_ints);
  out[6] = pl.grid_blocks;
}

inline int width_at_least(int w) {
  int B = 8;
  while (B < w) B <<= 1;
  return B;
}

template <typename T, typename K = SwapChain<T>>
size_t chain_bytes(int M, int B, int C) {
  const int rows = (M + C - 1) / C;
  return chain_smem<T>(rows, C, B, PaddedSlab<K>::value).total;
}

// The launcher's own choice of b and C for M live rows, by element type
// and chain family K, from the H100 sweeps (`chip_smoke.py --sweep`,
// PERF.md): the block width b0 (32 up to b32_rows live rows, 16 up to
// b16_rows, 8 beyond; one block when w <= b) and the cluster size c0 (one
// CTA up to one_cta_rows, else the smallest power of two with at most
// rows_per_cta rows per CTA, at most 16).
struct AutoRule {
  int b32_rows, b16_rows, one_cta_rows, rows_per_cta;
};
template <typename T, typename K = SwapChain<T>> struct Auto {
  static constexpr AutoRule rule{1536, 4096, 128, 32};
};
// complex panels: b = 16 from 1024 live rows on (the sweep's best at 1024,
// 1536, 2048 and 4096 rows of complex64 and at 1536 and 4096 of
// complex128), C = 16
template <> struct Auto<float2> {
  static constexpr AutoRule rule{512, 4096, 128, 32};
};
template <> struct Auto<double2> {
  static constexpr AutoRule rule{512, 4096, 128, 32};
};
// float64 panels on the swap chain: b = 32 up to 3584 live rows (the float64
// sweep at 512..4096 rows x 512, the heights of an n = 4096 lu: b 32 beat
// b 16 by 2.2-4.3% at 2048, 2560, 3072 and 3584 rows, past the spread between
// turns; at 4096 by 2.1%, within it), C = 16; the no-swap chain keeps the
// generic rule
template <> struct Auto<double> {
  static constexpr AutoRule rule{3584, 4096, 128, 32};
};

// The plan of a panel with M live rows and w columns.  b_req / C_req: 0
// picks; b_req < 0 forces the grid route; b_req >= w asks for one block.
// With any_b (the blocked forms: the micro-blocked kernels and the bf16x3
// form) b_req > 0 is the block's step count whatever it is (the slab takes
// the width at or above it) and C_req 0 picks the cluster for it; the
// leading blocks whose live rows do not fit a cluster of kMaxCluster at
// that width (every block where the width passes 512, or with grid_chain)
// run their chain on the grid (pl->grid_blocks; grid_chain_plan sizes
// it).  K: the chain kernel family.
template <typename T, typename K = SwapChain<T>>
int plan_for(int M, int w, int b_req, int C_req, int device, Plan* pl, bool any_b = false,
             bool grid_chain = false) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int steps = M < w ? M : w;
  *pl = Plan{};
  auto fits = [&](int B, int C, bool* ok) -> int {
    *ok = false;
    if (chain_bytes<T, K>(M, B, C) > kSmemMax || C > M) return 0;
    return cluster_ok<T, K>(B, C, device, ok);
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
    if (grid_chain) pl->grid_blocks = pl->blocks;
  };
  // the auto rule's cluster size (Auto<T, K>): one CTA up to one_cta_rows,
  // else the smallest power of two with at most rows_per_cta rows per CTA
  constexpr AutoRule a = Auto<T, K>::rule;
  int c0 = 1;
  while (M > a.one_cta_rows && c0 < kMaxCluster && a.rows_per_cta * c0 < M) c0 *= 2;
  if (b_req < 0) return kPlanGrid;
  if (b_req > 0 && (C_req > 0 || any_b)) {  // explicit b
    const bool one = b_req >= w;
    const int B = one ? width_at_least(w) : any_b ? width_at_least(b_req) : b_req;
    if ((!one && !any_b && B != 8 && B != 16 && B != 32 && B != 64) || (!any_b && B > 512))
      return static_cast<int>(cudaErrorInvalidValue);
    const int b = one ? w : b_req;
    if (C_req > 0) {
      bool ok = false;
      const int err = B > 512 ? 0 : fits(B, C_req, &ok);
      if (err != 0) return err;
      if (!ok) return static_cast<int>(cudaErrorInvalidConfiguration);
      take(b, B, C_req);
      return 0;
    }
    if (B <= 512) {
      for (int C = c0; C <= kMaxCluster; C *= 2) {
        bool ok = false;
        const int err = fits(B, C, &ok);
        if (err != 0) return err;
        if (ok) { take(b, B, C); return 0; }
      }
    }
    if (!any_b) return kPlanGrid;
    // the leading blocks on the grid chain, the rest on a cluster of
    // kMaxCluster (their live rows shrink by b per block)
    int C = 0;
    if (B <= 512) {
      bool ok = false;
      const int err = cluster_ok<T, K>(B, kMaxCluster, device, &ok);
      if (err != 0) return err;
      if (ok) C = kMaxCluster;
    }
    take(b, B, C);
    if (!grid_chain) {
      while (pl->grid_blocks < pl->blocks &&
             (C == 0 || chain_bytes<T, K>(M - pl->grid_blocks * b, B, C) > kSmemMax))
        ++pl->grid_blocks;
    }
    return 0;
  }
  if (b_req != 0 || C_req != 0 || grid_chain) return static_cast<int>(cudaErrorInvalidValue);
  // auto: b0 by the rule; narrower blocks and larger clusters where that
  // does not fit; the grid route beyond
  const int b0 = M <= a.b32_rows ? 32 : M <= a.b16_rows ? 16 : 8;
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

// The grid chain's reals in iws: where they start (the first address on 16
// bytes at or after iws + pl.gws) and how many int32s they take.
template <typename T>
size_t grid_chain_real_ints(int g, int ncol) {
  const size_t reals = 2 * static_cast<size_t>(g) + 2 * static_cast<size_t>(g) * ncol +
                       2 * static_cast<size_t>(ncol);
  return (reals * sizeof(T) + 3) / 4;
}

inline int* grid_chain_ws(int* iws, const Plan& pl) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(iws + pl.gws);
  return reinterpret_cast<int*>((p + 15) & ~static_cast<uintptr_t>(15));
}

// The grid chain's CTAs and workspace for plan `pl` of a real panel with M
// live rows (a no-op when no block runs its chain on the grid): up to one
// CTA per SM, at least kRowsPerGridCta rows each; its workspace (the
// candidates, the published rows and every live row's origin) goes after
// the blocks' row moves in iws.
constexpr int kRowsPerGridCta = 8;

template <typename T>
int grid_chain_plan(int M, int device, Plan* pl) {
  if (pl->grid_blocks == 0) return 0;
  const int ncol = pl->b;  // a block's columns at most (w for one block)
  const size_t smem = static_cast<size_t>(ncol) * sizeof(T);
  const void* fn = reinterpret_cast<const void*>(panel_grid_chain_kernel<T>);
  cudaError_t err = opt_in_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_grid_chain_kernel<T>,
                                                      kGridThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int g = sms;  // one CTA per SM at most: the barrier is the cost
  const int by_rows = (M + kRowsPerGridCta - 1) / kRowsPerGridCta;
  if (by_rows < g) g = by_rows;
  if (g < 1) g = 1;
  pl->gchain = g;
  pl->gws = pl->iws_ints;
  // 3 more ints to put the reals on 16 bytes (grid_chain_ws)
  pl->iws_ints = pl->gws + 3 + grid_chain_real_ints<T>(g, ncol) + 6 * static_cast<size_t>(g) +
                 4 + M;
  return 0;
}


// The delayed kernels' shared memory (solve_plan: at most kSmemMax; the
// update: kUpdK steps of U and L): opt in once.  The bf16x3 update's 36 KB
// are static.
template <typename T, int kForm = kStepOrder>
int delay_opt_in() {
  static bool done = false;
  if (done) return 0;
  cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(panel_swap_solve_kernel<T>),
                                kSmemMax);
  if constexpr (kForm != kBf16x3) {
    if (err == cudaSuccess)
      err = opt_in_smem(reinterpret_cast<const void*>(panel_update_kernel<T, kForm>),
                        (kTile + kUpdRows) * kUpdK * sizeof(T));
    if (err == cudaSuccess)
      err = opt_in_smem(reinterpret_cast<const void*>(panel_update_kernel<T, kForm, true>),
                        (kTile + kUpdRows) * kUpdK * sizeof(T));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

// The side branch of run_cluster's carry, per host thread and device: a
// stream for the far parts of the delayed passes, an event after the chain a
// far part follows and one after the far part.  In a stream capture each
// wait on an event becomes an edge of the graph.
struct Branch {
  cudaStream_t side;
  cudaEvent_t chain, far;
};

inline int branch_for(Branch** out) {
  static thread_local Branch branches[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices)) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) return static_cast<int>(e);
  Branch& b = branches[dev];
  if (b.side == nullptr) {
    Branch n = {};
    e = cudaStreamCreateWithFlags(&n.side, cudaStreamNonBlocking);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&n.chain, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&n.far, cudaEventDisableTiming);
    if (e != cudaSuccess) return static_cast<int>(e);
    b = n;
  }
  *out = &b;
  return 0;
}

// Factor the panel on the cluster route of plan `pl` (route kRouteCluster):
// per block of pl.b steps the chain kernel (on the cluster, or for the
// plan's leading grid_blocks on the grid), then, unless one block takes the
// panel, the block's delayed pass (panel_swap_solve_kernel and the update),
// on `stream` without a host synchronisation.  `iws` holds pl.iws_ints
// int32s (the blocks' row moves, then the grid chain's workspace).  kForm:
// the form of the trailing update (UpdateForm).  `stats` (zeroed by the
// caller) counts the launches as PanelStats says.  `route`: the bf16x3
// form's update kernel (kUpdTiled, or kUpdSimple where forced).
//
// One block of look-ahead (the carry): where blocks j and j + 1 both run
// their chain on the cluster, the form is kStepOrder or kSumFirst, b is at
// most kCarryMax and the carry's shared memory fits beside the slab, the
// chain of block j + 1 takes block j's delayed pass in its own columns at
// load, and the rest of that pass (its far part: the two delayed kernels
// with `skip` = block j + 1's columns) runs on the side stream beside it:
//   far(j) after chain(j); chain(j + 2) after far(j) and chain(j + 1);
//   far(j + 1) after far(j) (one stream); a pass run in turn after every far
//   part before it; the side stream joined before the launcher returns.
// The panel's last block, a block beside a grid-chain block (the
// cooperative grid takes every SM), the bf16x3 form (its tensor-core update
// sums in its own order) and one-block plans keep the passes in turn.  Every
// element takes the same moves, U-row steps and rank-1 updates in the same
// order either way, each rounded as before, so the bits are the same.
template <typename T, int kForm = kStepOrder>
int run_cluster(T* A, int m, int w, int lda, int pivot, int ofs, const Plan& pl, void* piv,
                void* perm, void* info, void* iws, cudaStream_t stream, PanelStats* stats,
                int route = kUpdTiled) {
  int err = delay_opt_in<T, kForm>();
  if (err != 0) return err;
  int* moved = static_cast<int*>(iws);
  cudaError_t e = cudaMemsetAsync(moved, 0, pl.iws_ints * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int steps = m - ofs < w ? m - ofs : w;
  const size_t per_block = 1 + 4 * static_cast<size_t>(pl.B);  // a block's row-move ints
  auto chain_rows = [&](int k0) { return (m - ofs - k0 + pl.C - 1) / pl.C; };
  // does block blk's delayed pass go into chain blk + 1's load and beside it?
  auto carries = [&](int blk) {
    const int k1 = (blk + 1) * pl.b;
    if (kForm == kBf16x3 || pl.one_block || k1 >= steps || blk < pl.grid_blocks ||
        pl.b > kCarryMax)
      return false;
    return carry_base(chain_smem<T>(chain_rows(k1), pl.C, pl.B, true).total) +
               carry_smem<T>(pl.b, pl.B, chain_rows(k1)) <= kSmemMax;
  };
  // the delayed pass of the block at k0 (nb steps) on stream s, but for the
  // `skip` columns past it
  auto delayed = [&](int k0, int nb, const int* bmoved, int skip, cudaStream_t s) -> int {
    DelayArgs<T> d;
    d.a = A;
    d.m = m;
    d.w = w;
    d.lda = lda;
    d.r0 = ofs + k0;
    d.k0 = k0;
    d.nb = nb;
    d.skip = skip;
    d.moved = bmoved;
    if (w > nb) {
      const SolvePlan sp = solve_plan<T>(nb);
      if (sp.tc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
      d.tc = sp.tc;
      d.S = sp.S;
      panel_swap_solve_kernel<T><<<(w + sp.tc - 1) / sp.tc, kDelayThreads, sp.smem, s>>>(d);
      const cudaError_t le = cudaGetLastError();
      if (le != cudaSuccess) return static_cast<int>(le);
    }
    const int cols = w - k0 - nb - skip, rows = m - ofs - k0 - nb;
    if (cols > 0 && rows > 0) {
      if constexpr (kForm == kBf16x3) {
        Bf16x3Args u;
        u.l = A + static_cast<size_t>(d.r0 + nb) * lda + k0;
        u.u = A + static_cast<size_t>(d.r0) * lda + k0 + nb;
        u.c = A + static_cast<size_t>(d.r0 + nb) * lda + k0 + nb;
        u.ldl = u.ldu = u.ldc = lda;
        u.rows = rows;
        u.cols = cols;
        u.nb = nb;
        const int ue = launch_update_bf16x3<T>(u, s, route);
        if (ue != 0) return ue;
      } else {
        const int kc = nb < kUpdK ? nb : kUpdK;
        const dim3 grid((cols + kTile - 1) / kTile, (rows + kUpdRows - 1) / kUpdRows);
        const size_t smem = (kTile * kc + kUpdRows * kc) * sizeof(T);
        if (nb > kUpdK) {
          panel_update_kernel<T, kForm, true><<<grid, kDelayThreads, smem, s>>>(d);
        } else {
          panel_update_kernel<T, kForm><<<grid, kDelayThreads, smem, s>>>(d);
        }
        const cudaError_t le = cudaGetLastError();
        if (le != cudaSuccess) return static_cast<int>(le);
      }
      ++stats->updates;
    }
    return 0;
  };
  Branch* br = nullptr;
  bool joined = true;  // the stream has waited for every far part issued
  auto join = [&]() -> int {
    if (joined) return 0;
    joined = true;
    return static_cast<int>(cudaStreamWaitEvent(stream, br->far, 0));
  };
  auto blocks = [&]() -> int {
    for (int k0 = 0, blk = 0; k0 < steps; k0 += pl.b, ++blk) {
      const int nb = steps - k0 < pl.b ? steps - k0 : pl.b;
      const int ncol = pl.one_block ? w : nb;
      int* bmoved = moved + blk * per_block;
      const bool carry = blk > 0 && carries(blk - 1);
      int r = join();  // this chain after the far part of block blk - 2
      if (r != 0) return r;
      if (blk < pl.grid_blocks) {
        if constexpr (kForm == kStepOrder) {
          return static_cast<int>(cudaErrorInvalidValue);  // the float32 forms have no grid chain
        } else {
          const int g = pl.gchain;
          GridChainArgs<T> c;
          c.a = A;
          c.m = m;
          c.lda = lda;
          c.ofs = ofs;
          c.pivot = pivot;
          c.k0 = k0;
          c.nb = nb;
          c.ncol = ncol;
          c.rows = (m - ofs - k0 + g - 1) / g;
          c.piv = static_cast<int*>(piv);
          c.perm = static_cast<int*>(perm);
          c.info = static_cast<int*>(info);
          c.moved = bmoved;
          int* ws = grid_chain_ws(moved, pl);
          T* f = reinterpret_cast<T*>(ws);
          c.cval = f;
          c.crow = f + 2 * static_cast<size_t>(g);
          c.krow = c.crow + 2 * static_cast<size_t>(g) * ncol;
          int* gi = ws + grid_chain_real_ints<T>(g, pl.b);
          c.cidx = gi;
          c.cpid = gi + 2 * g;
          c.csrc = gi + 4 * g;
          c.kinf = gi + 6 * g;
          c.src = gi + 6 * g + 4;
          void* args[] = {&c};
          const cudaError_t le = cudaLaunchCooperativeKernel(
              reinterpret_cast<void*>(panel_grid_chain_kernel<T>), dim3(g), dim3(kGridThreads),
              args, static_cast<size_t>(ncol) * sizeof(T), stream);
          if (le != cudaSuccess) return static_cast<int>(le);
          ++stats->grid_blocks;
        }
      } else {
        ChainArgs<T> c;
        c.a = A;
        c.m = m;
        c.lda = lda;
        c.ofs = ofs;
        c.pivot = pivot;
        c.k0 = k0;
        c.nb = nb;
        c.ncol = ncol;
        c.rows = chain_rows(k0);
        c.piv = static_cast<int*>(piv);
        c.perm = static_cast<int*>(perm);
        c.info = static_cast<int*>(info);
        c.moved = bmoved;
        c.pmoved = carry ? bmoved - per_block : nullptr;
        c.pk0 = k0 - pl.b;
        c.pnb = carry ? pl.b : 0;
        c.sum_first = kForm == kSumFirst;
        c.trace = g_trace;
        c.steps = steps;
        c.blk = blk;
        size_t smem = chain_smem<T>(c.rows, pl.C, pl.B, true).total;
        if (carry) smem = carry_base(smem) + carry_smem<T>(pl.b, pl.B, c.rows);
        cudaLaunchAttribute attr[2];
        const cudaLaunchConfig_t cfg = chain_config(pl.C, smem, stream, attr, carry);
        const cudaError_t le = cudaLaunchKernelEx(&cfg, chain_kernel_for<T>(pl.B), c);
        if (le != cudaSuccess) return static_cast<int>(le);
        if (pl.C > 1) ++stats->lookaheads;
      }
      if (carry) {  // the rest of block blk - 1's pass, beside this chain
        cudaError_t le = cudaStreamWaitEvent(br->side, br->chain, 0);
        if (le != cudaSuccess) return static_cast<int>(le);
        joined = false;
        r = delayed(k0 - pl.b, pl.b, bmoved - per_block, nb, br->side);
        if (r != 0) return r;
        le = cudaEventRecord(br->far, br->side);
        if (le != cudaSuccess) return static_cast<int>(le);
        ++stats->carried;
      }
      if (carries(blk)) {  // the next chain takes this block's pass
        if (br == nullptr && (r = branch_for(&br)) != 0) return r;
        const cudaError_t le = cudaEventRecord(br->chain, stream);
        if (le != cudaSuccess) return static_cast<int>(le);
        continue;
      }
      if (pl.one_block) continue;
      if ((r = join()) != 0) return r;
      if ((r = delayed(k0, nb, bmoved, 0, stream)) != 0) return r;
    }
    return 0;
  };
  err = blocks();
  const int j = join();  // also after a failed launch: nothing is left on the side stream
  if (err != 0) return err;
  if (j != 0) return j;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
