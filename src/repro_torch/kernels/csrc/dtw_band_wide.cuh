// The wide DP row: banded EAPrunedDTW for bands wider than one warp holds
// (bw > 1024 columns), shared by kernels A, C, D and E.
//
// dtw_band.cuh's one-warp row keeps a lane's band in the registers of one
// warp, at most 32 columns a thread; it stays the row of every band up to
// 1024 columns (kernels/ops.py::band_layout). Past that a lane is a thread
// block of kWideWarps warps (256 threads), and its previous DP row lives in
// shared memory (bw floats, at most ~227 KB: bands up to 58,048 columns,
// twice the longest query kernel B takes). Why shared memory and not
// registers across warps: the band's right shift and the prefix scans must
// cross warps through shared memory with a block barrier either way, and
// the registers of a block of warps run out near 8,192 columns (221
// registers a thread at CPT = 32 in the one-warp row), short of the 29,056
// columns a search can reach; one layout covers every band from 1,025 up.
//
// Each row walks the band in segments of kWideSegment = 2048 slots, left
// to right: thread t holds slots g * 2048 + t * 8 .. + 7 of segment g in
// registers (the slot-to-thread map of the one-warp row at CPT = 8). A
// segment loads its slots' previous-row values from shared memory, reads
// the window's columns from global memory (the slab row, or the lane's
// window normalized once into a device scratch that the wrapper
// allocates), forms d = c + min(top, left) with the one-warp row's band
// edges, and solves the closed-form row curr = P + prefix_min(d - P).
// Barriers: one after the warps' cost totals, one after their minima, one a
// row for the abandon vote (__syncthreads_or, which also ends the row's
// writes before the next row reads). The left neighbour of a segment's
// first slot was overwritten by the segment before it, so that segment
// keeps its last slot's old value aside (`edge`, by segment parity).
// next_start is an atomicMin in shared memory, by row parity; ok_last a
// flag. The cb suffix sits in global memory (the cb slab row, or the
// scratch where warp 0 builds it with dtw_band.cuh's cb_suffix), read one
// broadcast element a row, so no cb slice limits m.
//
// P's summation order: Sklansky over each segment of 2048 slots, padded
// with zero costs past bw (3 levels in a thread's registers, 5 by warp
// shuffles, then 3 across the 8 warps from their totals in shared
// memory), then the P of the previous segment's last slot added to every
// slot (the first segment adds none). A band of up to 2048 columns is
// thus added in Sklansky order over its padded band, as the one-warp row
// adds its own. The plain version cannot match it on the card: PyTorch's
// CUDA cumsum scans a row longer than 1024 in chained chunks whose width
// depends on how many rows it scans, 1024 columns only past 2^20 rows (8
// GB a tensor at bw = 2048). chip_smoke.py measures the gap (TOL_WIDE).
// The prefix min is exact in any order. Every product and sum that
// reaches a distance rounds to nearest explicitly, as in dtw_band.cuh.
//
// Incumbent (kShared, kernels C and E): thread 0 holds the read issued one
// period ahead and publishes it in shared memory every kRereadRows rows;
// every thread takes the smaller of its bound and that value after the
// row's first barrier. Counters (kInfo): as the one-warp row counts them.
#pragma once

#include "dtw_band.cuh"

namespace dtw_band {

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideCpt = 8;
constexpr int kWideSegment = kWideThreads * kWideCpt;

// A wide lane's shared memory besides its row (bw floats of dynamic shared
// memory); kernels/ops.py::WIDE_STATIC_SMEM bounds its size.
struct WideShared {
  float tot[kWideWarps];   // the warps' cost totals of a segment
  float mins[kWideWarps];  // the warps' minima of d - P
  float edge[2];           // a segment's last slot, previous row
  float seen;              // kShared: the incumbent distance published
  float ubq;               // C, E: the bound a drawn lane starts under
  int ns[2];               // next_start being reduced, by row parity
  int ok;                  // ok_last of the last row
  int j;                   // C, E: the lane drawn
};
static_assert(sizeof(WideShared) <= 256, "ops.WIDE_STATIC_SMEM");

// A lane's window as normalized values in global memory: a slab row, or
// the lane's window normalized into the scratch.
struct WideWindow {
  const float* x;
  __device__ __forceinline__ float at(int j) const { return x[j]; }
};

// Normalize `win`'s m columns into `dst` (global), every thread of the
// block taking a stride; warp 0 also builds the cb suffix into `cb` when
// it is not null. A block barrier (wide_lane's first) must follow.
template <class Win>
__device__ __forceinline__ void wide_stage(const Win win, float* dst,
                                           const float* uq, const float* lq,
                                           float* cb, int m) {
  if (dst != nullptr) {
    for (int j = threadIdx.x; j < m; j += kWideThreads) {
      dst[j] = win.norm(win.raw(j));
    }
  }
  if (cb != nullptr && threadIdx.x < 32) {
    cb_suffix(win, uq, lq, cb, m, threadIdx.x);
  }
}

// One lane's banded EAPrunedDTW on the whole block: its distance, or +inf
// where it abandoned. `row` is bw floats of shared memory, `cb` the lane's
// cb suffix in global memory (nullptr when cb is off); `inc`, `cnt` as in
// dtw_lane. Every thread of the block must call it and gets the same
// value; it begins with a block barrier, so the caller may write what the
// lane reads (scratch) just before, and must barrier before it writes what
// the lane read (row, scratch) after.
template <bool kShared, bool kInfo>
__device__ float wide_lane(const float* __restrict__ qrow, const WideWindow win,
                           const float* cb, float ub,
                           const unsigned long long* inc, int n, int m,
                           int window, int bw, float* row, WideShared& sh,
                           Counts* cnt = nullptr) {
  constexpr int CPT = kWideCpt;
  const int tid = threadIdx.x, t = tid & 31, wid = tid >> 5;
  const int segs = (bw + kWideSegment - 1) / kWideSegment;
  __syncthreads();  // the previous lane is done with row and sh
  for (int s = tid; s < bw; s += kWideThreads) row[s] = kBig;
  if (tid == 0) {
    sh.ns[0] = m;
    sh.ok = 0;
  }
  __syncthreads();

  int ns = 0;
  unsigned seen = __float_as_uint(ub);  // kShared: thread 0's read
  Counts c{0, 0};
  for (int i = 0; i < n; ++i) {
    const int lo = min(max(i - window, 0), m - bw);
    const int hi = min(m - 1, i + window);
    const int first = max(ns, i - window);
    const bool shift = i - window >= 1 && i - window <= m - bw;
    const float q_i = __ldg(qrow + i);
    const bool reread = kShared && (i & (kRereadRows - 1)) == 0;
    if (reread && tid == 0) {
      sh.seen = __uint_as_float(seen);
      seen = (unsigned)(*(const volatile unsigned long long*)inc >> 32);
    }
    if constexpr (kInfo) {
      ++c.rows;
      c.cells += max(0, hi - max(first, 0) + 1);
    }
    float thr = ub, carry = 0.f, cmin = INFINITY;
    int my_ns = m;
    bool my_le = false;
    for (int g = 0; g < segs; ++g) {
      const int base = g * kWideSegment + tid * CPT;
      float own[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) own[k] = base + k < bw ? row[base + k] : kBig;
      if (tid == kWideThreads - 1) sh.edge[g & 1] = own[CPT - 1];
      float nb;  // the neighbour slot beyond the thread's own
      if (shift) {
        nb = base + CPT < bw ? row[base + CPT] : kBig;
      } else if (base == 0) {
        nb = i == 0 ? 0.f : kBig;  // the virtual corner left of column 0
      } else if (tid == 0) {
        nb = sh.edge[(g - 1) & 1];
      } else {
        nb = base - 1 < bw ? row[base - 1] : kBig;  // past bw: no slot
      }
      const int slot_lo = max(first - lo, 0) - base;
      const int slot_hi = min(hi - lo, bw - 1) - base;
      const unsigned exists = bit_span(min(max(slot_lo, 0), CPT),
                                       min(max(slot_hi + 1, 0), CPT));
      float p[CPT], x[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        float top, left;
        if (shift) {
          top = base + k + 1 < bw ? (k + 1 < CPT ? own[k + 1] : nb) : kBig;
          left = own[k];
        } else {
          top = own[k];
          left = k > 0 ? own[k - 1] : nb;
        }
        float cost = 0.f;
        if (base + k < bw) {
          const float diff = __fsub_rn(q_i, win.at(lo + base + k));
          cost = __fmul_rn(diff, diff);
        }
        x[k] = (exists >> k) & 1u ? __fadd_rn(cost, fminf(top, left)) : kBig;
        p[k] = cost;
      }
      band_prefix_sum<CPT>(p, t);  // the segment's levels within a warp
      if (t == 31) sh.tot[wid] = p[CPT - 1];
      __syncthreads();
      if (g == 0) {
        if (tid == 0) sh.ns[(i + 1) & 1] = m;  // row i - 1 read it
        if (reread) ub = fminf(ub, sh.seen);
        thr = ub;
        if (cb != nullptr && i + window + 1 <= m - 1) {
          thr = __fsub_rn(ub, cb[i + window + 1]);
        }
      }
      // The levels across the warps, from their totals: Sklansky on the
      // totals in registers, each slot adding what its warp adds.
      float v[kWideWarps];
#pragma unroll
      for (int u = 0; u < kWideWarps; ++u) v[u] = sh.tot[u];
#pragma unroll
      for (int s = 1; s < kWideWarps; s <<= 1) {
        const int src = (wid & ~(2 * s - 1)) + s - 1;
        float add = 0.f;
#pragma unroll
        for (int u = 0; u < kWideWarps; ++u) {
          if (u == src) add = v[u];
        }
        if (wid & s) {
#pragma unroll
          for (int k = 0; k < CPT; ++k) p[k] = __fadd_rn(p[k], add);
        }
#pragma unroll
        for (int u = 0; u < kWideWarps; ++u) {
          if (u & s) v[u] = __fadd_rn(v[u], v[(u & ~(2 * s - 1)) + s - 1]);
        }
      }
      float last = v[kWideWarps - 1];  // the segment's last slot's P
      if (g > 0) {
#pragma unroll
        for (int k = 0; k < CPT; ++k) p[k] = __fadd_rn(p[k], carry);
        last = __fadd_rn(last, carry);
      }
      carry = last;

      float mrun = INFINITY;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        mrun = fminf(mrun, __fsub_rn(x[k], p[k]));
        x[k] = mrun;  // the thread's prefix min of d - P
      }
      const float wincl = warp_scan_min(mrun);
      float mbefore = __shfl_up_sync(kFull, wincl, 1);
      if (t == 0) mbefore = INFINITY;
      if (t == 31) sh.mins[wid] = wincl;
      __syncthreads();
      float before = cmin, all = cmin;
#pragma unroll
      for (int u = 0; u < kWideWarps; ++u) {
        const float mu = sh.mins[u];
        if (u < wid) before = fminf(before, mu);
        all = fminf(all, mu);
      }
      mbefore = fminf(mbefore, before);
      cmin = all;

      unsigned le = 0;  // the slots under the threshold, as bits
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        float curr = kBig;
        if ((exists >> k) & 1u) {
          curr = fminf(__fadd_rn(p[k], fminf(mbefore, x[k])), kBig);
          if (curr <= thr) le |= 1u << k;
        }
        if (base + k < bw) row[base + k] = curr;
      }
      if (le) {
        my_ns = min(my_ns, lo + base + __ffs(le) - 1);
        my_le = true;
      }
      if (i == n - 1) {  // did column m - 1 lie under the threshold?
        const int last_slot = (m - 1) - lo - base;
        if (last_slot >= 0 && last_slot < CPT && ((le >> last_slot) & 1u)) {
          sh.ok = 1;
        }
      }
    }
    if (my_le) atomicMin(&sh.ns[i & 1], my_ns);
    if (!__syncthreads_or(my_le)) {  // border collision: abandon
      if constexpr (kInfo) *cnt = c;
      return INFINITY;
    }
    ns = sh.ns[i & 1];
  }
  if constexpr (kInfo) *cnt = c;
  if (!sh.ok) return INFINITY;
  const int lo_fin = min(max(n - 1 - window, 0), m - bw);
  return row[(m - 1) - lo_fin];
}

// A wide kernel's dynamic shared-memory limit raised to `smem` bytes where
// they pass the default 48 KB (each launch sets it for its own band).
template <class Kernel>
cudaError_t wide_smem_limit(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Thread blocks of a wide kernel that stay resident on the card at once,
// with `smem` bytes of dynamic shared memory each: a launch's grid, which
// kernels/ops.py asks once for each kernel and band.
template <class Kernel>
cudaError_t wide_resident_blocks(Kernel kernel, size_t smem,
                                 long long* blocks) {
  cudaError_t err = wide_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWideThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

}  // namespace dtw_band
