// The wide DP row: banded EAPrunedDTW for bands wider than one warp holds
// (bw > 1024 columns), shared by kernels A, C, D and E.
//
// dtw_band.cuh's one-warp row keeps a lane's band in the registers of one
// warp, at most 32 columns a thread; it stays the row of every band up to
// 1024 columns (kernels/ops.py::band_layout). Past that a lane is a thread
// block of kWideWarps warps (256 threads), and its previous DP row lives in
// shared memory (bw floats rounded up to 8, at most ~227 KB: bands up to
// 58,048 columns, twice the longest query kernel B takes). Why shared
// memory and not registers across warps: the band's right shift and the
// prefix scans must cross warps through shared memory with a block barrier
// either way, and the registers of a block of warps run out near 8,192
// columns (221 registers a thread at CPT = 32 in the one-warp row), short
// of the 29,056 columns a search can reach; one layout covers every band
// from 1,025 up.
//
// Each row walks the band in segments of kWideSegment = 2048 slots, left
// to right: thread t holds slots g * 2048 + t * 8 .. + 7 of segment g in
// registers (the slot-to-thread map of the one-warp row at CPT = 8). A
// segment loads its slots' previous-row values from shared memory, reads
// the window's columns, forms d = c + min(top, left) with the one-warp
// row's band edges, and solves the closed-form row curr = P + prefix_min(d -
// P). Barriers: one after the warps' cost totals, one after their minima,
// one a row for the abandon vote (__syncthreads_or, which also ends the
// row's writes before the next row reads). The left neighbour of a
// segment's first slot was overwritten by the segment before it, so that
// segment keeps its last slot's old value aside (`edge`, by segment
// parity). next_start is a warp's min (__reduce_min_sync) and one
// atomicMin a warp in shared memory, by row parity; ok_last a flag.
//
// Where values live (the Hopper layout). Every shared-memory access of a
// row is laid out to take one wavefront (the first design took about 200
// L1 and shared-memory wavefronts a warp and row, most of them bank
// conflicts):
//  * The previous row is blocked in registers and striped in shared memory:
//    slot g * 2048 + 8t + k lives at word g * 2048 + k * S + t, S = 256 (a
//    whole segment) or, in a last segment of L < 2048 slots, ceil(L / 8)
//    (wide_word). For a fixed k a warp's 32 threads touch 32 consecutive
//    words, one wavefront, where the blocked layout (word = slot) put
//    threads t, t + 4, ... on one bank: 8 wavefronts. The neighbour slots
//    stay one wavefront: after a shift, slot base + 8 is thread t + 1's k =
//    0 (word g * 2048 + t + 1; thread 255 reads the next segment's first);
//    otherwise slot base - 1 is thread t - 1's k = 7. The row takes
//    wide_row_words(bw) = bw rounded up to 8 words. A swizzle within each
//    thread's 8 words would keep the row blocked, but its index depends on
//    t, and registers cannot be indexed by a value that is not a constant.
//  * The window (the lane's m normalized columns) is staged once a lane in
//    shared memory beside the row, column j at word j + (j >> 5)
//    (window_word): a warp reads columns lo + g * 2048 + 8t + k, 8 apart, and
//    the padding word every 32 columns spreads them over the banks, at most
//    2-way conflicted for every lo (8-way without it). It is staged only
//    where the extra m * 33 / 32 floats keep as many blocks on an SM as the
//    registers allow (kernels/ops.py::BandLayout.window_staged; at l =
//    16,384 the row's 64 KB and the window's 66 KB would leave 1 block,
//    not 2 or 3), else the window stays in global memory: the slab row (D,
//    E) or the lane's normalized window in the device scratch the wrapper
//    allocates (A, C).
//  * The query sample and the cb suffix's element of a row are read one
//    row ahead into registers (broadcast loads), off the row's critical
//    path; lane u of every warp reads warp u's total and minimum, and the
//    warps combine them by shuffles.
// What sets the pace then is the instruction stream: a warp issues every
// instruction of its 8 slots, the block's bookkeeping included, and two
// blocks of 8 warps an SM issue about as fast as three (the A/B runs of
// scripts/wide_ab.py). So a segment whose slots all lie in the band runs a
// form with no per-slot guard and a constant stride (kWhole); a band of
// one segment (up to 2048 columns) keeps each thread's 8 window columns in
// registers and moves them with the band, one new column a shift (kOne, as
// the one-warp row does); and a staged window's 8 columns otherwise load
// from two base addresses with constant offsets.
// The cb suffix sits in global memory (the cb slab row, or the scratch where
// warp 0 builds it with dtw_band.cuh's cb_suffix), so no cb slice limits m.
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
// reaches a distance rounds to nearest explicitly, as in dtw_band.cuh. The
// layout above moves values and changes no operation: the row gives the
// bits of the blocked layout (scripts/wide_ab.py compares two checkouts).
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

// A wide lane's shared memory besides its row and window (dynamic shared
// memory, wide_smem_bytes); kernels/ops.py::WIDE_STATIC_SMEM bounds its
// size.
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

// Words of dynamic shared memory: the previous row (bw slots striped by
// wide_word, bw rounded up to 8) and a staged window of m columns
// (window_word). kernels/ops.py::BandLayout.smem_bytes counts the same.
__host__ __device__ constexpr int wide_row_words(int bw) {
  return (bw + kWideCpt - 1) / kWideCpt * kWideCpt;
}
__host__ __device__ constexpr int wide_window_words(int m) {
  return m + (m >> 5);
}
inline size_t wide_smem_bytes(int bw, int m, bool staged) {
  return sizeof(float) *
         (size_t)(wide_row_words(bw) + (staged ? wide_window_words(m) : 0));
}

// The threads of segment g0 / kWideSegment that hold a slot: 256, or
// ceil(L / 8) in a last segment of L slots. Slot k of each of them lies
// this many words after its slot k - 1.
__device__ __forceinline__ int wide_stride(int g0, int bw) {
  return min(kWideThreads, (bw - g0 + kWideCpt - 1) / kWideCpt);
}

// The shared-memory word of row slot s: slot g0 + 8t + k at word
// g0 + k * wide_stride + t.
__device__ __forceinline__ int wide_word(int s, int bw) {
  const int g0 = s & ~(kWideSegment - 1), r = s - g0;
  return g0 + (r % kWideCpt) * wide_stride(g0, bw) + r / kWideCpt;
}

// The word of window column j: padded by one word every 32 columns where
// the window is staged in shared memory, j itself in global memory.
template <bool kStaged>
__device__ __forceinline__ int window_word(int j) {
  return kStaged ? j + (j >> 5) : j;
}

// A compile-time flag passed as a value (to a generic lambda).
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A lane's window as normalized values: staged in shared memory (kStaged),
// or in global memory (a slab row, or the lane's window normalized into the
// scratch).
template <bool kStaged>
struct WideWindow {
  const float* x;
  // Columns j0 .. j0 + kWideCpt - 1 into w: all of them (kAll), or those
  // of k < valid. Staged, column j0 + k lies at word j0 + (j0 >> 5) + k, one
  // word more from the column that reaches the next multiple of 32 (k >=
  // cross), so the loads take two base addresses and constant offsets.
  __device__ __forceinline__ float column(int j) const {
    return x[window_word<kStaged>(j)];
  }
  template <bool kAll>
  __device__ __forceinline__ void load(int j0, int valid,
                                       float (&w)[kWideCpt]) const {
    if constexpr (kStaged) {
      const float* below = x + j0 + (j0 >> 5);
      const float* above = below + 1;
      const int cross = 32 - (j0 & 31);
#pragma unroll
      for (int k = 0; k < kWideCpt; ++k) {
        if (kAll || k < valid) w[k] = (k < cross ? below : above)[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kWideCpt; ++k) {
        if (kAll || k < valid) w[k] = x[j0 + k];
      }
    }
  }
};

// Normalize `win`'s m columns into `dst` (shared memory where kStaged,
// else global; nothing where dst is null), every thread of the block taking
// a stride; warp 0 also builds the cb suffix into `cb` when it is not
// null. A block barrier (wide_lane's first) must follow.
template <bool kStaged, class Win>
__device__ __forceinline__ void wide_stage(const Win win, float* dst,
                                           const float* uq, const float* lq,
                                           float* cb, int m) {
  if (dst != nullptr) {
    for (int j = threadIdx.x; j < m; j += kWideThreads) {
      dst[window_word<kStaged>(j)] = win.norm(win.raw(j));
    }
  }
  if (cb != nullptr && threadIdx.x < 32) {
    cb_suffix(win, uq, lq, cb, m, threadIdx.x);
  }
}

// One lane's banded EAPrunedDTW on the whole block: its distance, or +inf
// where it abandoned. `row` is wide_row_words(bw) floats of shared memory,
// `cb` the lane's cb suffix in global memory (nullptr when cb is off);
// `inc`, `cnt` as in dtw_lane. Every thread of the block must call it and
// gets the same value; it begins with a block barrier, so the caller may
// write what the lane reads (window, scratch) just before, and must barrier
// before it writes what the lane read (row, window, scratch) after.
template <bool kShared, bool kInfo, bool kStaged>
__device__ float wide_lane(const float* __restrict__ qrow,
                           const WideWindow<kStaged> win, const float* cb,
                           float ub, const unsigned long long* inc, int n,
                           int m, int window, int bw, float* row,
                           WideShared& sh, Counts* cnt = nullptr) {
  constexpr int CPT = kWideCpt;
  const int tid = threadIdx.x, t = tid & 31, wid = tid >> 5;
  const int segs = (bw + kWideSegment - 1) / kWideSegment;
  __syncthreads();  // the previous lane is done with row and sh
  for (int s = tid; s < bw; s += kWideThreads) row[wide_word(s, bw)] = kBig;
  if (tid == 0) {
    sh.ns[0] = m;
    sh.ok = 0;
  }
  __syncthreads();

  int ns = 0;
  unsigned seen = __float_as_uint(ub);  // kShared: thread 0's read
  Counts c{0, 0};
  // A band of one segment keeps its window's columns in registers: slot k
  // of thread tid holds column lo + tid * 8 + k (0 past m), and moves with
  // the band (lo = 0 on row 0).
  float wcol[CPT];
  if (segs == 1) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = tid * CPT + k;
      wcol[k] = j < m ? win.column(j) : 0.f;
    }
  }
  // Row i's query sample and cb element, read one row ahead.
  float q_nxt = __ldg(qrow);
  float cb_nxt = cb != nullptr && window + 1 <= m - 1 ? cb[window + 1] : 0.f;
  for (int i = 0; i < n; ++i) {
    const int lo = min(max(i - window, 0), m - bw);
    const int hi = min(m - 1, i + window);
    const int first = max(ns, i - window);
    const bool shift = i - window >= 1 && i - window <= m - bw;
    const float q_i = q_nxt;
    const float cb_i = cb_nxt;
    if (i + 1 < n) q_nxt = __ldg(qrow + i + 1);
    if (cb != nullptr && i + window + 2 <= m - 1) cb_nxt = cb[i + window + 2];
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
    // One segment of the row, starting at slot g0. kWhole: every slot of
    // every thread lies in the band (every segment but a band's last
    // partial one), so no slot needs a guard and the row's stride is 256.
    // kOne: the band's only segment, its window in wcol.
    auto segment = [&](int g, auto whole, auto one) {
      constexpr bool kWhole = decltype(whole)::value;
      constexpr bool kOne = decltype(one)::value;
      const int g0 = g * kWideSegment;
      const int base = g0 + tid * CPT;
      const int stride = kWhole ? kWideThreads : wide_stride(g0, bw);
      float* const seg = row + g0 + tid;  // slot base + k at seg[k * stride]
      float own[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        own[k] = kWhole || base + k < bw ? seg[k * stride] : kBig;
      }
      if (tid == kWideThreads - 1) sh.edge[g & 1] = own[CPT - 1];
      float nb;  // the neighbour slot beyond the thread's own
      if (shift) {  // slot base + CPT: thread tid + 1's first
        nb = base + CPT < bw
                 ? row[tid == kWideThreads - 1 ? g0 + kWideSegment
                                               : g0 + tid + 1]
                 : kBig;
      } else if (base == 0) {
        nb = i == 0 ? 0.f : kBig;  // the virtual corner left of column 0
      } else if (tid == 0) {
        nb = sh.edge[(g - 1) & 1];
      } else {  // slot base - 1: thread tid - 1's last; past bw: no slot
        nb = kWhole || base - 1 < bw ? seg[(CPT - 1) * stride - 1] : kBig;
      }
      const int slot_lo = max(first - lo, 0) - base;
      const int slot_hi = min(hi - lo, bw - 1) - base;
      const unsigned exists = bit_span(min(max(slot_lo, 0), CPT),
                                       min(max(slot_hi + 1, 0), CPT));
      float col[CPT];  // the window's columns of the thread's slots
      if constexpr (kOne) {
        if (shift) {  // each slot takes the next one's column
#pragma unroll
          for (int k = 0; k + 1 < CPT; ++k) wcol[k] = wcol[k + 1];
          const int j = lo + base + CPT - 1;
          wcol[CPT - 1] = j < m ? win.column(j) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < CPT; ++k) col[k] = wcol[k];
      } else {
        win.template load<kWhole>(lo + base, bw - base, col);
      }
      float p[CPT], x[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        // After a shift a slot's top is the next slot's old value (BIG past
        // the band: own[] holds BIG there, as nb does past bw).
        const float top = shift ? (k + 1 < CPT ? own[k + 1] : nb) : own[k];
        const float left = shift ? own[k] : (k > 0 ? own[k - 1] : nb);
        float cost = 0.f;
        if (kWhole || base + k < bw) {
          const float diff = __fsub_rn(q_i, col[k]);
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
          thr = __fsub_rn(ub, cb_i);
        }
      }
      // The levels across the warps, from their totals: lane u of every
      // warp holds warp u's total and runs Sklansky on the totals by
      // shuffles; at each level every slot adds what its warp adds (the
      // total of the lower half of its block, before the level).
      const int u = t & (kWideWarps - 1);
      float vl = sh.tot[u];
#pragma unroll
      for (int s = 1; s < kWideWarps; s <<= 1) {
        const float add = __shfl_sync(kFull, vl, (wid & ~(2 * s - 1)) + s - 1);
        const float lower =
            __shfl_sync(kFull, vl, (u & ~(2 * s - 1)) + s - 1);
        if (u & s) vl = __fadd_rn(vl, lower);
        if (wid & s) {
#pragma unroll
          for (int k = 0; k < CPT; ++k) p[k] = __fadd_rn(p[k], add);
        }
      }
      // the segment's last slot's P
      float last = __shfl_sync(kFull, vl, kWideWarps - 1);
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
      // The warps' minima: lane u holds the least of warps 0 .. u.
      float ml = sh.mins[u];
#pragma unroll
      for (int o = 1; o < kWideWarps; o <<= 1) {
        ml = fminf(ml, __shfl_up_sync(kFull, ml, o, kWideWarps));
      }
      const float upto = __shfl_sync(kFull, ml, wid > 0 ? wid - 1 : 0);
      mbefore = fminf(mbefore, wid > 0 ? fminf(cmin, upto) : cmin);
      cmin = fminf(cmin, __shfl_sync(kFull, ml, kWideWarps - 1));

      unsigned le = 0;  // the slots under the threshold, as bits
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        float curr = kBig;
        if ((exists >> k) & 1u) {
          curr = fminf(__fadd_rn(p[k], fminf(mbefore, x[k])), kBig);
          if (curr <= thr) le |= 1u << k;
        }
        if (kWhole || base + k < bw) seg[k * stride] = curr;
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
    };
    if (segs == 1) {
      if (bw == kWideSegment) {
        segment(0, Flag<true>{}, Flag<true>{});
      } else {
        segment(0, Flag<false>{}, Flag<true>{});
      }
    } else {
      for (int g = 0; g < segs; ++g) {
        if ((g + 1) * kWideSegment <= bw) {
          segment(g, Flag<true>{}, Flag<false>{});
        } else {
          segment(g, Flag<false>{}, Flag<false>{});
        }
      }
    }
    // next_start: the warp's least candidate, one atomic a warp (a thread
    // with no slot under the threshold offers m, which changes no min).
    const int warp_ns = __reduce_min_sync(kFull, my_ns);
    if (t == 0 && warp_ns < m) atomicMin(&sh.ns[i & 1], warp_ns);
    if (!__syncthreads_or(my_le)) {  // border collision: abandon
      if constexpr (kInfo) *cnt = c;
      return INFINITY;
    }
    ns = sh.ns[i & 1];
  }
  if constexpr (kInfo) *cnt = c;
  if (!sh.ok) return INFINITY;
  const int lo_fin = min(max(n - 1 - window, 0), m - bw);
  return row[wide_word((m - 1) - lo_fin, bw)];
}

// A wide kernel's dynamic shared-memory limit raised to `smem` bytes where
// they pass the default 48 KB (each launch sets it for its own band).
template <class Kernel>
cudaError_t wide_smem_limit(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Thread blocks of a wide kernel that stay resident on one SM with `smem`
// bytes of dynamic shared memory each (the occupancy query): with smem = 0,
// the blocks its registers allow. kernels/ops.py asks once for each kernel,
// shared memory and card, and sizes the grid from it.
template <class Kernel>
cudaError_t wide_blocks_per_sm(Kernel kernel, size_t smem, int* per_sm) {
  cudaError_t err = wide_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kWideThreads, smem);
}

}  // namespace dtw_band
