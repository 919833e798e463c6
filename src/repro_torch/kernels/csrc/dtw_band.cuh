// The banded EAPrunedDTW program shared by the port's DTW kernels.
//
// One copy of the DP on the card, as repro/kernels/dtw_band.py::_dp_row is
// the one copy in the JAX package: kernel A (dtw_ea_fused.cu), kernel D
// (dtw_ea_slab.cu) and kernels C and E (dtw_ea_persistent.cu) include this
// header and differ only in where a lane's window comes from (a loader:
// RefWindow slices and normalizes the reference, SlabWindow reads a row of
// a normalized slab) and who carries its upper bound.
//
// Layout: one warp runs one lane, with no block barrier anywhere in a lane.
// The band's columns live in registers, CPT contiguous slots a thread
// (thread t holds slots t*CPT .. t*CPT + CPT - 1); the band is padded to
// 32 * CPT slots, and a slot r >= bw never exists. CPT is a template
// parameter in {1, 2, 4, 8, 16, 32}, chosen by the wrapper
// (kernels/ops.py::cols_per_thread): 8 at the main path's bw = 224. Each
// thread also holds the window values of its slots. The band moves right by
// at most one column a row; when it does, every slot takes its right
// neighbour's value (one __shfl_down_sync across the thread edge) and the
// last slot takes the next column of the window, which the warp reads 32
// columns at a time, a chunk ahead, so no row waits on memory. The query is
// read the same way, 32 samples a chunk, and broadcast a row by a shuffle.
// The cb suffix (use_cb) sits in the warp's own m-float slice of shared
// memory; a row reads one broadcast element of it.
//
// Each row (dp_row): the window-following offset lo(i) = clip(i - w, 0,
// m - bw) with its 0/1 shift; the cost c = (q_i - x_col)^2;
// d = c + min(top, left), top and left from the thread's own registers and
// one shuffle for the segment's edge; the closed-form row
// curr = P + prefix_min(d - P), P by a Sklansky scan over the 32 * CPT
// slots (log2(CPT) levels in registers, then one shuffle a level), the
// prefix min by a sequential scan of the thread's CPT slots and a 5-step
// warp scan of the thread minima; the threshold ub - cb[i + w + 1]; the
// abandon test any(curr <= thr) by __any_sync; next_start by
// __reduce_min_sync; ok_last by __any_sync on the last row. Band edges
// follow repro/kernels/dtw_band.py:222-262: the top fill is BIG past the
// previous band's right edge after a shift, and the virtual corner left of
// column 0 is 0 on row 0 and BIG on later rows. The finish index is that of
// _round_sweep (:362-364). The cb tail is zero once i + w + 1 > m - 1
// (:264-268). BIG = 1e30 stays the finite sentinel: +inf in the scan would
// give inf - inf = NaN.
//
// Rounding: P carries its rounding into a distance (at l = 1024 it reaches
// ~1e3-1e4 where a distance is ~10), so the order in which P adds decides
// near-ties. A sequential sum inside each thread and a tree across the 32
// threads (the first design of this row) gave query 7 of the main path,
// whose two best windows lie 2.3e-5 apart, an exact tie that the plain
// version on the card does not see, and another winner. P therefore adds
// in Sklansky order over the padded band, the order of PyTorch's CUDA
// cumsum along a row when it scans many rows at once, so the plain version
// on the card in a large batch gives the same bits; against the CPU's
// sequential scan a distance differs by O(1) ulp of P per row. The prefix
// min is exact in any order. Every product and sum that reaches a distance is
// written with an explicit round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn), so nvcc cannot contract it into an FMA in one
// kernel and not in another: A, C, D and E give the same bits for the same
// window. The pruning of a lane depends on its ub only through next_start
// and the abandon test; P sums every band slot whether its cell exists or
// not, so a lane that finishes gives the same bits under any ub it
// finishes under unless a pruned cell ties the optimum within rounding
// (kernels C and E rest on this; tests/test_torch_persistent.py and
// tests/test_torch_warp_row.py check it).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace dtw_band {

constexpr float kBig = 1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

// Rows between two reads of a shared incumbent (kernels C and E): each read
// is issued one period before the row that uses it, so its latency hides
// behind the rows in between.
constexpr int kRereadRows = 32;
static_assert((kRereadRows & (kRereadRows - 1)) == 0, "a power of two");

// The columns a thread (CPT) the DTW kernels are instantiated for: CALL(c)
// for each, in a switch on the CPT the wrapper chose.
#define DTW_CPT_CASES(CALL) CALL(1) CALL(2) CALL(4) CALL(8) CALL(16) CALL(32)

// Lanes (warps) a thread block of a DTW kernel runs: `most`, halved while
// their cb slices (m floats a warp, when use_cb) overflow the 227 KB of
// shared memory a block may use.
inline int block_warps(int most, int m, int use_cb) {
  int w = most;
  while (w > 1 && use_cb && (size_t)w * m * sizeof(float) > 232448) w >>= 1;
  return w;
}

// Inclusive prefix sum over the 32 threads of the warp.
__device__ __forceinline__ float warp_scan_sum(float x, int t) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (t >= o) x = __fadd_rn(x, y);
  }
  return x;
}

// Inclusive prefix min over the 32 threads of the warp. A thread below the
// offset gets its own value back from the shuffle, which leaves a min as
// it is.
__device__ __forceinline__ float warp_scan_min(float x) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) x = fminf(x, __shfl_up_sync(kFull, x, o));
  return x;
}

// Bits a .. b - 1 of a word (none when b <= a), for 0 <= a, b <= 32.
__device__ __forceinline__ unsigned bit_span(int a, int b) {
  const unsigned below_b = b >= 32 ? ~0u : (1u << b) - 1u;
  const unsigned below_a = a >= 32 ? ~0u : (1u << a) - 1u;
  return below_b & ~below_a;
}

// A lane's window sliced from the reference: column j is
// (ref[start + j] - mu) / sg, sg clamped by the caller. The division is
// IEEE, as on the CPU and in the slab that SlabWindow reads.
struct RefWindow {
  const float* x;  // ref + start
  float mu, sg;
  int m;
  __device__ __forceinline__ float raw(int j) const {
    return j < m ? __ldg(x + j) : 0.f;
  }
  __device__ __forceinline__ float norm(float v) const {
    return __fdiv_rn(__fsub_rn(v, mu), sg);
  }
};

// A lane's window as one row of a normalized (lanes, m) slab.
struct SlabWindow {
  const float* x;  // slab + lane * m
  int m;
  __device__ __forceinline__ float raw(int j) const {
    return j < m ? __ldg(x + j) : 0.f;
  }
  __device__ __forceinline__ float norm(float v) const { return v; }
};

// The UCR cb suffix of a lane's window against its query's envelope:
// cb[j] = sum_{i >= j} LB_Keogh term i, by chunks of 32 from the right.
// Thread t takes element ch * 32 + (31 - t), so a prefix scan over threads
// is a suffix sum over the chunk. `cb` is the warp's own m floats of shared
// memory; every thread of the warp must call it.
template <class Win>
__device__ __forceinline__ void cb_suffix(const Win win, const float* uq,
                                          const float* lq, float* cb, int m,
                                          int t) {
  __syncwarp();  // the previous lane's rows have read their cb
  float carry = 0.f;
  for (int ch = (m - 1) >> 5; ch >= 0; --ch) {
    const int j = (ch << 5) + (31 - t);
    float term = 0.f;
    if (j < m) {
      const float v = win.norm(win.raw(j));
      const float u = __ldg(uq + j), l = __ldg(lq + j);
      const float over = v > u ? __fsub_rn(v, u) : 0.f;
      const float under = v < l ? __fsub_rn(l, v) : 0.f;
      term = __fadd_rn(__fmul_rn(over, over), __fmul_rn(under, under));
    }
    const float sum = warp_scan_sum(term, t);
    if (j < m) cb[j] = __fadd_rn(sum, carry);
    carry = __fadd_rn(carry, __shfl_sync(kFull, sum, 31));
  }
  __syncwarp();
}

// A cb suffix given as one row of a (lanes, m) slab, copied into the
// warp's shared-memory slice.
__device__ __forceinline__ void cb_copy(const float* src, float* cb, int m,
                                        int t) {
  __syncwarp();
  for (int j = t; j < m; j += 32) cb[j] = __ldg(src + j);
  __syncwarp();
}

// Inclusive prefix sum of the warp's 32 * CPT band slots in place, by a
// Sklansky scan: at level s (1, 2, 4, ...) every slot whose index has bit s
// set adds the last slot of the lower half of its 2s-block. The first
// log2(CPT) levels stay inside a thread's registers, each later one takes
// one shuffle. This is the order in which PyTorch's CUDA cumsum adds a row
// of up to 1024 columns when it scans many rows at once (more than 2^17 at
// bw = 224): the plain version (kernels/dtw_band.py::dtw_ea_plain) run on
// the card in a large batch gets the same P bits.
template <int CPT>
__device__ __forceinline__ void band_prefix_sum(float (&p)[CPT], int t) {
#pragma unroll
  for (int s = 1; s < CPT; s <<= 1) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (k & s) p[k] = __fadd_rn(p[k], p[(k & ~(2 * s - 1)) + s - 1]);
    }
  }
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {  // s threads: s * CPT slots
    float lower = __shfl_sync(kFull, p[CPT - 1], (t & ~(2 * s - 1)) + s - 1);
    if (!(t & s)) lower = 0.f;  // P >= +0, so adding +0 changes no bit
#pragma unroll
    for (int k = 0; k < CPT; ++k) p[k] = __fadd_rn(p[k], lower);
  }
}

// Per-lane state carried from one row to the next, in registers.
template <int CPT>
struct Lane {
  float prev[CPT];  // the previous row's band, slots t*CPT + k
  float win[CPT];   // the window value of each slot's column
  int ns;           // next_start: first column that may start a path
  int ok_last;      // the last row reached column m - 1 under the threshold
};

// One banded DP row i of the lane: reads the previous row from st.prev and
// writes this row into it. `shift` says that the band moved right by one
// column since row i - 1; `edge` is then the window value of column
// lo + 32 * CPT - 1. Returns false, the
// same on every thread of the warp, when no cell of the row lies under
// `thr`: the lane abandons. No block barrier: the warp is the lane.
template <int CPT>
__device__ __forceinline__ bool dp_row(int i, bool shift, float q_i,
                                       float edge, float thr, int n, int m,
                                       int window, int bw, int t,
                                       Lane<CPT>& st) {
  const int base = t * CPT;
  const int lo = min(max(i - window, 0), m - bw);
  const int hi = min(m - 1, i + window);
  const int first = max(st.ns, i - window);
  // The slots whose cells exist, as bits of this thread's CPT slots: band
  // slots from the first column that may start a path to the window's
  // right edge.
  const int slot_lo = max(first - lo, 0) - base;
  const int slot_hi = min(hi - lo, bw - 1) - base;
  const unsigned exists = bit_span(min(max(slot_lo, 0), CPT),
                                   min(max(slot_hi + 1, 0), CPT));

  float top[CPT], left[CPT];
  if (shift) {  // warp-uniform
    const float nw = __shfl_down_sync(kFull, st.win[0], 1);
    const float up = __shfl_down_sync(kFull, st.prev[0], 1);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      st.win[k] = k + 1 < CPT ? st.win[k + 1] : (t == 31 ? edge : nw);
      top[k] = base + k + 1 < bw ? (k + 1 < CPT ? st.prev[k + 1] : up) : kBig;
      left[k] = st.prev[k];
    }
  } else {
    const float dn = __shfl_up_sync(kFull, st.prev[CPT - 1], 1);
    const float corner = i == 0 ? 0.f : kBig;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      top[k] = st.prev[k];
      left[k] = k > 0 ? st.prev[k - 1] : (t > 0 ? dn : corner);
    }
  }

  // Costs and d.
  float p[CPT], x[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    float c = 0.f;
    if (base + k < bw) {
      const float diff = __fsub_rn(q_i, st.win[k]);
      c = __fmul_rn(diff, diff);
    }
    x[k] = (exists >> k) & 1u ? __fadd_rn(c, fminf(top[k], left[k])) : kBig;
    p[k] = c;
  }
  band_prefix_sum<CPT>(p, t);
  float mrun = INFINITY;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    mrun = fminf(mrun, __fsub_rn(x[k], p[k]));
    x[k] = mrun;  // the thread's prefix min of d - P
  }
  float mbefore = __shfl_up_sync(kFull, warp_scan_min(mrun), 1);
  if (t == 0) mbefore = INFINITY;

  unsigned le = 0;  // the slots under the threshold, as bits
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    float curr = kBig;
    if ((exists >> k) & 1u) {
      curr = fminf(__fadd_rn(p[k], fminf(mbefore, x[k])), kBig);
      if (curr <= thr) le |= 1u << k;
    }
    st.prev[k] = curr;
  }
  if (!__any_sync(kFull, le != 0)) return false;  // border collision: abandon
  st.ns = __reduce_min_sync(kFull, le ? lo + base + __ffs(le) - 1 : m);
  if (i == n - 1) {  // did column m - 1 lie under the threshold?
    const int last = (m - 1) - lo - base;
    st.ok_last =
        __any_sync(kFull, last >= 0 && last < CPT && ((le >> last) & 1u));
  }
  return true;
}

// One lane's banded EAPrunedDTW: its distance, or +inf where it abandoned.
// `qrow` is the query (n samples, global memory), `win` the window loader,
// `cb` the warp's cb slice (nullptr when cb is off). With kShared, `inc`
// is the query's incumbent word ((distance bits) << 32 | rank) and the lane
// runs against the smaller of `ub` and the distance it last read there,
// re-read every kRereadRows rows. Every thread of the warp must call it and
// gets the same value.
template <int CPT, bool kShared, class Win>
__device__ __forceinline__ float dtw_lane(
    const float* __restrict__ qrow, const Win win, const float* cb, float ub,
    const unsigned long long* inc, int n, int m, int window, int bw) {
  const int t = threadIdx.x & 31;
  Lane<CPT> st;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    st.prev[k] = kBig;
    st.win[k] = win.norm(win.raw(t * CPT + k));
  }
  st.ns = 0;
  st.ok_last = 0;
  // The query and the window's right edge, 32 values a chunk: `cur` is in
  // use, `nxt` in flight. Edge columns start at 32 * CPT.
  const int e0 = 32 * CPT;
  float q_cur = t < n ? __ldg(qrow + t) : 0.f;
  float q_nxt = 32 + t < n ? __ldg(qrow + 32 + t) : 0.f;
  float e_cur = win.norm(win.raw(e0 + t));
  float e_nxt = win.raw(e0 + 32 + t);
  int edges = 0;
  // kShared: the incumbent distance read one period ago (lane 0).
  unsigned seen = __float_as_uint(ub);

  for (int i = 0; i < n; ++i) {
    if (kShared && (i & (kRereadRows - 1)) == 0) {
      ub = fminf(ub, __uint_as_float(__shfl_sync(kFull, seen, 0)));
      if (t == 0) {
        seen = (unsigned)(*(const volatile unsigned long long*)inc >> 32);
      }
    }
    const float q_i = __shfl_sync(kFull, q_cur, i & 31);
    if ((i & 31) == 31) {
      q_cur = q_nxt;
      q_nxt = i + 33 + t < n ? __ldg(qrow + i + 33 + t) : 0.f;
    }
    // lo(i) = clip(i - w, 0, m - bw) moved right by one since row i - 1.
    const bool shift = i - window >= 1 && i - window <= m - bw;
    float edge = 0.f;
    if (shift) {
      edge = __shfl_sync(kFull, e_cur, edges & 31);
      if ((edges & 31) == 31) {
        e_cur = win.norm(e_nxt);
        e_nxt = win.raw(e0 + edges + 33 + t);
      }
      ++edges;
    }
    float thr = ub;
    if (cb != nullptr && i + window + 1 <= m - 1) {
      thr = __fsub_rn(ub, cb[i + window + 1]);
    }
    if (!dp_row<CPT>(i, shift, q_i, edge, thr, n, m, window, bw, t, st)) {
      return INFINITY;
    }
  }
  if (!st.ok_last) return INFINITY;
  const int lo_fin = min(max(n - 1 - window, 0), m - bw);
  const int slot = (m - 1) - lo_fin;  // in the band: ok_last saw column m - 1
  float v = st.prev[0];
#pragma unroll
  for (int k = 1; k < CPT; ++k) {
    if (slot % CPT == k) v = st.prev[k];
  }
  return __shfl_sync(kFull, v, slot / CPT);
}

}  // namespace dtw_band
