// The banded EAPrunedDTW program shared by the port's DTW kernels.
//
// One copy of the DP on the card, as repro/kernels/dtw_band.py::_dp_row is
// the one copy in the JAX package: kernel A (dtw_ea_fused.cu), kernel D
// (dtw_ea_slab.cu) and kernels C and E (dtw_ea_persistent.cu) include this
// header and differ only in where a lane's window comes from and who
// carries its upper bound.
//
// Layout: one thread block runs one lane at a time, one thread per band
// column (the band padded to whole warps). The caller stages the lane's
// z-normalized window (m floats) and, when use_cb, its cb suffix (m floats)
// in shared memory, and gives a band buffer of blockDim.x floats.
//
// Each row (dp_row): the window-following offset lo(i) = clip(i - w, 0,
// m - bw) with its 0/1 shift; the cost c = (q_i - x_col)^2;
// d = c + min(top, left); the closed-form row curr = P + prefix_min(d - P)
// by two block scans (warp shuffles, then one pass across warps); the
// threshold ub - cb[i + w + 1]; the abandon test any(curr <= thr) by
// __syncthreads_or; next_start by a block min-reduction. Band edges follow
// repro/kernels/dtw_band.py:222-262: the top fill is BIG past the previous
// band's right edge after a shift, and the virtual corner left of column 0
// is 0 on row 0 and BIG on later rows. The finish index is that of
// _round_sweep (:362-364). The cb tail is zero once i + w + 1 > m - 1
// (:264-268). BIG = 1e30 stays the finite sentinel: +inf in the scan would
// give inf - inf = NaN.
//
// Rounding: the block scans add in tree order and nvcc contracts a*b + c
// into FMAs by default, so a distance can differ from the CPU's sequential
// scan by O(1) ulp per row. The pruning of a lane depends on its ub only
// through next_start and the abandon test; which cells exist never changes
// the prefix sums P, so a lane that finishes gives the same bits under any
// ub it finishes under unless a pruned cell ties the optimum within
// rounding (kernels C and E rest on this; tests/test_torch_persistent.py
// checks it).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace dtw_band {

constexpr float kBig = 1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_scan_sum(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ float warp_scan_min(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = fminf(x, y);
  }
  return x;
}

// Inclusive block-wide prefix sum; every thread of the block must call it.
__device__ __forceinline__ float block_scan_sum(float x, float* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_scan_sum(x, lane);
  if (lane == 31) buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    float v = lane < nw ? buf[lane] : 0.f;
    buf[lane] = warp_scan_sum(v, lane);
  }
  __syncthreads();
  if (wid > 0) x += buf[wid - 1];
  __syncthreads();
  return x;
}

// Inclusive block-wide prefix min; every thread of the block must call it.
__device__ __forceinline__ float block_scan_min(float x, float* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_scan_min(x, lane);
  if (lane == 31) buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    float v = lane < nw ? buf[lane] : INFINITY;
    buf[lane] = warp_scan_min(v, lane);
  }
  __syncthreads();
  if (wid > 0) x = fminf(x, buf[wid - 1]);
  __syncthreads();
  return x;
}

// Block-wide minimum, returned to every thread.
__device__ __forceinline__ int block_min_int(int x, int* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  if (lane == 0) buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int v = lane < nw ? buf[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) buf[0] = v;
  }
  __syncthreads();
  const int r = buf[0];
  __syncthreads();
  return r;
}

// Block-level scratch of the DP: warp totals for the scans and the
// reductions, and one float for the cb prologue's chunk total.
struct Scratch {
  float* fbuf;  // 32 floats
  int* ibuf;    // 32 ints
  float* total;
};

// The UCR cb suffix of the staged window against its query's envelope:
// cb[j] = sum_{i >= j} LB_Keogh term i, by chunks of blockDim.x from the
// right. Thread t takes element ch * nt + (nt - 1 - t), so a prefix scan
// over threads is a suffix sum over the chunk. Every thread must call it;
// `win` must be visible to the whole block.
__device__ __forceinline__ void cb_suffix(const float* win, const float* uq,
                                          const float* lq, float* cb, int m,
                                          Scratch s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float carry = 0.f;
  for (int ch = (m - 1) / nt; ch >= 0; --ch) {
    const int j = ch * nt + (nt - 1 - tid);
    float term = 0.f;
    if (j < m) {
      const float v = win[j];
      const float over = v > uq[j] ? v - uq[j] : 0.f;
      const float under = v < lq[j] ? lq[j] - v : 0.f;
      term = over * over + under * under;
    }
    const float sum = block_scan_sum(term, s.fbuf);
    if (j < m) cb[j] = sum + carry;
    if (tid == nt - 1) *s.total = sum;
    __syncthreads();
    carry += *s.total;
    __syncthreads();
  }
}

// Per-lane state carried from one row to the next.
struct Lane {
  int ns;       // next_start: first column that may start a path
  int ok_last;  // the last row reached column m - 1 under the threshold
};

// One banded DP row i of the lane: reads the previous row from `band`,
// writes this row into it. Returns false, the same on every thread, when
// no cell of the row lies under its threshold: the lane abandons.
__device__ __forceinline__ bool dp_row(int i, float q_i, const float* win,
                                       const float* cb, float* band, float ub,
                                       int n, int m, int window, int bw,
                                       Lane& st, Scratch s) {
  const int r = threadIdx.x;
  const bool in_band = r < bw;
  const int lo_max = m - bw;
  const int lo = min(max(i - window, 0), lo_max);
  const int lo_prev = min(max(i - 1 - window, 0), lo_max);
  const int shift = lo - lo_prev;  // the window edge advances by 0 or 1
  const int col = lo + r;
  const int hi = min(m - 1, i + window);
  const bool exists = in_band && col >= st.ns && col >= i - window && col <= hi;

  float c = 0.f, d = kBig;
  if (in_band) {
    const float diff = q_i - win[col];
    c = diff * diff;
    float top, left;
    if (shift) {
      top = (r + 1 < bw) ? band[r + 1] : kBig;
      left = band[r];
    } else {
      top = band[r];
      left = r > 0 ? band[r - 1] : (i == 0 ? 0.f : kBig);
    }
    if (exists) d = c + fminf(top, left);
  }
  const float p = block_scan_sum(c, s.fbuf);
  const float pm = block_scan_min(d - p, s.fbuf);
  float curr = fminf(p + pm, kBig);
  if (!exists) curr = kBig;

  float thr = ub;
  if (cb != nullptr && i + window + 1 <= m - 1) thr = ub - cb[i + window + 1];
  const bool le = exists && curr <= thr;
  if (!__syncthreads_or(le)) return false;  // border collision: abandon
  // Every read of band for this row happened before the scans' barriers.
  if (in_band) band[r] = curr;
  st.ns = block_min_int(le ? col : m, s.ibuf);
  if (i == n - 1) st.ok_last = __syncthreads_or(le && col == m - 1);
  return true;
}

// One lane's banded EAPrunedDTW against threshold `ub`: its distance, or
// +inf where it abandoned. `qrow` is the query (n samples, global memory),
// `win` and `cb` (nullptr when cb is off) the staged window and suffix.
// Every thread must call it and gets the same value; `band` may be reused
// as soon as it returns.
__device__ __forceinline__ float dtw_lane(const float* qrow, const float* win,
                                          const float* cb, float* band,
                                          float ub, int n, int m, int window,
                                          int bw, Scratch s) {
  for (int r = threadIdx.x; r < blockDim.x; r += blockDim.x) band[r] = kBig;
  __syncthreads();
  Lane st{0, 0};
  for (int i = 0; i < n; ++i) {
    if (!dp_row(i, qrow[i], win, cb, band, ub, n, m, window, bw, st, s)) {
      return INFINITY;
    }
  }
  const int lo_fin = min(max(n - 1 - window, 0), m - bw);
  const float out = st.ok_last ? band[(m - 1) - lo_fin] : INFINITY;
  __syncthreads();
  return out;
}

}  // namespace dtw_band
