// Fused-round EAPrunedDTW kernel: one best-first round of Q x K lanes.
//
// Replaces the TPU kernel repro/kernels/dtw_band.py::_dtw_ea_fused_kernel
// (wrapper repro/kernels/ops.py::dtw_ea_multi_fused; helpers
// _gather_norm_block, _dp_row, _round_sweep). Each lane slices its window
// ref[start : start + m] out of the resident reference, z-normalizes it as
// (x - mu) / sg (sg arrives clamped), builds the UCR cb suffix from its
// query's envelope when use_cb, and runs banded EAPrunedDTW against its own
// ub. Output: the distance, or +inf where the lane abandoned. A lane whose
// start lies outside [0, N - m] reads nothing and writes NaN: the range is
// checked here, per lane, so that the wrapper needs no host sync to check it.
//
// Design, redesigned for the GPU rather than carried over block by block:
//  * One thread block per lane. Lanes abandon independently, so a dead lane
//    frees its SM at once instead of at the pace of a block of lanes. The
//    TPU kernel's (Q, cand_blocks, row_blocks) grid, its DP carry in VMEM
//    across row steps, its per-block done flag and its VMEM/HBM tier split
//    have no reason to exist here: the row loop runs inside the block.
//  * One thread per band column; the band is padded to whole warps. Shared
//    memory holds the normalized window (m floats, 4 KB at m = 1024), the cb
//    suffix (m floats, when use_cb) and the previous row's band.
//  * Each row: the window-following offset lo(i) = clip(i - w, 0, m - bw)
//    with its 0/1 shift; d = c + min(top, left); the closed-form row
//    curr = P + prefix_min(d - P) by block scans (warp shuffles, then one
//    pass across warps); the threshold ub - cb[i + w + 1]; any(curr <= thr)
//    by __syncthreads_or; next_start by a block min-reduction.
//
// Bound: operations, and of those mostly barriers. A row is ~9 flops per
// band column (cost, d, two scan steps, the compare), with five block-wide
// barriers per row: at the main path's bw = 224, 7 warps, the barriers and
// the serial row dependence, not the arithmetic, set the pace. What the
// design does about it: many lanes in flight per SM (a block is 224 threads
// and ~9 KB of shared memory, so ~9 blocks share an SM) and early exit of
// each lane on its own. Bytes are small: m floats of reference per lane.
//
// Band edges follow repro/kernels/dtw_band.py:222-262: the top fill is BIG
// past the previous band's right edge after a shift, and the virtual corner
// left of column 0 is 0 on row 0 and BIG on later rows. The finish index is
// that of _round_sweep (:362-364). The cb tail is zero once i + w + 1 > m - 1
// (:264-268). BIG = 1e30 stays the finite sentinel: +inf in the scan would
// give inf - inf = NaN.
//
// Rounding: the block scans add in tree order and nvcc contracts a*b + c
// into FMAs by default, so a distance can differ from the CPU's sequential
// scan by O(1) ulp per row; that is inside the stated tolerance. The divide
// in the normalization is IEEE (no --use_fast_math), as on the CPU.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

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
__device__ float block_scan_sum(float x, float* buf) {
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
__device__ float block_scan_min(float x, float* buf) {
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
__device__ int block_min_int(int x, int* buf) {
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

__global__ void dtw_ea_fused_kernel(
    const float* __restrict__ queries,  // (Q, n) z-normalized queries
    const float* __restrict__ ref,      // (N,) sanitized reference
    const int* __restrict__ starts,     // (Q * K,) window start per lane
    const float* __restrict__ mu,       // (Q * K,) window mean per lane
    const float* __restrict__ sg,       // (Q * K,) clamped window std
    const float* __restrict__ ub,       // (Q * K,) upper bound per lane
    const float* __restrict__ upper,    // (Q, m) envelope (read iff use_cb)
    const float* __restrict__ lower,    // (Q, m)
    float* __restrict__ out,            // (Q * K,)
    int n_ref, int K, int n, int m, int window, int bw, int use_cb) {
  extern __shared__ float smem[];
  float* win = smem;                       // m: normalized window
  float* cb = win + m;                     // m when use_cb
  float* band = cb + (use_cb ? m : 0);     // blockDim.x: previous row
  __shared__ float fbuf[32];
  __shared__ int ibuf[32];
  __shared__ float total;

  const int lane_id = blockIdx.x;
  const int q = lane_id / K;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int start = starts[lane_id];
  if (start < 0 || start > n_ref - m) {  // out of range: flagged, not read
    if (tid == 0) out[lane_id] = NAN;
    return;
  }
  const float ubv = ub[lane_id];
  if (ubv < 0.f) {  // dead-lane sentinel: the lane would die on row 0
    if (tid == 0) out[lane_id] = INFINITY;
    return;
  }

  const float* x = ref + start;
  const float muv = mu[lane_id], sgv = sg[lane_id];
  for (int j = tid; j < m; j += nt) win[j] = (x[j] - muv) / sgv;
  for (int r = tid; r < nt; r += nt) band[r] = kBig;
  __syncthreads();

  if (use_cb) {
    // cb[j] = sum_{i >= j} LB_Keogh term i, by chunks of nt from the right;
    // thread t takes element ch * nt + (nt - 1 - t), so a prefix scan over
    // threads is a suffix sum over the chunk.
    const float* uq = upper + (size_t)q * m;
    const float* lq = lower + (size_t)q * m;
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
      const float s = block_scan_sum(term, fbuf);
      if (j < m) cb[j] = s + carry;
      if (tid == nt - 1) total = s;
      __syncthreads();
      carry += total;
      __syncthreads();
    }
  }

  const float* qrow = queries + (size_t)q * n;
  const int lo_max = m - bw;
  const int r = tid;
  const bool in_band = r < bw;
  int ns = 0;
  int ok_last = 0;
  for (int i = 0; i < n; ++i) {
    const int lo = min(max(i - window, 0), lo_max);
    const int lo_prev = min(max(i - 1 - window, 0), lo_max);
    const int shift = lo - lo_prev;  // the window edge advances by 0 or 1
    const int col = lo + r;
    const int hi = min(m - 1, i + window);
    const bool exists = in_band && col >= ns && col >= i - window && col <= hi;

    float c = 0.f, d = kBig;
    if (in_band) {
      const float diff = qrow[i] - win[col];
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
    const float p = block_scan_sum(c, fbuf);
    const float pm = block_scan_min(d - p, fbuf);
    float curr = fminf(p + pm, kBig);
    if (!exists) curr = kBig;

    float thr = ubv;
    if (use_cb && i + window + 1 <= m - 1) thr = ubv - cb[i + window + 1];
    const bool le = exists && curr <= thr;
    if (!__syncthreads_or(le)) {  // border collision: the lane abandons
      if (tid == 0) out[lane_id] = INFINITY;
      return;
    }
    // Every read of band for this row happened before the scans' barriers.
    if (in_band) band[r] = curr;
    ns = block_min_int(le ? col : m, ibuf);
    if (i == n - 1) ok_last = __syncthreads_or(le && col == m - 1);
  }
  if (tid == 0) {
    const int lo_fin = min(max(n - 1 - window, 0), lo_max);
    out[lane_id] = ok_last ? band[(m - 1) - lo_fin] : INFINITY;
  }
}

}  // namespace

extern "C" int dtw_ea_fused_launch(
    const float* queries, const float* ref, const int* starts, const float* mu,
    const float* sg, const float* ub, const float* upper, const float* lower,
    float* out, int n_ref, int n_queries, int K, int n, int m, int window,
    int bw, int use_cb, void* stream) {
  const int threads = ((bw + 31) / 32) * 32;
  const size_t smem = ((size_t)m * (use_cb ? 2 : 1) + threads) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_ea_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lanes = (long long)n_queries * K;
  dtw_ea_fused_kernel<<<(unsigned)lanes, threads, smem, (cudaStream_t)stream>>>(
      queries, ref, starts, mu, sg, ub, upper, lower, out, n_ref, K, n, m,
      window, bw, use_cb);
  return (int)cudaGetLastError();
}

extern "C" const char* dtw_ea_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
