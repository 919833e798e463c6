// Fused-round EAPrunedDTW kernel (kernel A): one best-first round of Q x K
// lanes.
//
// Replaces the TPU kernel repro/kernels/dtw_band.py::_dtw_ea_fused_kernel
// (wrapper repro/kernels/ops.py::dtw_ea_multi_fused; helpers
// _gather_norm_block, _dp_row, _round_sweep). Each lane slices its window
// ref[start : start + m] out of the resident reference, z-normalizes it as
// (x - mu) / sg (sg arrives clamped), builds the UCR cb suffix from its
// query's envelope when use_cb, and runs banded EAPrunedDTW against its own
// ub. Output: the distance, or +inf where the lane abandoned. A lane whose
// start lies outside [0, N - m] reads nothing and writes NaN: the range is
// checked here, per lane, so that the wrapper needs no host sync to check
// it. A negative ub is the dead-lane sentinel: +inf, no row run. With
// counters (rows != nullptr, the TPU kernel's emit_info), lane 0 of each
// warp also writes the lane's EAInfo rows and cells (dtw_band.cuh); a dead
// or out-of-range lane counts row 0, as the plain version does.
//
// Design: one warp per lane, kWarps lanes a thread block, the rows of the
// shared DP program (dtw_band.cuh: the band in registers, CPT columns a
// thread). Lanes abandon independently: a warp that abandons retires at
// once, a warp never waits on another, and a block's registers free when
// its few lanes are done (the earlier design held a 224-thread block per
// lane). The
// TPU kernel's (Q, cand_blocks, row_blocks) grid, its DP carry in VMEM
// across row steps, its per-block done flag and its VMEM/HBM tier split
// have no reason to exist here: the row loop runs inside the warp. Shared
// memory holds only each warp's cb suffix (m floats, when use_cb); the
// window is read from the reference a chunk of 32 columns ahead.
//
// Bound: operations, issued rather than computed. The earlier design of
// this kernel ran one thread block per lane, one thread per band column,
// with nine block-wide barriers a row (three in each block scan, two in
// the block min, one __syncthreads_or, one more on the last row; its note
// said five), so at bw = 224 seven warps waited on each other nine times a
// row. Here a row has no barrier: costs and d in registers, a Sklansky
// scan (three levels in registers and five shuffles at CPT = 8), a prefix
// min (a sequential scan and a 5-step warp scan), two votes and a warp
// min-reduction. The DP itself is ~9 flops a cell; what sets the pace is
// the warp's instruction stream, in which the row's bookkeeping (window
// shift, existence and threshold masks, shuffles) outweighs the
// arithmetic. Many lanes (warps) in flight per SM hide each row's latency.
// Bytes are small: m floats of reference per lane.
//
// Rounding: see dtw_band.cuh. The divide in the normalization is IEEE (no
// --use_fast_math), as on the CPU.
//
// Bands wider than 1024 columns (warps > 1 from kernels/ops.py::band_layout)
// run dtw_band_wide.cuh's row instead: a thread block of 8 warps a lane,
// the previous row in shared memory, a grid of as many blocks as stay
// resident walking the lanes in turn. Each block first normalizes its
// lane's window into shared memory beside the row (kStaged, where that
// keeps the blocks its registers allow: kernels/ops.py::BandLayout.
// window_staged), else into its slice of a device scratch, and, when
// use_cb, builds the cb suffix into the scratch (the wrapper's: m floats a
// block for each of the two it holds).
#include "dtw_band.cuh"
#include "dtw_band_wide.cuh"

namespace {

using namespace dtw_band;

constexpr int kWarps = 4;  // lanes a thread block, at most

template <int CPT, bool kInfo>
__global__ void __launch_bounds__(kWarps * 32) dtw_ea_fused_kernel(
    const float* __restrict__ queries,  // (Q, n) z-normalized queries
    const float* __restrict__ ref,      // (N,) sanitized reference
    const int* __restrict__ starts,     // (Q * K,) window start per lane
    const float* __restrict__ mu,       // (Q * K,) window mean per lane
    const float* __restrict__ sg,       // (Q * K,) clamped window std
    const float* __restrict__ ub,       // (Q * K,) upper bound per lane
    const float* __restrict__ upper,    // (Q, m) envelope (read iff use_cb)
    const float* __restrict__ lower,    // (Q, m)
    float* __restrict__ out,            // (Q * K,)
    int* __restrict__ rows,             // (Q * K,) iff kInfo
    int* __restrict__ cells,            // (Q * K,) iff kInfo
    long long lanes, int n_ref, int K, int n, int m, int window, int bw,
    int use_cb) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long lane_id = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (lane_id >= lanes) return;
  const int q = (int)(lane_id / K);
  const int start = starts[lane_id];
  if (start < 0 || start > n_ref - m) {  // out of range: flagged, not read
    if (t == 0) {
      out[lane_id] = NAN;
      if constexpr (kInfo) write_counts(rows, cells, lane_id,
                                        dead_lane_counts(m, window));
    }
    return;
  }
  const float ubv = ub[lane_id];
  if (ubv < 0.f) {  // dead-lane sentinel: the lane would die on row 0
    if (t == 0) {
      out[lane_id] = INFINITY;
      if constexpr (kInfo) write_counts(rows, cells, lane_id,
                                        dead_lane_counts(m, window));
    }
    return;
  }
  const RefWindow win{ref + start, mu[lane_id], sg[lane_id], m};
  float* cb = nullptr;
  if (use_cb) {
    cb = smem + (size_t)wib * m;
    cb_suffix(win, upper + (size_t)q * m, lower + (size_t)q * m, cb, m, t);
  }
  Counts c;
  const float d = dtw_lane<CPT, false, kInfo>(
      queries + (size_t)q * n, win, cb, ubv, nullptr, n, m, window, bw, &c);
  if (t == 0) {
    out[lane_id] = d;
    if constexpr (kInfo) write_counts(rows, cells, lane_id, c);
  }
}

template <int CPT>
int launch(const float* queries, const float* ref, const int* starts,
           const float* mu, const float* sg, const float* ub,
           const float* upper, const float* lower, float* out, int* rows,
           int* cells, int n_ref, long long lanes, int K, int n, int m,
           int window, int bw, int use_cb, cudaStream_t stream) {
  const auto kernel = rows != nullptr ? dtw_ea_fused_kernel<CPT, true>
                                      : dtw_ea_fused_kernel<CPT, false>;
  const int warps = block_warps(kWarps, m, use_cb);
  const size_t smem = use_cb ? (size_t)warps * m * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (lanes + warps - 1) / warps;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      queries, ref, starts, mu, sg, ub, upper, lower, out, rows, cells, lanes,
      n_ref, K, n, m, window, bw, use_cb);
  return (int)cudaGetLastError();
}

template <bool kInfo, bool kStaged>
__global__ void __launch_bounds__(kWideThreads) dtw_ea_fused_wide_kernel(
    const float* __restrict__ queries, const float* __restrict__ ref,
    const int* __restrict__ starts, const float* __restrict__ mu,
    const float* __restrict__ sg, const float* __restrict__ ub,
    const float* __restrict__ upper, const float* __restrict__ lower,
    float* __restrict__ out, int* __restrict__ rows, int* __restrict__ cells,
    float* scratch,  // (gridDim.x, per block): window (!kStaged), cb suffix
    long long lanes, int n_ref, int K, int n, int m, int window, int bw,
    int use_cb) {
  extern __shared__ float smem[];
  __shared__ WideShared sh;
  const size_t per_block = (size_t)((kStaged ? 0 : m) + (use_cb ? m : 0));
  float* own = scratch + (size_t)blockIdx.x * per_block;
  float* xs = kStaged ? smem + wide_row_words(bw) : own;
  float* cbs = use_cb ? own + (kStaged ? 0 : m) : nullptr;
  for (long long lane = blockIdx.x; lane < lanes; lane += gridDim.x) {
    const int q = (int)(lane / K);
    const int start = starts[lane];
    const float ubv = ub[lane];
    const bool bad = start < 0 || start > n_ref - m;
    if (bad || ubv < 0.f) {  // out of range (NaN) or a dead lane (+inf)
      if (threadIdx.x == 0) {
        out[lane] = bad ? NAN : INFINITY;
        if constexpr (kInfo) write_counts(rows, cells, lane,
                                          dead_lane_counts(m, window));
      }
      continue;
    }
    __syncthreads();  // the previous lane has read the window and scratch
    const RefWindow win{ref + start, mu[lane], sg[lane], m};
    wide_stage<kStaged>(win, xs, upper + (size_t)q * m, lower + (size_t)q * m,
                        cbs, m);
    Counts c;
    const float d = wide_lane<false, kInfo>(
        queries + (size_t)q * n, WideWindow<kStaged>{xs}, cbs, ubv, nullptr,
        n, m, window, bw, smem, sh, &c);
    if (threadIdx.x == 0) {
      out[lane] = d;
      if constexpr (kInfo) write_counts(rows, cells, lane, c);
    }
  }
}

template <bool kInfo, bool kStaged>
int wide_launch(const float* queries, const float* ref, const int* starts,
                const float* mu, const float* sg, const float* ub,
                const float* upper, const float* lower, float* out, int* rows,
                int* cells, float* scratch, long long blocks, int n_ref,
                long long lanes, int K, int n, int m, int window, int bw,
                int use_cb, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(bw, m, kStaged);
  const auto kernel = dtw_ea_fused_wide_kernel<kInfo, kStaged>;
  cudaError_t err = wide_smem_limit(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kWideThreads, smem, stream>>>(
      queries, ref, starts, mu, sg, ub, upper, lower, out, rows, cells,
      scratch, lanes, n_ref, K, n, m, window, bw, use_cb);
  return (int)cudaGetLastError();
}

template <bool kInfo, bool kStaged>
cudaError_t wide_blocks(int bw, int m, int* per_sm) {
  return wide_blocks_per_sm(dtw_ea_fused_wide_kernel<kInfo, kStaged>,
                            bw > 0 ? wide_smem_bytes(bw, m, kStaged) : 0,
                            per_sm);
}

}  // namespace

// The wide kernel's thread blocks resident on one SM (counters `info`,
// the window `staged`) with the dynamic shared memory of a band of bw
// columns and windows of m, or with none where bw == 0 (the blocks its
// registers allow).
extern "C" int dtw_ea_fused_wide_blocks(int info, int staged, int bw, int m,
                                        int* per_sm) {
  const auto query = info ? (staged ? wide_blocks<true, true>
                                    : wide_blocks<true, false>)
                          : (staged ? wide_blocks<false, true>
                                    : wide_blocks<false, false>);
  return (int)query(bw, m, per_sm);
}

// rows and cells: (Q * K,) int32 counters, or both null for the
// counter-free kernel. warps == 1: the one-warp row with `cpt` columns a
// thread; warps == 8 (cpt == 8): the wide row, its grid `blocks` thread
// blocks, the window in shared memory where `staged`, and `scratch` m
// floats for each block when use_cb and m more when not staged.
extern "C" int dtw_ea_fused_launch(
    const float* queries, const float* ref, const int* starts, const float* mu,
    const float* sg, const float* ub, const float* upper, const float* lower,
    float* out, int* rows, int* cells, float* scratch, long long blocks,
    int n_ref, int n_queries, int K, int n, int m, int window, int bw,
    int use_cb, int warps, int cpt, int staged, void* stream) {
  const long long lanes = (long long)n_queries * K;
  const cudaStream_t s = (cudaStream_t)stream;
  if (warps != 1) {
    if (warps != kWideWarps || cpt != kWideCpt || bw < 1 || bw > m ||
        blocks < 1 || (scratch == nullptr && (use_cb || !staged))) {
      return (int)cudaErrorInvalidValue;
    }
    const auto launch_wide = rows != nullptr
                                 ? (staged ? wide_launch<true, true>
                                           : wide_launch<true, false>)
                                 : (staged ? wide_launch<false, true>
                                           : wide_launch<false, false>);
    return launch_wide(queries, ref, starts, mu, sg, ub, upper, lower, out,
                       rows, cells, scratch, blocks, n_ref, lanes, K, n, m,
                       window, bw, use_cb, s);
  }
  if (bw < 1 || bw > 32 * cpt) return (int)cudaErrorInvalidValue;
#define DTW_A(C)                                                             \
  case C:                                                                    \
    return launch<C>(queries, ref, starts, mu, sg, ub, upper, lower, out,    \
                     rows, cells, n_ref, lanes, K, n, m, window, bw, use_cb, \
                     s);
  switch (cpt) {
    DTW_CPT_CASES(DTW_A)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DTW_A
}

extern "C" const char* dtw_ea_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* dtw_ea_fused_wide_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
