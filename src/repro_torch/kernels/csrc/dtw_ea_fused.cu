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
// it. A negative ub is the dead-lane sentinel: +inf, no row run.
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
#include "dtw_band.cuh"

namespace {

using namespace dtw_band;

constexpr int kWarps = 4;  // lanes a thread block, at most

template <int CPT>
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
    long long lanes, int n_ref, int K, int n, int m, int window, int bw,
    int use_cb) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long lane_id = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (lane_id >= lanes) return;
  const int q = (int)(lane_id / K);
  const int start = starts[lane_id];
  if (start < 0 || start > n_ref - m) {  // out of range: flagged, not read
    if (t == 0) out[lane_id] = NAN;
    return;
  }
  const float ubv = ub[lane_id];
  if (ubv < 0.f) {  // dead-lane sentinel: the lane would die on row 0
    if (t == 0) out[lane_id] = INFINITY;
    return;
  }
  const RefWindow win{ref + start, mu[lane_id], sg[lane_id], m};
  float* cb = nullptr;
  if (use_cb) {
    cb = smem + (size_t)wib * m;
    cb_suffix(win, upper + (size_t)q * m, lower + (size_t)q * m, cb, m, t);
  }
  const float d = dtw_lane<CPT, false>(queries + (size_t)q * n, win, cb, ubv,
                                       nullptr, n, m, window, bw);
  if (t == 0) out[lane_id] = d;
}

template <int CPT>
int launch(const float* queries, const float* ref, const int* starts,
           const float* mu, const float* sg, const float* ub,
           const float* upper, const float* lower, float* out, int n_ref,
           long long lanes, int K, int n, int m, int window, int bw,
           int use_cb, cudaStream_t stream) {
  const int warps = block_warps(kWarps, m, use_cb);
  const size_t smem = use_cb ? (size_t)warps * m * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_ea_fused_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (lanes + warps - 1) / warps;
  dtw_ea_fused_kernel<CPT><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      queries, ref, starts, mu, sg, ub, upper, lower, out, lanes, n_ref, K, n,
      m, window, bw, use_cb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dtw_ea_fused_launch(
    const float* queries, const float* ref, const int* starts, const float* mu,
    const float* sg, const float* ub, const float* upper, const float* lower,
    float* out, int n_ref, int n_queries, int K, int n, int m, int window,
    int bw, int use_cb, int cpt, void* stream) {
  if (bw < 1 || bw > 32 * cpt) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)n_queries * K;
  const cudaStream_t s = (cudaStream_t)stream;
#define DTW_A(C)                                                             \
  case C:                                                                    \
    return launch<C>(queries, ref, starts, mu, sg, ub, upper, lower, out,    \
                     n_ref, lanes, K, n, m, window, bw, use_cb, s);
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
