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
//  * The rows are the shared DP program of dtw_band.cuh (dtw_lane / dp_row),
//    which kernels C, D and E run too.
//
// Bound: operations, and of those mostly barriers. A row is ~9 flops per
// band column (cost, d, two scan steps, the compare), with five block-wide
// barriers per row: at the main path's bw = 224, 7 warps, the barriers and
// the serial row dependence, not the arithmetic, set the pace. What the
// design does about it: many lanes in flight per SM (a block is 224 threads
// and ~9 KB of shared memory, so ~9 blocks share an SM) and early exit of
// each lane on its own. Bytes are small: m floats of reference per lane.
//
// Rounding: see dtw_band.cuh. The divide in the normalization is IEEE (no
// --use_fast_math), as on the CPU.
#include "dtw_band.cuh"

namespace {

using namespace dtw_band;

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
  const Scratch s{fbuf, ibuf, &total};

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
  __syncthreads();
  if (use_cb) {
    cb_suffix(win, upper + (size_t)q * m, lower + (size_t)q * m, cb, m, s);
  }
  const float d = dtw_lane(queries + (size_t)q * n, win, use_cb ? cb : nullptr,
                           band, ubv, n, m, window, bw, s);
  if (tid == 0) out[lane_id] = d;
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
