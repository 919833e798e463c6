// Slab-round EAPrunedDTW kernel (kernel D): one round of Q x K lanes over
// pre-gathered, z-normalized windows.
//
// Replaces the TPU kernel repro/kernels/dtw_band.py::_dtw_ea_kernel
// (wrappers repro/kernels/ops.py::dtw_ea_multi and dtw_ea), the
// gather="slab" arm: the caller materializes the (Q, K, m) window slab and,
// when cb is on, the (Q, K, m) cb slab, and each lane runs banded
// EAPrunedDTW against its own ub. Output: the distance, or +inf where the
// lane abandoned; a negative ub is the dead-lane sentinel (+inf, no row
// run). With n != m the band is the full row (bw = m), as in repro.
//
// Design: kernel A's (dtw_ea_fused.cu), with the window and the cb suffix
// copied from the slabs into shared memory instead of built in the block.
// One thread block per lane, one thread per band column, the rows of the
// shared DP program (dtw_band.cuh). On the same lanes, with cb off, it gives
// kernel A's bits: A's in-block normalization and the slab's
// (x - mu) / clamp_sigma(sigma) are the same IEEE operations.
//
// Bound: operations, as kernel A (barrier-bound rows); bytes are the
// lane's m (or 2m with cb) floats of slab.
#include "dtw_band.cuh"

namespace {

using namespace dtw_band;

__global__ void dtw_ea_slab_kernel(
    const float* __restrict__ queries,  // (Q, n) z-normalized queries
    const float* __restrict__ windows,  // (Q * K, m) normalized windows
    const float* __restrict__ cbs,      // (Q * K, m) cb suffixes, or null
    const float* __restrict__ ub,       // (Q * K,) upper bound per lane
    float* __restrict__ out,            // (Q * K,)
    int K, int n, int m, int window, int bw) {
  extern __shared__ float smem[];
  const bool use_cb = cbs != nullptr;
  float* win = smem;                       // m: normalized window
  float* cb = win + m;                     // m when use_cb
  float* band = cb + (use_cb ? m : 0);     // blockDim.x: previous row
  __shared__ float fbuf[32];
  __shared__ int ibuf[32];
  __shared__ float total;
  const Scratch s{fbuf, ibuf, &total};

  const long long lane_id = blockIdx.x;
  const int q = (int)(lane_id / K);
  const float ubv = ub[lane_id];
  if (ubv < 0.f) {  // dead-lane sentinel: the lane would die on row 0
    if (threadIdx.x == 0) out[lane_id] = INFINITY;
    return;
  }
  const float* x = windows + lane_id * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) win[j] = x[j];
  if (use_cb) {
    const float* c = cbs + lane_id * m;
    for (int j = threadIdx.x; j < m; j += blockDim.x) cb[j] = c[j];
  }
  __syncthreads();
  const float d = dtw_lane(queries + (size_t)q * n, win, use_cb ? cb : nullptr,
                           band, ubv, n, m, window, bw, s);
  if (threadIdx.x == 0) out[lane_id] = d;
}

}  // namespace

extern "C" int dtw_ea_slab_launch(
    const float* queries, const float* windows, const float* cbs,
    const float* ub, float* out, int n_queries, int K, int n, int m,
    int window, int bw, void* stream) {
  const int threads = ((bw + 31) / 32) * 32;
  const size_t smem =
      ((size_t)m * (cbs != nullptr ? 2 : 1) + threads) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_ea_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lanes = (long long)n_queries * K;
  dtw_ea_slab_kernel<<<(unsigned)lanes, threads, smem, (cudaStream_t)stream>>>(
      queries, windows, cbs, ub, out, K, n, m, window, bw);
  return (int)cudaGetLastError();
}

extern "C" const char* dtw_ea_slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
