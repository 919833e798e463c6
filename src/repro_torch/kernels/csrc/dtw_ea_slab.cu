// Slab-round EAPrunedDTW kernel (kernel D): one round of Q x K lanes over
// pre-gathered, z-normalized windows.
//
// Replaces the TPU kernel repro/kernels/dtw_band.py::_dtw_ea_kernel
// (wrappers repro/kernels/ops.py::dtw_ea_multi and dtw_ea), the
// gather="slab" arm: the caller materializes the (Q, K, m) window slab and,
// when cb is on, the (Q, K, m) cb slab, and each lane runs banded
// EAPrunedDTW against its own ub. Output: the distance, or +inf where the
// lane abandoned; a negative ub is the dead-lane sentinel (+inf, no row
// run). With n != m the band is the full row (bw = m <= 1024), as in repro.
// With counters (rows != nullptr, the TPU kernel's emit_info), lane 0 of
// each warp also writes the lane's EAInfo rows and cells, as kernel A does.
//
// Design: kernel A's (dtw_ea_fused.cu): one warp per lane, a few lanes a
// thread block, the rows of the shared DP program (dtw_band.cuh), with the
// window read from the lane's slab row (SlabWindow) instead of sliced and
// normalized from the reference, and the cb row copied into the warp's
// shared-memory slice. On the same lanes, with cb off, it gives kernel A's
// bits: A's normalization and the slab's (x - mu) / clamp_sigma(sigma) are
// the same IEEE operations, and the row is the same code.
//
// Bound: operations, as kernel A (the row's instruction stream); bytes are
// the lane's m (or 2m with cb) floats of slab.
#include "dtw_band.cuh"

namespace {

using namespace dtw_band;

constexpr int kWarps = 4;  // lanes a thread block, at most

template <int CPT, bool kInfo>
__global__ void __launch_bounds__(kWarps * 32) dtw_ea_slab_kernel(
    const float* __restrict__ queries,  // (Q, n) z-normalized queries
    const float* __restrict__ windows,  // (Q * K, m) normalized windows
    const float* __restrict__ cbs,      // (Q * K, m) cb suffixes, or null
    const float* __restrict__ ub,       // (Q * K,) upper bound per lane
    float* __restrict__ out,            // (Q * K,)
    int* __restrict__ rows,             // (Q * K,) iff kInfo
    int* __restrict__ cells,            // (Q * K,) iff kInfo
    long long lanes, int K, int n, int m, int window, int bw) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long lane_id = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (lane_id >= lanes) return;
  const int q = (int)(lane_id / K);
  const float ubv = ub[lane_id];
  if (ubv < 0.f) {  // dead-lane sentinel: the lane would die on row 0
    if (t == 0) {
      out[lane_id] = INFINITY;
      if constexpr (kInfo) write_counts(rows, cells, lane_id,
                                        dead_lane_counts(m, window));
    }
    return;
  }
  const SlabWindow win{windows + lane_id * m, m};
  float* cb = nullptr;
  if (cbs != nullptr) {
    cb = smem + (size_t)wib * m;
    cb_copy(cbs + lane_id * m, cb, m, t);
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
int launch(const float* queries, const float* windows, const float* cbs,
           const float* ub, float* out, int* rows, int* cells,
           long long lanes, int K, int n, int m, int window, int bw,
           cudaStream_t stream) {
  const auto kernel = rows != nullptr ? dtw_ea_slab_kernel<CPT, true>
                                      : dtw_ea_slab_kernel<CPT, false>;
  const int use_cb = cbs != nullptr;
  const int warps = block_warps(kWarps, m, use_cb);
  const size_t smem = use_cb ? (size_t)warps * m * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (lanes + warps - 1) / warps;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      queries, windows, cbs, ub, out, rows, cells, lanes, K, n, m, window,
      bw);
  return (int)cudaGetLastError();
}

}  // namespace

// rows and cells: (Q * K,) int32 counters, or both null for the
// counter-free kernel.
extern "C" int dtw_ea_slab_launch(
    const float* queries, const float* windows, const float* cbs,
    const float* ub, float* out, int* rows, int* cells, int n_queries, int K,
    int n, int m, int window, int bw, int cpt, void* stream) {
  if (bw < 1 || bw > 32 * cpt) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)n_queries * K;
  const cudaStream_t s = (cudaStream_t)stream;
#define DTW_D(C)                                                             \
  case C:                                                                    \
    return launch<C>(queries, windows, cbs, ub, out, rows, cells, lanes, K, \
                     n, m, window, bw, s);
  switch (cpt) {
    DTW_CPT_CASES(DTW_D)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DTW_D
}

extern "C" const char* dtw_ea_slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
