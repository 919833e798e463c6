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
//
// Bands wider than 1024 columns (full rows with m > 1024 among them) run
// dtw_band_wide.cuh's row, as kernel A's do: a thread block of 8 warps a
// lane, as many blocks as stay resident walking the lanes in turn, the
// window copied from its slab row into shared memory beside the row where
// kernel A stages its window (kStaged), else read from the slab row, and
// the cb suffix read from its slab row (no scratch).
#include "dtw_band.cuh"
#include "dtw_band_wide.cuh"

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

template <bool kInfo, bool kStaged>
__global__ void __launch_bounds__(kWideThreads) dtw_ea_slab_wide_kernel(
    const float* __restrict__ queries, const float* __restrict__ windows,
    const float* __restrict__ cbs, const float* __restrict__ ub,
    float* __restrict__ out, int* __restrict__ rows, int* __restrict__ cells,
    long long lanes, int K, int n, int m, int window, int bw) {
  extern __shared__ float smem[];
  __shared__ WideShared sh;
  float* xs = smem + wide_row_words(bw);  // kStaged: the lane's window
  for (long long lane = blockIdx.x; lane < lanes; lane += gridDim.x) {
    const int q = (int)(lane / K);
    const float ubv = ub[lane];
    if (ubv < 0.f) {  // dead-lane sentinel: the lane would die on row 0
      if (threadIdx.x == 0) {
        out[lane] = INFINITY;
        if constexpr (kInfo) write_counts(rows, cells, lane,
                                          dead_lane_counts(m, window));
      }
      continue;
    }
    const float* wrow = windows + lane * m;
    if constexpr (kStaged) {
      __syncthreads();  // the previous lane has read the window
      wide_stage<true>(SlabWindow{wrow, m}, xs, nullptr, nullptr, nullptr,
                       m);
    }
    Counts c;
    const float d = wide_lane<false, kInfo>(
        queries + (size_t)q * n, WideWindow<kStaged>{kStaged ? xs : wrow},
        cbs != nullptr ? cbs + lane * m : nullptr, ubv, nullptr, n, m, window,
        bw, smem, sh, &c);
    if (threadIdx.x == 0) {
      out[lane] = d;
      if constexpr (kInfo) write_counts(rows, cells, lane, c);
    }
  }
}

template <bool kInfo, bool kStaged>
int wide_launch(const float* queries, const float* windows, const float* cbs,
                const float* ub, float* out, int* rows, int* cells,
                long long blocks, long long lanes, int K, int n, int m,
                int window, int bw, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(bw, m, kStaged);
  const auto kernel = dtw_ea_slab_wide_kernel<kInfo, kStaged>;
  cudaError_t err = wide_smem_limit(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kWideThreads, smem, stream>>>(
      queries, windows, cbs, ub, out, rows, cells, lanes, K, n, m, window,
      bw);
  return (int)cudaGetLastError();
}

template <bool kInfo, bool kStaged>
cudaError_t wide_blocks(int bw, int m, int* per_sm) {
  return wide_blocks_per_sm(dtw_ea_slab_wide_kernel<kInfo, kStaged>,
                            bw > 0 ? wide_smem_bytes(bw, m, kStaged) : 0,
                            per_sm);
}

}  // namespace

// The wide kernel's thread blocks resident on one SM, as
// dtw_ea_fused_wide_blocks counts them.
extern "C" int dtw_ea_slab_wide_blocks(int info, int staged, int bw, int m,
                                       int* per_sm) {
  const auto query = info ? (staged ? wide_blocks<true, true>
                                    : wide_blocks<true, false>)
                          : (staged ? wide_blocks<false, true>
                                    : wide_blocks<false, false>);
  return (int)query(bw, m, per_sm);
}

// rows and cells: (Q * K,) int32 counters, or both null for the
// counter-free kernel. warps == 1: the one-warp row with `cpt` columns a
// thread; warps == 8 (cpt == 8): the wide row on a grid of `blocks` thread
// blocks (dtw_ea_slab_wide_blocks), the window copied into shared memory
// where `staged`.
extern "C" int dtw_ea_slab_launch(
    const float* queries, const float* windows, const float* cbs,
    const float* ub, float* out, int* rows, int* cells, long long blocks,
    int n_queries, int K, int n, int m, int window, int bw, int warps,
    int cpt, int staged, void* stream) {
  const long long lanes = (long long)n_queries * K;
  const cudaStream_t s = (cudaStream_t)stream;
  if (warps != 1) {
    if (warps != kWideWarps || cpt != kWideCpt || bw < 1 || bw > m ||
        blocks < 1) {
      return (int)cudaErrorInvalidValue;
    }
    const auto launch_wide = rows != nullptr
                                 ? (staged ? wide_launch<true, true>
                                           : wide_launch<true, false>)
                                 : (staged ? wide_launch<false, true>
                                           : wide_launch<false, false>);
    return launch_wide(queries, windows, cbs, ub, out, rows, cells, blocks,
                       lanes, K, n, m, window, bw, s);
  }
  if (bw < 1 || bw > 32 * cpt) return (int)cudaErrorInvalidValue;
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

extern "C" const char* dtw_ea_slab_wide_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* dtw_ea_slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
