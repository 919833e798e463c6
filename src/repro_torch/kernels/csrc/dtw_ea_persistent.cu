// Persistent best-first EAPrunedDTW sweep (kernels C and E): the whole
// search of Q queries over their best-first lane orders in one launch.
//
// Replaces the TPU kernel repro/kernels/dtw_band.py::_dtw_ea_persistent_kernel,
// in both its forms: fused=True (kernel C, wrapper
// repro/kernels/ops.py::dtw_ea_persistent_fused: each lane slices and
// z-normalizes ref[start : start + m] with its (mu, sg)) and fused=False
// (kernel E, wrapper ops.py::dtw_ea_persistent: each lane reads its row of
// a pre-gathered (Q, K, m) window slab). One template, two window loaders.
// With use_cb the warp builds the cb suffix from the query's envelope, in
// both forms. Outputs per query: best_dist, best_start (-1
// while the seed ub_init is unbeaten) and blocks, the work metric.
//
// The TPU design runs each query's candidate blocks as a sequential grid
// axis with the incumbent in SMEM. On the card that would leave Q thread
// blocks for 132 SMs. Instead:
//  * Grid: persistent, and it counts warps: as many thread blocks of a few
//    warps as the occupancy query keeps resident (capped at one warp per
//    lane). Each warp runs one lane at a time with the shared DP row
//    (dtw_band.cuh: one warp per lane, the band in registers), drawing
//    lanes in best-first order from per-query atomic counters and walking
//    the queries round robin, so all Q advance together. The warp's lane 0
//    runs the counter, the gate and the done flag and broadcasts the lane
//    it drew by __shfl_sync; no block barrier sits between lanes, so a warp
//    never waits for the other warps of its block.
//  * Incumbent: one 64-bit word per query in global memory,
//    (float bits of the distance) << 32 | rank. The seed ub_init has rank 0
//    and lane j of the best-first order rank j + 1. Distances are >= 0, so
//    their bits order as unsigned integers and one atomicMin folds a lane.
//  * Gate: lane j runs iff (lb_j, j + 1) is below the incumbent word; +inf
//    bounds never run. Bounds arrive sorted, so the first lane to fail
//    marks its query done: every later lane would fail too.
//  * Re-read: a lane starts against the incumbent's distance as the gate
//    read it, and every kRereadRows rows takes the smaller of the bound it
//    holds and the distance it last read from the word (lane 0 issues a
//    volatile 64-bit load one period ahead and broadcasts it), so a lane
//    that started before a fold abandons by it.
//  * Fold: a lane that finishes does atomicMin(word, (d, j + 1)).
//  * Outputs: best_dist is the word's distance (the seed itself at rank 0),
//    best_start = starts[rank - 1] or -1, blocks = max_j_run / block_k + 1
//    or 0 when no lane ran; the state keeps each query's count of lanes
//    that passed the gate.
//  * Kernel C checks each lane's start: a lane out of [0, N - m] is never
//    read and never runs; a separate pass counts them all per query, so
//    the wrapper can raise.
//
// Why this is repro's winner: the sequential strict fold with first-lane
// ties returns the lexicographic minimum (d*, rank*) of (d, index) over
// all lanes against the seed, which wins ties. The incumbent word only
// falls, and only to a key some lane has already folded, (d, rank) with
// d >= d* and, at d = d*, rank > rank*. So the lane holding (d*, rank*)
// always passes the gate (its key is at most (d*, rank*), which no other
// lane holds), and every bound it ever runs under, at the gate or at a
// re-read, is at least d*: it finishes, and folds. Its distance does not
// depend on the bounds it ran under (dtw_band.cuh), so it folds repro's
// bits. Only the work differs: blocks, and with it the search's lanes and
// lb_pruned, depend on the order in which lanes finish and can change from
// run to run.
//
// Bound: operations, as kernel A (the row's instruction stream), on the lanes
// the sweep runs; bytes are the lanes' m floats of reference (C) or slab
// (E). The earlier design ran one thread block per lane with nine
// block-wide barriers a row and read the incumbent only when a lane
// started; E, which staged its slab row in shared memory, kept fewer
// blocks resident than C. Now C and E differ only in the loader of the
// window's next columns, and registers, not shared memory, set the lanes
// each keeps in flight.
#include <stdint.h>

#include "dtw_band.cuh"

namespace {

using namespace dtw_band;
typedef unsigned long long u64;

// Per-query int32 state: next lane to draw, done flag, largest lane that
// ran, lanes with a start out of range, lanes that passed the gate.
enum { kNext = 0, kDone = 1, kMaxRun = 2, kBad = 3, kRan = 4, kStateInts = 5 };

constexpr int kWarps = 4;  // lanes (warps) a thread block, at most

// Order key of a distance or bound: its float bits, with -0 as +0.
__device__ __forceinline__ unsigned dist_key(float d) {
  return d > 0.f ? __float_as_uint(d) : 0u;
}

__global__ void persistent_init(const float* __restrict__ ub_init, u64* inc,
                                int* state, int nq) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const float seed = ub_init[q];
  inc[q] = (u64)dist_key(seed) << 32;
  int* st = state + q * kStateInts;
  st[kNext] = 0;
  st[kDone] = !(seed >= 0.f);  // a negative seed admits no lane
  st[kMaxRun] = -1;
  st[kBad] = 0;
  st[kRan] = 0;
}

__global__ void count_bad_starts(const int* __restrict__ starts, int* state,
                                 long long lanes, int K, int n_ref, int m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       l < lanes; l += stride) {
    const int s = starts[l];
    if (s < 0 || s > n_ref - m) {
      atomicAdd(&state[(l / K) * kStateInts + kBad], 1);
    }
  }
}

template <int CPT, bool kFused>
__global__ void __launch_bounds__(kWarps * 32) persistent_sweep(
    const float* __restrict__ queries,  // (Q, n) z-normalized queries
    const float* __restrict__ ref,      // C: (N,) sanitized reference
    const float* __restrict__ mu,       // C: (Q * K,) window mean per lane
    const float* __restrict__ sg,       // C: (Q * K,) clamped window std
    const float* __restrict__ windows,  // E: (Q * K, m) normalized windows
    const float* __restrict__ lb,       // (Q * K,) ascending lower bounds
    const int* __restrict__ starts,     // (Q * K,) window start per lane
    const float* __restrict__ upper,    // (Q, m) envelope (read iff use_cb)
    const float* __restrict__ lower,    // (Q, m)
    u64* inc, int* state, int n_ref, int nq, int K, int n, int m,
    int window, int bw, int use_cb) {
  extern __shared__ float smem[];
  const int t = threadIdx.x & 31, wib = threadIdx.x >> 5;
  float* cb = use_cb ? smem + (size_t)wib * m : nullptr;

  const long long warp_id = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  int q = (int)(warp_id % nq);
  int idle = 0;  // queries in a row found done
  while (idle < nq) {
    int j = -1;  // -1: the query is done; -2: skip an unreadable lane
    float ubq = 0.f;
    if (t == 0) {
      volatile int* st = state + q * kStateInts;
      if (!st[kDone]) {
        const int jj = atomicAdd((int*)&st[kNext], 1);
        if (jj >= K) {
          st[kDone] = 1;
        } else {
          const long long l = (long long)q * K + jj;
          const float lbj = lb[l];
          const u64 w = *(volatile u64*)&inc[q];
          const u64 key = ((u64)dist_key(lbj) << 32) | (unsigned)(jj + 1);
          if (!(lbj < INFINITY) || key >= w) {
            st[kDone] = 1;  // sorted bounds: every later lane fails too
          } else if (kFused && (starts[l] < 0 || starts[l] > n_ref - m)) {
            j = -2;  // counted by count_bad_starts, never read
          } else {
            j = jj;
            ubq = __uint_as_float((unsigned)(w >> 32));
            atomicMax((int*)&st[kMaxRun], jj);
            atomicAdd((int*)&st[kRan], 1);
          }
        }
      }
    }
    j = __shfl_sync(kFull, j, 0);
    ubq = __shfl_sync(kFull, ubq, 0);
    const int qq = q;
    q = q + 1 == nq ? 0 : q + 1;
    if (j == -1) {
      ++idle;
      continue;
    }
    idle = 0;
    if (j < 0) continue;

    const long long l = (long long)qq * K + j;
    const float* qrow = queries + (size_t)qq * n;
    const float* uq = upper + (size_t)qq * m;
    const float* lq = lower + (size_t)qq * m;
    float d;
    if (kFused) {
      const RefWindow win{ref + starts[l], mu[l], sg[l], m};
      if (use_cb) cb_suffix(win, uq, lq, cb, m, t);
      d = dtw_lane<CPT, true>(qrow, win, cb, ubq, &inc[qq], n, m, window, bw);
    } else {
      const SlabWindow win{windows + l * m, m};
      if (use_cb) cb_suffix(win, uq, lq, cb, m, t);
      d = dtw_lane<CPT, true>(qrow, win, cb, ubq, &inc[qq], n, m, window, bw);
    }
    if (t == 0 && d < INFINITY) {
      atomicMin(&inc[qq], ((u64)dist_key(d) << 32) | (unsigned)(j + 1));
    }
  }
}

__global__ void persistent_finish(
    const float* __restrict__ ub_init, const int* __restrict__ starts,
    const u64* __restrict__ inc, const int* __restrict__ state,
    float* best_dist, int* best_start, int* blocks, int nq, int K,
    int block_k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const u64 w = inc[q];
  const unsigned rank = (unsigned)w;
  best_dist[q] = rank ? __uint_as_float((unsigned)(w >> 32)) : ub_init[q];
  best_start[q] = rank ? starts[(long long)q * K + rank - 1] : -1;
  const int max_run = state[q * kStateInts + kMaxRun];
  blocks[q] = max_run >= 0 ? max_run / block_k + 1 : 0;
}

// The persistent grid: as many thread blocks of `warps` warps as stay
// resident on the card at once (the occupancy query), with `smem` bytes
// each; its lanes in flight are grid * warps.
template <int CPT, bool kFused>
cudaError_t resident_grid(int m, int use_cb, int* warps, size_t* smem,
                          long long* grid) {
  *warps = block_warps(kWarps, m, use_cb);
  *smem = use_cb ? (size_t)*warps * m * sizeof(float) : 0;
  cudaError_t err;
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(persistent_sweep<CPT, kFused>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, persistent_sweep<CPT, kFused>, *warps * 32, *smem);
  if (err != cudaSuccess) return err;
  *grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

template <int CPT, bool kFused>
int launch(const float* queries, const float* ref, const float* mu,
           const float* sg, const float* windows, const float* lb,
           const int* starts, const float* ub_init, const float* upper,
           const float* lower, float* best_dist, int* best_start, int* blocks,
           u64* inc, int* state, int n_ref, int nq, int K, int n, int m,
           int window, int bw, int use_cb, int block_k, cudaStream_t stream) {
  int warps = 0;
  size_t smem = 0;
  long long grid = 0;
  cudaError_t err = resident_grid<CPT, kFused>(m, use_cb, &warps, &smem,
                                               &grid);
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)nq * K;
  const long long need = (lanes + warps - 1) / warps;  // one warp a lane
  if (grid > need) grid = need;
  if (grid < 1) grid = 1;

  const int qb = (nq + 127) / 128;
  persistent_init<<<qb, 128, 0, stream>>>(ub_init, inc, state, nq);
  if (kFused) {
    const long long cb_blocks = (lanes + 255) / 256;
    count_bad_starts<<<(unsigned)(cb_blocks < 4096 ? cb_blocks : 4096), 256, 0,
                       stream>>>(starts, state, lanes, K, n_ref, m);
  }
  persistent_sweep<CPT, kFused><<<(unsigned)grid, warps * 32, smem, stream>>>(
      queries, ref, mu, sg, windows, lb, starts, upper, lower, inc, state,
      n_ref, nq, K, n, m, window, bw, use_cb);
  persistent_finish<<<qb, 128, 0, stream>>>(ub_init, starts, inc, state,
                                           best_dist, best_start, blocks, nq,
                                           K, block_k);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel C: lanes slice and normalize their windows out of `ref`.
extern "C" int dtw_ea_persistent_fused_launch(
    const float* queries, const float* ref, const float* lb, const int* starts,
    const float* mu, const float* sg, const float* ub_init, const float* upper,
    const float* lower, float* best_dist, int* best_start, int* blocks,
    void* inc, int* state, int n_ref, int nq, int K, int n, int m, int window,
    int bw, int use_cb, int block_k, int cpt, void* stream) {
  if (bw < 1 || bw > 32 * cpt) return (int)cudaErrorInvalidValue;
#define DTW_C(C)                                                             \
  case C:                                                                    \
    return launch<C, true>(queries, ref, mu, sg, nullptr, lb, starts,        \
                           ub_init, upper, lower, best_dist, best_start,     \
                           blocks, (u64*)inc, state, n_ref, nq, K, n, m,     \
                           window, bw, use_cb, block_k, (cudaStream_t)stream);
  switch (cpt) {
    DTW_CPT_CASES(DTW_C)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DTW_C
}

// Kernel E: lanes read their windows from the (Q, K, m) slab.
extern "C" int dtw_ea_persistent_launch(
    const float* queries, const float* windows, const float* lb,
    const int* starts, const float* ub_init, const float* upper,
    const float* lower, float* best_dist, int* best_start, int* blocks,
    void* inc, int* state, int nq, int K, int n, int m, int window, int bw,
    int use_cb, int block_k, int cpt, void* stream) {
  if (bw < 1 || bw > 32 * cpt) return (int)cudaErrorInvalidValue;
#define DTW_E(C)                                                             \
  case C:                                                                    \
    return launch<C, false>(queries, nullptr, nullptr, nullptr, windows, lb, \
                            starts, ub_init, upper, lower, best_dist,        \
                            best_start, blocks, (u64*)inc, state, 0, nq, K,  \
                            n, m, window, bw, use_cb, block_k,               \
                            (cudaStream_t)stream);
  switch (cpt) {
    DTW_CPT_CASES(DTW_E)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DTW_E
}

// The lanes (warps) a launch of kernel C (`fused` != 0) or E keeps in
// flight before it caps them at the lane count.
extern "C" int dtw_ea_persistent_grid(int fused, int m, int use_cb, int cpt,
                                      long long* lanes) {
  int warps = 0;
  size_t smem = 0;
  long long grid = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define DTW_G(C)                                                             \
  case C:                                                                    \
    err = fused ? resident_grid<C, true>(m, use_cb, &warps, &smem, &grid)    \
                : resident_grid<C, false>(m, use_cb, &warps, &smem, &grid);  \
    break;
  switch (cpt) {
    DTW_CPT_CASES(DTW_G)
    default:
      break;
  }
#undef DTW_G
  *lanes = grid * warps;
  return (int)err;
}

extern "C" const char* dtw_ea_persistent_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* dtw_ea_persistent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* dtw_ea_persistent_grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
