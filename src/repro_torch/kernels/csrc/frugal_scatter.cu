// The sparse event kernel for Hopper (sm_90a): a batch of K event slots,
// grouped into runs of one lane's events, applied in place against L
// resident lanes, one template instantiation per kernel family.
//
// Replaces the Pallas kernel of the JAX package's kernels/frugal_update.py:
//   B3  frugal_program_scatter_pallas / _scatter_kernel  (:271 / :221,
//       pallas_call :327: a sequential "arbitrary" grid over the K event
//       slots against full-array, input/output-aliased state refs, so it
//       applies events in slot order).
//
// What bounds it on this card. Bytes: each slot's lane id and item (and
// mask, where one is given) are read once, and each run reads its lane's
// target, planes and clock and writes planes and clock back once:
// O(N + 2 R state) for N slots in R runs, about 0.15 MB for an SLO flush
// of 4096 events (2u), under 0.05 us of HBM time. Operations (two hash rounds and
// the tick, about 60 per event) take less. What binds is the serial chain
// of the longest run: a lane's ticks depend on each other, so a run of n
// events takes n dependent ticks on one thread. PERF.md records the
// measured per-tick latency, the launch and the bounds.
//
// What the design does about it. One thread per slot; the thread of a
// run's first slot (e == 0 or lanes[e] != lanes[e-1]) walks the whole run
// in slot order with the lane's state and clock in registers
// (frugal_tick.cuh: ft_run_lane_events), and every other thread returns.
// A whole flush of events, however many a lane has, is one launch, and
// each lane gets the result of its events applied one round at a time,
// which is what the TPU kernel's in-order walk gives. The walk is a
// software pipeline: while slot j ticks, slot j+1's uniform is hashed and
// slot j+2's operands are loaded (none depends on the state), so per event
// what remains is the tick's dependent chain and the loop's own work. The
// caller sorts events by lane (stably, to keep arrival order); a round of
// distinct lanes is a batch of runs of length 1.
#include <cuda_runtime.h>

#include "frugal_tick.cuh"

template <int FAM>
__global__ void __launch_bounds__(1024)
frugal_scatter_kernel(const FtScatterArgs a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.K) return;
  if (e > 0 && a.lanes[e] == a.lanes[e - 1]) return;   // not a run's head
  ft_run_lane_events<FAM>(a, e);
}

// Launch the run kernel of `family` (FtFamily) on `stream`. `mask` may be
// null (mask = item is not NaN). Returns the launch's cudaError_t (0 on
// success). Allocates nothing and does not synchronise. K = 0 launches
// nothing and returns 0.
extern "C" int frugal_scatter_launch(
    int family, const int32_t* lanes, const float* items,
    const int32_t* mask, const float* quantile, int32_t q_per_lane,
    void* p0, void* p1, void* p2, void* p3, void* p4, void* p5,
    int32_t* ticks, int64_t K, int64_t L, int32_t seed, int32_t g_offset,
    int32_t s0, int32_t s1, int32_t block_k, void* stream) {
  if (block_k <= 0 || block_k > 1024 || block_k % 32 != 0 || K < 0 ||
      L <= 0)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const FtScatterArgs a = ft_scatter_args(lanes, items, mask, quantile,
                                          q_per_lane, p0, p1, p2, p3, p4, p5,
                                          ticks, K, L, seed, g_offset, s0,
                                          s1);
  const int64_t blocks = (K + block_k - 1) / block_k;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block((unsigned)block_k);
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case FT_1U: frugal_scatter_kernel<FT_1U><<<grid, block, 0, s>>>(a); break;
    case FT_2U: frugal_scatter_kernel<FT_2U><<<grid, block, 0, s>>>(a); break;
    case FT_2U_DECAY:
      frugal_scatter_kernel<FT_2U_DECAY><<<grid, block, 0, s>>>(a);
      break;
    case FT_1U_WINDOW:
      frugal_scatter_kernel<FT_1U_WINDOW><<<grid, block, 0, s>>>(a);
      break;
    case FT_2U_WINDOW:
      frugal_scatter_kernel<FT_2U_WINDOW><<<grid, block, 0, s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
