// The sparse event-round kernel for Hopper (sm_90a): K events
// gathered, ticked and scattered in place against L resident lanes, one
// template instantiation per kernel family.
//
// Replaces the Pallas kernel of the JAX package's kernels/frugal_update.py:
//   B3  frugal_program_scatter_pallas / _scatter_kernel  (a sequential
//       grid over K event slots against full-array, input/output-aliased
//       state refs, block_k slots per step).
//
// What bounds it on this card. Per event the function reads the lane id,
// item, mask and target, the lane's planes and clock, and writes the planes
// and clock back: about 48 bytes for 2u (4 x 4 B of event operands, 3
// planes and the clock read and written). At K = 4096 that is about
// 0.2 MB, under 0.1 us of HBM time; the two hash rounds and the tick are
// about 60 operations per event, under 0.01 us of issue time over the
// card. Neither binds: the launch itself (a few us) sets the time of a
// round. PERF.md records the measured numbers.
//
// What the design does about it. One thread per event slot, guarded by
// e < K: no K padding and no block_k multiple. Each thread loads its slot,
// gathers its lane's planes and clock, hashes the uniform in registers,
// runs the family's tick (frugal_tick.cuh: ft_run_event) and stores in
// place into the caller's tensors, so traffic is O(K), never O(L). The
// TPU kernel's grid runs in order ("arbitrary"); here threads run in no
// order, so masked-in lanes must be distinct within a launch, and the
// wrapper pads nothing (the JAX wrapper's K padding on the first event's
// lane would race with that event's store here). Pads a caller makes on a
// lane with no event store identical bytes, a benign race.
#include <cuda_runtime.h>

#include "frugal_tick.cuh"

template <int FAM>
__global__ void __launch_bounds__(1024)
frugal_scatter_kernel(const FtScatterArgs a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.K) return;
  ft_run_event<FAM>(a, e);
}

// Launch the scatter kernel of `family` (FtFamily) on `stream`. Returns the
// launch's cudaError_t (0 on success). Allocates nothing and does not
// synchronise. K = 0 launches nothing and returns 0.
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
