// The dense frugal ingest kernel for Hopper (sm_90a): [T, G] items through
// any registered lane program, one template instantiation per kernel family.
//
// Replaces the Pallas kernels of the JAX package's kernels/frugal_update.py:
//   B1  frugal_program_pallas_dma / _program_kernel_dma  (the TPU's compiled
//       path: state resident for the whole stream, items DMA'd ahead);
//   B2  frugal_program_pallas / _program_kernel  (the (G, T) revisit grid;
//       here the same kernel launched once per block_t rows, t_offset
//       advanced between launches);
//   B4  frugal_program_pallas_gpu / _program_kernel_gpu  (Pallas-Triton,
//       full T loop per block: the same function, launched once).
//
// What bounds it on this card. Each lane-tick reads one float of items
// (shared by the Q lanes of a group: 4/Q bytes per lane-tick) and spends
// about 50-60 integer and float instructions: two murmur3 fmix32 rounds for
// the uniform and the branch-free 2U tick. At Q = 3 the instruction stream,
// not HBM, is the expected limit (PERF.md records the measured numbers).
//
// What the design does about it. One thread per lane with the state in
// registers for the whole T loop: state crosses HBM exactly once each way,
// the uniforms never touch memory, and the only per-tick traffic is the
// item row, read coalesced across the warp (the Q lanes of a group read the
// same address, so a warp touches ~32/Q consecutive floats). The Q-fold
// group->lane fan-out is by index, so [T, G*Q] is never materialised. The
// ragged lane edge is masked here, so no padded copy is made. Outputs go
// to new buffers (the caller's words are not overwritten).
#include <cuda_runtime.h>

#include "frugal_tick.cuh"

template <int FAM>
__global__ void __launch_bounds__(1024)
frugal_dense_kernel(const FtDenseArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  ft_run_lane<FAM>(a, lane);
}

// Launch the dense kernel of `family` (FtFamily) on `stream`. Returns the
// launch's cudaError_t (0 on success). Allocates nothing and does not
// synchronise: a fault during the run surfaces at the caller's next sync.
extern "C" int frugal_dense_launch(
    int family, const float* items, const float* quantile,
    const void* in0, const void* in1, const void* in2, const void* in3,
    void* out0, void* out1, void* out2, void* out3,
    int64_t T, int64_t G, int64_t Q,
    int32_t seed, int32_t t_offset, int32_t g_offset, int32_t s0, int32_t s1,
    int32_t block_g, void* stream) {
  if (block_g <= 0 || block_g > 1024 || block_g % 32 != 0 || T < 0 ||
      G <= 0 || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const FtDenseArgs a = ft_dense_args(items, quantile, in0, in1, in2, in3,
                                      out0, out1, out2, out3, T, G, Q, seed,
                                      t_offset, g_offset, s0, s1);
  const int64_t blocks = (a.L + block_g - 1) / block_g;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block((unsigned)block_g);
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case FT_1U: frugal_dense_kernel<FT_1U><<<grid, block, 0, s>>>(a); break;
    case FT_2U: frugal_dense_kernel<FT_2U><<<grid, block, 0, s>>>(a); break;
    case FT_2U_DECAY:
      frugal_dense_kernel<FT_2U_DECAY><<<grid, block, 0, s>>>(a);
      break;
    case FT_1U_WINDOW:
      frugal_dense_kernel<FT_1U_WINDOW><<<grid, block, 0, s>>>(a);
      break;
    case FT_2U_WINDOW:
      frugal_dense_kernel<FT_2U_WINDOW><<<grid, block, 0, s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
