// The dense frugal ingest kernel for Hopper (sm_90a): [T, G] items through
// any registered lane program, one template instantiation per kernel family
// and lanes per thread.
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
// (shared by the Q lanes of a group: 4/Q bytes per lane-tick) and needs
// at least 44 issue slots of integer and float work (2U; chip_smoke.py
// counts them): one murmur3 fmix32 round for the lane's uniform and the
// branch-free 2U tick. The instruction stream, not
// HBM, is the limit (PERF.md records the measured numbers).
//
// What the design does about it. State stays in registers for the whole
// T loop and crosses HBM once each way; the uniforms never touch memory;
// outputs go to new buffers. The state comes as the serialized words or
// as the program's float32 planes (FtStateFormat, a runtime field read at
// load and store only): the entry points hand planes, so a 2U lane moves
// 12 bytes each way (m, step, sign) instead of 8, and its (step, sign)
// pair goes through the packed word in registers (ft_load_pair,
// ft_store_pair) where PyTorch elementwise passes packed and unpacked it
// around every launch. Per tick, only what each lane must do is left
// on the lane:
//  (1) The tick-hash table. The (seed, t) round of the counter hash is the
//      same for every lane, so before each tile the block's threads fill
//      th[rows] in shared memory with ft_tick_hash(seed, t_offset + i) (the
//      tick wraps in uint32_t) and, for the window families, tw[rows] with
//      the tick's epoch-boundary flags. A lane reads four ticks' entries
//      with one LDS.128 and adds its own key: one fmix32 per lane-tick.
//  (2) Q lanes per thread. The kernel is a template on LPT in {1, 2, 3,
//      4}: for Q <= 4 a thread holds a whole group's Q lanes in registers,
//      reads the group's item once per tick and runs Q independent tick
//      chains, which the scheduler interleaves. Each lane keeps its own
//      absolute lane id (g_offset + g * Q + q) in its key. Q > 4 runs LPT
//      = 1, one lane per thread, through the same tables and tile loop.
//  (3) Item tiles staged by asynchronous copy, double-buffered (the TPU
//      kernel's make_async_copy pipeline): while the block ticks through
//      one [rows, cols] tile (rows at most FT_DENSE_TILE_ROWS), the next
//      is in flight. Two producers fill the
//      same layout, which the consumer reads the same way:
//        TMA: one elected thread issues cp.async.bulk.tensor.2d box copies
//        that complete on an mbarrier; the tensor map is encoded on the
//        host through the runtime's entry point for cuTensorMapEncodeTiled
//        (no -lcuda). TMA needs a row stride G * 4 that is a multiple of
//        16 bytes and a 16-byte aligned base;
//        cp.async: otherwise (G % 4 != 0, as for 1001 or 419 streams) every
//        thread issues 4-byte cp.async (LDGSTS) copies of its columns.
//  (4) An unrolled tick loop inside a tile (ft_run_group): FT_DENSE_UNROLL
//      ticks per step on 32-bit counters, so the loop bookkeeping and the
//      table loads are paid once per step, not once per tick.
//  (5) Tensor cores have no part here: a tick holds no product to give
//      them.
// The Q-fold group->lane fan-out is by index, so [T, G*Q] is never
// materialised; the ragged lane edge is masked, so no padded copy is made.
// A launch or tensor-map encode that fails returns its error; nothing
// falls back to another path.
#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>

#include "frugal_tick.cuh"

// The runtime's handle on cuTensorMapEncodeTiled (cuda.h declares the
// types; the driver entry point is looked up, so nothing links -lcuda).
typedef CUresult (*FtEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// Errors of the tensor-map encode come back as -(1000 + CUresult), apart
// from cudaError_t values.
#define FT_ENCODE_ERROR_BASE 1000

__device__ __forceinline__ uint32_t ft_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Stage tile k into buffer `buf`, and fill its tick tables. TMA: thread 0
// arms the buffer's mbarrier with the tile's bytes (a box counts whole,
// out-of-range rows and columns included, which TMA fills with zeros) and
// issues one box copy per `box` columns. cp.async: each thread copies its
// columns of the tile's rows that lie inside [T, G] and commits one group
// (an empty one past the last tile, so the wait count stays uniform).
template <int FAM>
__device__ __forceinline__ void ft_stage_tile(
    const FtDenseArgs& a, const FtDensePlan& p, const CUtensorMap& tmap,
    float* tiles, uint32_t* th, uint32_t* tw, uint64_t* bar, int64_t g0,
    int32_t k, int32_t buf) {
  const int32_t j = threadIdx.x;
  const bool live = k < p.tiles;
  const int64_t t0 = (int64_t)k * p.rows;
  float* tile = tiles + (int64_t)buf * p.rows * p.cols;
  if (p.producer == FT_PRODUCER_TMA) {
    if (live && j == 0) {
      const uint32_t b = ft_smem_addr(bar + buf);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"((uint32_t)(4 * p.rows * p.cols))
          : "memory");
      for (int32_t c = 0; c < p.cols; c += p.box) {
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                ft_smem_addr(tile + ft_tile_index(p, 0, c))),
            "l"((uint64_t)&tmap), "r"((int32_t)(g0 + c)), "r"((int32_t)t0),
            "r"(b)
            : "memory");
      }
    }
  } else {
    if (live) {
      const int64_t rows = a.T - t0 < p.rows ? a.T - t0 : p.rows;
      for (int32_t c = j; c < p.cols; c += p.threads) {
        if (g0 + c >= a.G) continue;
        const float* src = a.items + t0 * a.G + g0 + c;
        for (int32_t r = 0; r < rows; ++r) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           ft_smem_addr(tile + ft_tile_index(p, r, c))),
                       "l"(src + (int64_t)r * a.G)
                       : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (live) {
    const uint32_t t_abs = (uint32_t)a.t_offset + (uint32_t)t0;
    for (int32_t i = j; i < p.rows; i += p.threads)
      ft_fill_tick_tables<FAM>(th + buf * p.rows, tw + buf * p.rows, i,
                               a.seed, t_abs, a.s0);
  }
}

// Wait for the phase `parity` of a tile's mbarrier. A copy that never
// lands traps once FT_MBAR_TIMEOUT_NS of wall time (the %globaltimer,
// which runs on through preemption and a move to another SM) have passed
// since the wait began, so a fault surfaces as a launch error at the
// caller's next sync instead of a hung card. A tile lands in microseconds;
// the kernel assumes no block is held off its SM for the whole limit
// (a debugger's breakpoint can be).
#define FT_MBAR_TIMEOUT_NS 20000000000ull   // 20 s
__device__ __forceinline__ uint64_t ft_globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void ft_mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = ft_smem_addr(bar);
  uint64_t start = 0;
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = ft_globaltimer_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > FT_MBAR_TIMEOUT_NS) {
      __trap();
    }
  }
}

// Thread j of block b holds lanes (b * threads + j) * LPT ... + LPT - 1 and
// reads item column (its first lane) / Q, at column c of the block's tile.
// Threads past the last lane stage and wait with the rest but hold no lane.
template <int FAM, int LPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
frugal_dense_kernel(const FtDenseArgs a, const FtDensePlan p,
                    const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) unsigned char ft_smem[];
  float* tiles = reinterpret_cast<float*>(ft_smem);
  uint32_t* th = reinterpret_cast<uint32_t*>(tiles + 2 * p.rows * p.cols);
  uint32_t* tw = th + 2 * p.rows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tw + 2 * p.rows);

  const int64_t first = (int64_t)blockIdx.x * p.threads;
  const int64_t lane0 = (first + threadIdx.x) * LPT;
  const bool holds = lane0 < a.L;
  const int64_t g0 = ft_tile_col0(p, first, a.Q);
  const int32_t c = (int32_t)(lane0 / a.Q - g0);
  const float alpha = ft_as_float((uint32_t)a.s0);
  const float floor_ = ft_as_float((uint32_t)a.s1);

  FtGroup<LPT> s;
  if (holds) ft_group_load<FAM, LPT>(s, a, lane0);
  if (p.producer == FT_PRODUCER_TMA && threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       ft_smem_addr(bar + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  ft_stage_tile<FAM>(a, p, tmap, tiles, th, tw, bar, g0, 0, 0);
  ft_stage_tile<FAM>(a, p, tmap, tiles, th, tw, bar, g0, 1, 1);
  __syncthreads();

  const int32_t tile_floats = p.rows * p.cols;
  const int32_t col = holds ? ft_tile_index(p, 0, c) : 0;
  for (int32_t k = 0; k < p.tiles; ++k) {
    const int32_t buf = k & 1;
    if (p.producer == FT_PRODUCER_TMA) {
      ft_mbar_wait(bar + buf, (uint32_t)(k >> 1) & 1u);
    } else {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
    }
    const int64_t left = a.T - (int64_t)k * p.rows;
    const int32_t n = left < p.rows ? (int32_t)left : p.rows;
    if (holds)
      ft_run_group<FAM, LPT>(s, tiles + buf * tile_floats + col, p.box,
                             th + buf * p.rows, tw + buf * p.rows, n, alpha,
                             floor_);
    __syncthreads();   // every thread is done with buffer buf
    ft_stage_tile<FAM>(a, p, tmap, tiles, th, tw, bar, g0, k + 2, buf);
  }
  if (holds) ft_group_store<FAM, LPT>(s, a, lane0);
}

// The tensor map of items [T, G] for `p`'s boxes: dims {G, T}, row stride
// G * 4 bytes, box {box, rows}; out-of-range elements read as zeros.
static int ft_encode_items_map(CUtensorMap* map, const FtDenseArgs& a,
                               const FtDensePlan& p) {
  static FtEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = (FtEncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)a.G, (cuuint64_t)a.T};
  const cuuint64_t strides[1] = {(cuuint64_t)a.G * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)p.box, (cuuint32_t)p.rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)a.items, dims, strides,
      box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(FT_ENCODE_ERROR_BASE + (int)r);
}

// The instantiation for (family, lanes per thread, block size): blocks of
// more than 256 threads get the 1024-thread register budget (64 a thread).
typedef void (*FtDenseKernel)(const FtDenseArgs, const FtDensePlan,
                              const CUtensorMap);

// Allow an instantiation FT_DENSE_SMEM_MAX bytes of dynamic shared memory
// (the most any plan asks), once per device: the attribute is set on the
// current device, so bit d of `allowed` records device d.
template <int FAM, int LPT, int MAXT>
static int ft_allow_smem() {
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (allowed.load(std::memory_order_acquire) & bit) != 0)
    return 0;
  err = cudaFuncSetAttribute((const void*)frugal_dense_kernel<FAM, LPT, MAXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FT_DENSE_SMEM_MAX);
  if (err == cudaSuccess && bit != 0)
    allowed.fetch_or(bit, std::memory_order_release);
  return (int)err;
}

template <int FAM, int LPT>
static int ft_pick_threads(int32_t threads, FtDenseKernel* kernel) {
  if (threads <= 256) {
    *kernel = frugal_dense_kernel<FAM, LPT, 256>;
    return ft_allow_smem<FAM, LPT, 256>();
  }
  *kernel = frugal_dense_kernel<FAM, LPT, 1024>;
  return ft_allow_smem<FAM, LPT, 1024>();
}

template <int FAM>
static int ft_pick_lpt(const FtDensePlan& p, FtDenseKernel* kernel) {
  switch (p.lpt) {
    case 1: return ft_pick_threads<FAM, 1>(p.threads, kernel);
    case 2: return ft_pick_threads<FAM, 2>(p.threads, kernel);
    case 3: return ft_pick_threads<FAM, 3>(p.threads, kernel);
    case 4: return ft_pick_threads<FAM, 4>(p.threads, kernel);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel of `family` for plan `p`, its shared memory allowed.
static int ft_pick_kernel(int family, const FtDensePlan& p,
                          FtDenseKernel* kernel) {
  switch (family) {
    case FT_1U: return ft_pick_lpt<FT_1U>(p, kernel);
    case FT_2U: return ft_pick_lpt<FT_2U>(p, kernel);
    case FT_2U_DECAY: return ft_pick_lpt<FT_2U_DECAY>(p, kernel);
    case FT_1U_WINDOW: return ft_pick_lpt<FT_1U_WINDOW>(p, kernel);
    case FT_2U_WINDOW: return ft_pick_lpt<FT_2U_WINDOW>(p, kernel);
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool ft_dense_shape_ok(int64_t T, int64_t G, int64_t Q,
                              int32_t block_g) {
  return block_g > 0 && block_g <= 1024 && block_g % 32 == 0 && T > 0 &&
         T <= 0x7FFFFFFF && G > 0 && Q > 0;
}

// The plan and kernel of a launch.
static int ft_prepare(int family, int64_t T, int64_t G, int64_t Q,
                      int32_t block_g, const void* items, FtDensePlan* p,
                      FtDenseKernel* kernel) {
  if (!ft_dense_shape_ok(T, G, Q, block_g)) return (int)cudaErrorInvalidValue;
  *p = ft_dense_plan(T, G, Q, block_g, (uint64_t)items);
  if (p->blocks > 0x7FFFFFFF || p->smem_bytes > FT_DENSE_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return ft_pick_kernel(family, *p, kernel);
}

// Launch the dense kernel of `family` (FtFamily) on `stream`, its item
// tiles at most FT_DENSE_TILE_ROWS ticks tall, the state in and out in
// `format` (FtStateFormat): words in0.., or planes in0.. in plane order.
// Writes the item producer used (FtProducer) to *producer. Returns 0 on
// success, a cudaError_t, or -(1000 + CUresult) when the tensor map cannot
// be encoded. Allocates nothing and does not synchronise: a fault during
// the run surfaces at the caller's next sync.
extern "C" int frugal_dense_launch(
    int family, int32_t format, const float* items, const float* quantile,
    const void* in0, const void* in1, const void* in2, const void* in3,
    const void* in4, const void* in5, void* out0, void* out1, void* out2,
    void* out3, void* out4, void* out5, int64_t T, int64_t G, int64_t Q,
    int32_t seed, int32_t t_offset, int32_t g_offset, int32_t s0, int32_t s1,
    int32_t block_g, void* stream, int32_t* producer) {
  if (format != FT_STATE_WORDS && format != FT_STATE_PLANES)
    return (int)cudaErrorInvalidValue;
  FtDensePlan p;
  FtDenseKernel kernel;
  int err = ft_prepare(family, T, G, Q, block_g, items, &p, &kernel);
  if (err != 0) return err;
  const FtDenseArgs a = ft_dense_args(
      format, items, quantile, in0, in1, in2, in3, in4, in5, out0, out1, out2,
      out3, out4, out5, T, G, Q, seed, t_offset, g_offset, s0, s1);
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  if (p.producer == FT_PRODUCER_TMA) {
    err = ft_encode_items_map(&map, a, p);
    if (err != 0) return err;
  }
  *producer = p.producer;
  kernel<<<(unsigned)p.blocks, (unsigned)p.threads, (size_t)p.smem_bytes,
           (cudaStream_t)stream>>>(a, p, map);
  return (int)cudaGetLastError();
}

// Launch facts of the dense kernel of `family` at [T, G] with Q lanes per
// group and block_g threads, for reports: out = {lanes per thread, ticks
// per unrolled step, tile rows, tile columns, dynamic shared memory bytes,
// item producer (FtProducer) for items at `items`, resident blocks per SM
// (the runtime's occupancy calculator), grid blocks, box columns}.
extern "C" int frugal_dense_info(int family, int64_t T, int64_t G, int64_t Q,
                                 int32_t block_g, const void* items,
                                 int64_t* out) {
  FtDensePlan p;
  FtDenseKernel kernel;
  int err = ft_prepare(family, T, G, Q, block_g, items, &p, &kernel);
  if (err != 0) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel, p.threads, (size_t)p.smem_bytes);
  const int64_t v[9] = {p.lpt, FT_DENSE_UNROLL, p.rows, p.cols,
                        p.smem_bytes, p.producer, per_sm, p.blocks, p.box};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return err;
}
