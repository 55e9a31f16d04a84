// Per-lane tick arithmetic of the frugal lane programs, shared by the CUDA
// kernels (frugal_update.cu: dense; frugal_scatter.cu: sparse event runs)
// and a host build (tick_host_shim.cpp) that the CPU tests hold bit-for-bit
// against the JAX package.
//
// Each function transcribes one expression tree of the JAX package
// (core/rng.py, core/packing.py, core/frugal.py, core/drift.py), so every
// float32 operation rounds where the reference rounds. The hazards that
// would make a transcription "work" and still disagree are handled here:
//
//  (1) Logical shifts and overflow: hashing and packing run in uint32_t.
//      Signed overflow is undefined in C++ and >> on int is arithmetic.
//  (2) Floor division: window epochs use ft_floor_div. Ticks go negative
//      after the int32 wrap and C++ '/' truncates toward zero.
//  (3) FMA contraction: float arithmetic goes through ft_add/ft_sub/ft_mul,
//      which are __fadd_rn/__fsub_rn/__fmul_rn on the device (never fused)
//      and plain operators on the host, built with -ffp-contract=off.
//  (4) Float literals: every constant is a float (1.0f), so `1 - q` is a
//      float32 subtraction as in the reference, not a double one.
//  (5) 64-bit item offsets: a tile row's offset (t0 + r) * G is formed in
//      int64_t; it overflows int32 at full width.
//  (6) Tick counter: t_offset + i wraps as int32; it is added in uint32_t.
//  (7) NaN items are no-op ticks through comparisons that are false; window
//      restarts and decay are gated on `item == item`, as in the reference.
#pragma once

#include <stdint.h>
#include <string.h>
#include <math.h>

#ifdef __CUDACC__
#define FT_HD __host__ __device__ __forceinline__
#else
#define FT_HD inline
#endif

// Loop pragmas for the device compiler only (g++ would warn on them).
#ifdef __CUDA_ARCH__
#define FT_PRAGMA(x) _Pragma(#x)
#else
#define FT_PRAGMA(x)
#endif

enum FtFamily {
  FT_1U = 0,
  FT_2U = 1,
  FT_2U_DECAY = 2,
  FT_1U_WINDOW = 3,
  FT_2U_WINDOW = 4,
};

// ------------------------------------------------------------------ bits
FT_HD float ft_as_float(uint32_t b) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

FT_HD uint32_t ft_as_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t b;
  memcpy(&b, &f, sizeof b);
  return b;
#endif
}

FT_HD int32_t ft_i32(uint32_t x) { return (int32_t)x; }  // two's complement

// --------------------------------------------------------- float, unfused
FT_HD float ft_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

FT_HD float ft_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

FT_HD float ft_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

FT_HD float ft_ceil(float x) { return ceilf(x); }

// -------------------------------------------------------- counter hash
FT_HD uint32_t ft_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// First round: depends on (seed, t) only.
FT_HD uint32_t ft_tick_hash(int32_t seed, int32_t t) {
  return ft_fmix32((uint32_t)seed + (uint32_t)t * 0x9E3779B9u);
}

// Second round: mixes in the absolute lane id.
FT_HD uint32_t ft_lane_hash(uint32_t tick_hash, int32_t lane) {
  return ft_fmix32(tick_hash + (uint32_t)lane * 0x85EBCA77u);
}

FT_HD uint32_t ft_counter_bits(int32_t seed, int32_t t, int32_t lane) {
  return ft_lane_hash(ft_tick_hash(seed, t), lane);
}

// Mantissa fill: top 23 hash bits in a float of [1, 2), minus 1.
FT_HD float ft_bits_to_uniform(uint32_t bits) {
  return ft_sub(ft_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

FT_HD float ft_counter_uniform(int32_t seed, int32_t t, int32_t lane) {
  return ft_bits_to_uniform(ft_counter_bits(seed, t, lane));
}

// ------------------------------------------------------------- packing
#define FT_MAX_STEP 4294967040.0f   // largest float32 below 2^32
#define FT_EXP_OFFSET (96u << 23)

FT_HD uint32_t ft_pack_step_sign(float step, float sign) {
  // NaN flushes to 0; |step| >= 2^32 (and inf) saturates to FT_MAX_STEP.
  float s = (step != step) ? 0.0f
          : (step > FT_MAX_STEP ? FT_MAX_STEP
             : (step < -FT_MAX_STEP ? -FT_MAX_STEP : step));
  uint32_t sb = ft_as_bits(s);
  uint32_t e = (sb >> 23) & 0xFFu;
  bool neg = sign < 0.0f;
  if (e < 64u) return neg ? 0x80000000u : 0u;   // zero, subnormal, flushed
  return sb + (neg ? FT_EXP_OFFSET : 0u);
}

FT_HD void ft_unpack_step_sign(uint32_t packed, float* step, float* sign) {
  uint32_t e = (packed >> 23) & 0xFFu;
  bool is_zero = e == 0u;
  bool is_neg_dir = e >= 160u;
  uint32_t sb = is_zero ? 0u : (is_neg_dir ? packed - FT_EXP_OFFSET : packed);
  *step = ft_as_float(sb);
  bool neg = is_neg_dir || (is_zero && (packed >> 31) != 0u);
  *sign = neg ? -1.0f : 1.0f;
}

// ----------------------------------------------------------- tick rules
FT_HD int32_t ft_floor_div(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Frugal-1U (paper Algorithm 2). m + up - down even when both are false:
// the reference's adds turn -0 into +0 on every tick, NaN ticks included.
FT_HD void ft_tick_1u(float& m, float item, float u, float q) {
  bool up = (item > m) && (u > ft_sub(1.0f, q));
  bool down = (item < m) && (u > q);
  m = ft_sub(ft_add(m, up ? 1.0f : 0.0f), down ? 1.0f : 0.0f);
}

// Frugal-2U (paper Algorithm 3, f(step) = 1), both branches computed and
// selected, as core/frugal.py writes it.
FT_HD void ft_tick_2u(float& m, float& step, float& sign, float item, float u,
                      float q) {
  bool up = (item > m) && (u > ft_sub(1.0f, q));
  bool down = (item < m) && (u > q);

  float step_u = ft_add(step, sign > 0.0f ? 1.0f : -1.0f);
  float m_u = ft_add(m, step_u > 0.0f ? ft_ceil(step_u) : 1.0f);
  bool osh_u = m_u > item;
  step_u = osh_u ? ft_add(step_u, ft_sub(item, m_u)) : step_u;
  m_u = osh_u ? item : m_u;
  step_u = (sign < 0.0f && step_u > 1.0f) ? 1.0f : step_u;

  float step_d = ft_add(step, sign < 0.0f ? 1.0f : -1.0f);
  float m_d = ft_sub(m, step_d > 0.0f ? ft_ceil(step_d) : 1.0f);
  bool osh_d = m_d < item;
  step_d = osh_d ? ft_add(step_d, ft_sub(m_d, item)) : step_d;
  m_d = osh_d ? item : m_d;
  step_d = (sign > 0.0f && step_d > 1.0f) ? 1.0f : step_d;

  m = up ? m_u : (down ? m_d : m);
  step = up ? step_u : (down ? step_d : step);
  sign = up ? 1.0f : (down ? -1.0f : sign);
}

// Decayed Frugal-2U: Algorithm 3, then floor - (floor - step) * alpha where
// a real tick left step below the floor.
FT_HD void ft_tick_2u_decay(float& m, float& step, float& sign, float item,
                            float u, float q, float alpha, float floor_) {
  ft_tick_2u(m, step, sign, item, u, q);
  float decayed = ft_sub(floor_, ft_mul(ft_sub(floor_, step), alpha));
  step = (item == item && step < floor_) ? decayed : step;
}

// Epoch-boundary restart masks for absolute tick t (window W > 0). The
// products and differences wrap like the reference's int32 arithmetic.
FT_HD void ft_window_phase(int32_t t, int32_t w, bool& reset_a,
                           bool& reset_b) {
  int32_t epoch = ft_floor_div(t, w);
  bool boundary = ft_i32((uint32_t)t - (uint32_t)epoch * (uint32_t)w) == 0;
  int32_t parity = ft_i32((uint32_t)epoch
                          - (uint32_t)ft_floor_div(epoch, 2) * 2u);
  reset_a = boundary && parity == 0;
  reset_b = boundary && parity != 0;
}

// The window ticks take the epoch-boundary flags of their tick (the dense
// kernel computes them once per tick per block) or the tick itself.
FT_HD void ft_tick_1u_window_flags(float& m, float& m2, float item,
                                   float u, float q, bool ra, bool rb) {
  bool valid = item == item;
  ra = ra && valid;
  rb = rb && valid;
  float m_a = ra ? m2 : m;
  float m_b = rb ? m : m2;
  ft_tick_1u(m_a, item, u, q);
  ft_tick_1u(m_b, item, u, q);
  m = m_a;
  m2 = m_b;
}

FT_HD void ft_tick_1u_window(float& m, float& m2, float item, float u,
                             float q, int32_t t, int32_t w) {
  bool ra, rb;
  ft_window_phase(t, w, ra, rb);
  ft_tick_1u_window_flags(m, m2, item, u, q, ra, rb);
}

FT_HD void ft_tick_2u_window_flags(float& m, float& step, float& sign,
                                   float& m2, float& step2, float& sign2,
                                   float item, float u, float q, bool ra,
                                   bool rb) {
  bool valid = item == item;
  ra = ra && valid;
  rb = rb && valid;
  float m_a = ra ? m2 : m;
  float step_a = ra ? 1.0f : step;
  float sign_a = ra ? 1.0f : sign;
  float m_b = rb ? m : m2;
  float step_b = rb ? 1.0f : step2;
  float sign_b = rb ? 1.0f : sign2;
  ft_tick_2u(m_a, step_a, sign_a, item, u, q);
  ft_tick_2u(m_b, step_b, sign_b, item, u, q);
  m = m_a; step = step_a; sign = sign_a;
  m2 = m_b; step2 = step_b; sign2 = sign_b;
}

FT_HD void ft_tick_2u_window(float& m, float& step, float& sign, float& m2,
                             float& step2, float& sign2, float item, float u,
                             float q, int32_t t, int32_t w) {
  bool ra, rb;
  ft_window_phase(t, w, ra, rb);
  ft_tick_2u_window_flags(m, step, sign, m2, step2, sign2, item, u, q, ra,
                          rb);
}

// ------------------------------------------------------ dense group runs
// The state formats a dense call reads and writes. Words are the program's
// serialized state, unit-major (f32 head [+ i32 packed pair] per
// plane-pair); planes its unpacked float32 planes in plane_fields order
// (m [, step, sign] per unit). Either way each slot is [L] and handled
// here as raw 32-bit words.
enum FtStateFormat { FT_STATE_WORDS = 0, FT_STATE_PLANES = 1 };

// Operands of one dense ingest call; unused state slots are null. The
// field order is part of the kernel's speed: the compiler schedules the
// tick loop differently for other layouts of this parameter block, and
// with the format last B1 ran 2 % slower at 2U on an H100 (PERF.md).
struct FtDenseArgs {
  int32_t format;           // FtStateFormat of in and out
  const float* items;       // [T, G] float32, row-major (NaN = no-op tick)
  const float* quantile;    // [L] float32
  const uint32_t* in[6];    // state in: 1-4 words or 1-6 planes
  uint32_t* out[6];         // state out, in the same format
  int64_t T;
  int64_t G;                // item columns; lane l reads column l / Q
  int64_t L;                // lanes = G * Q
  int64_t Q;
  int32_t seed;
  int32_t t_offset;         // absolute tick of items row 0 (int32-wrapped)
  int32_t g_offset;         // absolute lane id of lane 0
  int32_t s0;               // program scalars: decay alpha and floor bits,
  int32_t s1;               // or the window length in s0
};

inline FtDenseArgs ft_dense_args(
    int32_t format, const float* items, const float* quantile,
    const void* in0, const void* in1, const void* in2, const void* in3,
    const void* in4, const void* in5, void* out0, void* out1, void* out2,
    void* out3, void* out4, void* out5, int64_t T, int64_t G, int64_t Q,
    int32_t seed, int32_t t_offset, int32_t g_offset, int32_t s0,
    int32_t s1) {
  FtDenseArgs a;
  a.items = items;
  a.quantile = quantile;
  const void* in[6] = {in0, in1, in2, in3, in4, in5};
  void* out[6] = {out0, out1, out2, out3, out4, out5};
  for (int k = 0; k < 6; ++k) {
    a.in[k] = (const uint32_t*)in[k];
    a.out[k] = (uint32_t*)out[k];
  }
  a.T = T;
  a.G = G;
  a.L = G * Q;
  a.Q = Q;
  a.format = format;
  a.seed = seed;
  a.t_offset = t_offset;
  a.g_offset = g_offset;
  a.s0 = s0;
  a.s1 = s1;
  return a;
}

// Ticks per step of the unrolled tile loop (a multiple of 4: the tick
// tables are read four words at a time) and the most ticks an item tile
// holds (a multiple of 4, at most the TMA box limit). 16 and 32 from a
// sweep of unroll 4, 8, 16 and rows 8 to 64 on an H100 (PERF.md,
// tools/bench_b1.py sweep, which rebuilds with -D overrides of these two).
#ifndef FT_DENSE_UNROLL
#define FT_DENSE_UNROLL 16
#endif
#ifndef FT_DENSE_TILE_ROWS
#define FT_DENSE_TILE_ROWS 32
#endif
#define FT_DENSE_MAX_LPT 4          // Q above this: one lane per thread
#define FT_DENSE_TILE_BYTES 98304   // both item tile buffers, at most
#define FT_TMA_BOX_MAX 256          // TMA box extent limit, in elements
static_assert(FT_DENSE_UNROLL % 4 == 0, "FT_DENSE_UNROLL: a multiple of 4");
static_assert(FT_DENSE_TILE_ROWS % 4 == 0 && FT_DENSE_TILE_ROWS >= 4 &&
                  FT_DENSE_TILE_ROWS <= FT_TMA_BOX_MAX,
              "FT_DENSE_TILE_ROWS: a multiple of 4 in [4, 256]");
// The most dynamic shared memory a plan asks (ft_dense_plan's smem_bytes:
// a tile buffer pair of at most FT_DENSE_TILE_BYTES, the tables, the
// mbarriers).
#define FT_DENSE_SMEM_MAX (FT_DENSE_TILE_BYTES + 16 * FT_DENSE_TILE_ROWS + 16)

enum FtProducer { FT_PRODUCER_CP_ASYNC = 1, FT_PRODUCER_TMA = 2 };

// How one dense call is cut. A thread holds `lpt` consecutive lanes (a
// whole group when Q <= 4, else one lane); a block of `threads` threads
// stages the item columns its lanes read, `cols` wide, `rows` ticks at a
// time, in two buffers. A buffer is laid out [cols / box][rows][box] (one
// TMA box after another), so column c of row r is at
// ft_tile_index(p, r, c) for either producer.
struct FtDensePlan {
  int32_t lpt;
  int32_t threads;
  int32_t rows;           // ticks per tile, a multiple of 4
  int32_t cols;           // item columns per block
  int32_t box;            // columns per TMA box; divides cols
  int32_t tiles;          // ceil(T / rows)
  int32_t producer;       // FtProducer
  int64_t blocks;
  int64_t smem_bytes;     // two tiles, two tick-hash and two window tables,
                          // two mbarriers
};

FT_HD int64_t ft_round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

// TMA needs a 16-byte aligned base, a row stride G * 4 that is a multiple
// of 16 bytes and int32 box coordinates; any other items run the cp.async
// producer.
inline FtDensePlan ft_dense_plan(int64_t T, int64_t G, int64_t Q,
                                 int32_t block_g, uint64_t items_addr) {
  FtDensePlan p;
  p.lpt = Q <= FT_DENSE_MAX_LPT ? (int32_t)Q : 1;
  p.threads = block_g;
  // A block's lanes span at most (threads - 1) / Q + 2 groups when a
  // thread holds one lane of a wider group; its tile starts up to 31
  // columns before them (ft_tile_col0).
  p.cols = p.lpt == Q ? block_g
                      : (int32_t)ft_round_up((block_g - 1) / Q + 2 + 31, 32);
  p.box = p.cols;
  if (p.cols > FT_TMA_BOX_MAX) {
    int32_t d = FT_TMA_BOX_MAX / 32;
    while ((p.cols / 32) % d != 0) --d;
    p.box = 32 * d;
  }
  int64_t rows = FT_DENSE_TILE_BYTES / (8 * (int64_t)p.cols);
  if (rows > FT_DENSE_TILE_ROWS) rows = FT_DENSE_TILE_ROWS;
  if (rows > ft_round_up(T, 4)) rows = ft_round_up(T, 4);
  rows = rows / 4 * 4;
  p.rows = (int32_t)(rows < 4 ? 4 : rows);
  p.tiles = (int32_t)((T + p.rows - 1) / p.rows);
  p.producer = (G % 4 == 0 && items_addr % 16 == 0 && T <= 0x7FFFFFFF &&
                G <= 0x7FFFFFFF)
                   ? FT_PRODUCER_TMA
                   : FT_PRODUCER_CP_ASYNC;
  const int64_t per_block = (int64_t)block_g * p.lpt;
  p.blocks = (G * Q + per_block - 1) / per_block;
  p.smem_bytes = 8 * (int64_t)p.rows * p.cols + 16 * (int64_t)p.rows + 16;
  return p;
}

FT_HD int32_t ft_tile_index(const FtDensePlan& p, int32_t r, int32_t c) {
  return (c / p.box) * p.rows * p.box + r * p.box + c % p.box;
}

// The first item column of the tile of the block whose first thread is
// `first`: the group of its first lane, rounded down to a multiple of 32
// columns (128 bytes), so every box starts aligned. With Q <= 4 the group
// is `first` itself, already a multiple of 32.
FT_HD int64_t ft_tile_col0(const FtDensePlan& p, int64_t first, int64_t Q) {
  return first * p.lpt / Q / 32 * 32;
}

// The per-tick tables of a tile, entry j for absolute tick t0 + j: the
// (seed, t) round of the counter hash, and for the window families the
// epoch-boundary flags (bit 0 restarts plane a, bit 1 plane b).
template <int FAM>
FT_HD void ft_fill_tick_tables(uint32_t* th, uint32_t* tw, int32_t j,
                               int32_t seed, uint32_t t0, int32_t w) {
  const int32_t t = ft_i32(t0 + (uint32_t)j);   // wraps, hazard (6)
  th[j] = ft_tick_hash(seed, t);
  if (FAM == FT_1U_WINDOW || FAM == FT_2U_WINDOW) {
    bool ra, rb;
    ft_window_phase(t, w, ra, rb);
    tw[j] = (ra ? 1u : 0u) | (rb ? 2u : 0u);
  }
}

// The state of one thread's LPT lanes, in registers on the device. key is
// the lane's absolute id times the lane-round multiplier, so a lane's
// uniform at a tick is one add and one fmix32 on the tick's table entry.
template <int LPT>
struct FtGroup {
  float m[LPT], step[LPT], sign[LPT], m2[LPT], step2[LPT], sign2[LPT];
  float q[LPT];
  uint32_t key[LPT];
};

// One lane's (step, sign) pair: its packed word at w[lane], or in the
// planes format its step and sign planes at w[lane] and g[lane], passed
// through the word all the same. So a plane reads as the word path's
// (pack before the kernel, the kernel's unpack) reads it, out-of-domain
// steps included: NaN to 0, saturation at FT_MAX_STEP, |step| < 2^-63 to 0
// with its sign kept.
FT_HD void ft_load_pair(bool planes, const uint32_t* w, const uint32_t* g,
                        int64_t lane, float* step, float* sign) {
  const uint32_t word =
      planes ? ft_pack_step_sign(ft_as_float(w[lane]), ft_as_float(g[lane]))
             : w[lane];
  ft_unpack_step_sign(word, step, sign);
}

// The pair stored as its word, or in the planes format as the word's
// unpacked step and sign (the kernel's pack, then the word path's unpack).
FT_HD void ft_store_pair(bool planes, uint32_t* w, uint32_t* g, int64_t lane,
                         float step, float sign) {
  const uint32_t word = ft_pack_step_sign(step, sign);
  if (!planes) {
    w[lane] = word;
    return;
  }
  float st, sg;
  ft_unpack_step_sign(word, &st, &sg);
  w[lane] = ft_as_bits(st);
  g[lane] = ft_as_bits(sg);
}

// Load lanes lane0 .. lane0 + LPT - 1 from either state format. Slots:
// words (m [, pair]) [, (m2 [, pair2])], planes (m [, step, sign])
// [, (m2 [, step2, sign2])]; 1u and 1u-window are the same in both.
template <int FAM, int LPT>
FT_HD void ft_group_load(FtGroup<LPT>& s, const FtDenseArgs& a,
                         int64_t lane0) {
  const bool planes = a.format == FT_STATE_PLANES;
  FT_PRAGMA(unroll)
  for (int l = 0; l < LPT; ++l) {
    const int64_t lane = lane0 + l;
    s.q[l] = a.quantile[lane];
    s.key[l] = ((uint32_t)a.g_offset + (uint32_t)lane) * 0x85EBCA77u;
    s.m[l] = ft_as_float(a.in[0][lane]);
    s.step[l] = 1.0f; s.sign[l] = 1.0f;
    s.m2[l] = 0.0f; s.step2[l] = 1.0f; s.sign2[l] = 1.0f;
    if (FAM == FT_2U || FAM == FT_2U_DECAY || FAM == FT_2U_WINDOW)
      ft_load_pair(planes, a.in[1], a.in[2], lane, &s.step[l], &s.sign[l]);
    if (FAM == FT_1U_WINDOW) s.m2[l] = ft_as_float(a.in[1][lane]);
    if (FAM == FT_2U_WINDOW) {
      if (planes) {
        s.m2[l] = ft_as_float(a.in[3][lane]);
        ft_load_pair(true, a.in[4], a.in[5], lane, &s.step2[l],
                     &s.sign2[l]);
      } else {
        s.m2[l] = ft_as_float(a.in[2][lane]);
        ft_load_pair(false, a.in[3], nullptr, lane, &s.step2[l],
                     &s.sign2[l]);
      }
    }
  }
}

// Store lanes lane0 .. lane0 + LPT - 1 in the format they were loaded in.
template <int FAM, int LPT>
FT_HD void ft_group_store(const FtGroup<LPT>& s, const FtDenseArgs& a,
                          int64_t lane0) {
  const bool planes = a.format == FT_STATE_PLANES;
  FT_PRAGMA(unroll)
  for (int l = 0; l < LPT; ++l) {
    const int64_t lane = lane0 + l;
    a.out[0][lane] = ft_as_bits(s.m[l]);
    if (FAM == FT_2U || FAM == FT_2U_DECAY || FAM == FT_2U_WINDOW)
      ft_store_pair(planes, a.out[1], a.out[2], lane, s.step[l], s.sign[l]);
    if (FAM == FT_1U_WINDOW) a.out[1][lane] = ft_as_bits(s.m2[l]);
    if (FAM == FT_2U_WINDOW) {
      if (planes) {
        a.out[3][lane] = ft_as_bits(s.m2[l]);
        ft_store_pair(true, a.out[4], a.out[5], lane, s.step2[l],
                      s.sign2[l]);
      } else {
        a.out[2][lane] = ft_as_bits(s.m2[l]);
        ft_store_pair(false, a.out[3], nullptr, lane, s.step2[l],
                      s.sign2[l]);
      }
    }
  }
}

// One tick of the thread's LPT lanes on one item: LPT independent chains.
template <int FAM, int LPT>
FT_HD void ft_group_tick(FtGroup<LPT>& s, float item, uint32_t th,
                         uint32_t tw, float alpha, float floor_) {
  const bool ra = (tw & 1u) != 0u, rb = (tw & 2u) != 0u;
  FT_PRAGMA(unroll)
  for (int l = 0; l < LPT; ++l) {
    const float u = ft_bits_to_uniform(ft_fmix32(th + s.key[l]));
    switch (FAM) {
      case FT_1U: ft_tick_1u(s.m[l], item, u, s.q[l]); break;
      case FT_2U: ft_tick_2u(s.m[l], s.step[l], s.sign[l], item, u, s.q[l]);
        break;
      case FT_2U_DECAY:
        ft_tick_2u_decay(s.m[l], s.step[l], s.sign[l], item, u, s.q[l],
                         alpha, floor_);
        break;
      case FT_1U_WINDOW:
        ft_tick_1u_window_flags(s.m[l], s.m2[l], item, u, s.q[l], ra, rb);
        break;
      case FT_2U_WINDOW:
        ft_tick_2u_window_flags(s.m[l], s.step[l], s.sign[l], s.m2[l],
                                s.step2[l], s.sign2[l], item, u, s.q[l], ra,
                                rb);
        break;
    }
  }
}

// Four table words from a 16-byte aligned address: one LDS.128 on the
// device.
FT_HD void ft_load4(const uint32_t* p, uint32_t* out) {
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
#else
  for (int k = 0; k < 4; ++k) out[k] = p[k];
#endif
}

// The thread's lanes through the first n ticks of a staged tile: tick i
// reads its item at col[i * stride] and its table entries th[i] (and
// tw[i]). Ticks run FT_DENSE_UNROLL per step with 32-bit counters; the
// last n % FT_DENSE_UNROLL one at a time. The kernel runs this once per
// tile on each thread; the host shim likewise on a host tile.
template <int FAM, int LPT>
FT_HD void ft_run_group(FtGroup<LPT>& s, const float* col, int32_t stride,
                        const uint32_t* th, const uint32_t* tw, int32_t n,
                        float alpha, float floor_) {
  constexpr int U = FT_DENSE_UNROLL;
  constexpr bool WIN = FAM == FT_1U_WINDOW || FAM == FT_2U_WINDOW;
  int32_t i = 0;
  FT_PRAGMA(unroll 1)
  for (; i + U <= n; i += U) {
    uint32_t h[U], w[U];
    float x[U];
    FT_PRAGMA(unroll)
    for (int k = 0; k < U; k += 4) {
      ft_load4(th + i + k, h + k);
      if (WIN) ft_load4(tw + i + k, w + k);
    }
    FT_PRAGMA(unroll)
    for (int k = 0; k < U; ++k) x[k] = col[(i + k) * stride];
    FT_PRAGMA(unroll)
    for (int k = 0; k < U; ++k)
      ft_group_tick<FAM, LPT>(s, x[k], h[k], WIN ? w[k] : 0u, alpha, floor_);
  }
  FT_PRAGMA(unroll 1)
  for (; i < n; ++i)
    ft_group_tick<FAM, LPT>(s, col[i * stride], th[i], WIN ? tw[i] : 0u,
                            alpha, floor_);
}

// ------------------------------------------------------ sparse event runs
// Operands of one batch of sparse events: K event slots against L resident
// lanes whose state rides unpacked float planes (the program's
// plane_fields order, each [L]) and an [L] int32 per-lane clock, all
// updated in place. Unused plane slots are null.
//
// Run contract: a run is a maximal stretch of adjacent slots naming one
// lane. Each lane's masked-in events lie in one run, in arrival order, and
// distinct runs name distinct lanes, except runs made only of pads (mask
// 0 or NaN items), which store their lane's state as a NaN tick leaves it
// (the same bytes however often it runs). A round of distinct lanes is the
// special case of runs of length 1.
struct FtScatterArgs {
  const int32_t* lanes;     // [K] event lane ids, each lane's events adjacent
  const float* items;       // [K] float32
  const int32_t* mask;      // [K] 1 advances the lane's clock, 0 is a pad;
                            // null: mask = (item is not NaN)
  const float* quantile;    // [L] per-lane targets, or [1] for all lanes
  float* planes[6];         // (m, step, sign, m2, step2, sign2) as present
  int32_t* ticks;           // [L] per-lane clock
  int64_t K;
  int64_t L;
  int32_t q_per_lane;       // 1: quantile[lane]; 0: quantile[0]
  int32_t seed;
  int32_t g_offset;         // absolute lane id of lane 0
  int32_t s0;               // program scalars, as in FtDenseArgs
  int32_t s1;
};

inline FtScatterArgs ft_scatter_args(
    const int32_t* lanes, const float* items, const int32_t* mask,
    const float* quantile, int32_t q_per_lane, void* p0, void* p1, void* p2,
    void* p3, void* p4, void* p5, int32_t* ticks, int64_t K, int64_t L,
    int32_t seed, int32_t g_offset, int32_t s0, int32_t s1) {
  FtScatterArgs a;
  a.lanes = lanes;
  a.items = items;
  a.mask = mask;
  a.quantile = quantile;
  a.planes[0] = (float*)p0;
  a.planes[1] = (float*)p1;
  a.planes[2] = (float*)p2;
  a.planes[3] = (float*)p3;
  a.planes[4] = (float*)p4;
  a.planes[5] = (float*)p5;
  a.ticks = ticks;
  a.K = K;
  a.L = L;
  a.q_per_lane = q_per_lane;
  a.seed = seed;
  a.g_offset = g_offset;
  a.s0 = s0;
  a.s1 = s1;
  return a;
}

// Slot j's item and mask: a null mask counts the slot iff its item is not
// NaN; a slot with mask 0 ticks with a NaN item, so it never moves state
// without its clock.
FT_HD void ft_slot(const FtScatterArgs& a, int64_t j, float& item,
                   int32_t& mk) {
  item = a.items[j];
  mk = a.mask ? a.mask[j] : (int32_t)(item == item);
  item = mk != 0 ? item : ft_as_float(0x7FC00000u);
}

// The run of lane lanes[head] that starts at slot `head`: load the lane's
// planes, clock and target once, tick once per slot j = head, head+1, ...
// while lanes[j] names the lane, each with the uniform keyed on (seed, the
// lane's own tick, absolute lane id) and the clock advanced by the slot's
// mask, then store planes and clock once. This equals the slots applied
// one round at a time in slot order: a lane's tick reads only its own
// state and clock. A lane id outside [0, L) is skipped: nothing is read
// or written for its run.
template <int FAM>
FT_HD void ft_run_lane_events(const FtScatterArgs& a, int64_t head) {
  const int32_t lane = a.lanes[head];
  if (lane < 0 || (int64_t)lane >= a.L) return;
  const float q = a.quantile[a.q_per_lane ? lane : 0];
  const int32_t lane_id = ft_i32((uint32_t)a.g_offset + (uint32_t)lane);
  const float alpha = ft_as_float((uint32_t)a.s0);
  const float floor_ = ft_as_float((uint32_t)a.s1);
  float* const* p = a.planes;
  uint32_t tick = (uint32_t)a.ticks[lane];

  float m = p[0][lane], step = 1.0f, sign = 1.0f;
  float m2 = 0.0f, step2 = 1.0f, sign2 = 1.0f;
  if (FAM == FT_2U || FAM == FT_2U_DECAY || FAM == FT_2U_WINDOW) {
    step = p[1][lane];
    sign = p[2][lane];
  }
  if (FAM == FT_1U_WINDOW) m2 = p[1][lane];
  if (FAM == FT_2U_WINDOW) {
    m2 = p[3][lane];
    step2 = p[4][lane];
    sign2 = p[5][lane];
  }

  // A software pipeline over the run: slot j ticks while slot j+1's
  // uniform is hashed and slot j+2's operands are loaded. None of them
  // depends on the state, so each load has a whole tick to arrive and the
  // tick's dependent chain is what remains per event. Two copies of the
  // body per trip (unroll 2) measured faster on sm_90a than one or four
  // (PERF.md).
  const int64_t last = a.K - 1;
  int64_t j = head;
  float item;
  int32_t mk;
  ft_slot(a, j, item, mk);
  float u = ft_counter_uniform(a.seed, ft_i32(tick), lane_id);
  int64_t jn = j < last ? j + 1 : j;
  int32_t lane_n = a.lanes[jn];
  float item_n;
  int32_t mk_n;
  ft_slot(a, jn, item_n, mk_n);
#ifdef __CUDA_ARCH__
#pragma unroll 2
#endif
  for (;;) {
    const int32_t t = ft_i32(tick);
    tick += (uint32_t)mk;
    const bool more = jn != j && lane_n == lane;
    const int64_t jnn = jn < last ? jn + 1 : jn;
    const int32_t lane_nn = a.lanes[jnn];
    float item_nn;
    int32_t mk_nn;
    ft_slot(a, jnn, item_nn, mk_nn);
    const float u_n = ft_counter_uniform(a.seed, ft_i32(tick), lane_id);
    switch (FAM) {
      case FT_1U: ft_tick_1u(m, item, u, q); break;
      case FT_2U: ft_tick_2u(m, step, sign, item, u, q); break;
      case FT_2U_DECAY:
        ft_tick_2u_decay(m, step, sign, item, u, q, alpha, floor_);
        break;
      case FT_1U_WINDOW:
        ft_tick_1u_window(m, m2, item, u, q, t, a.s0);
        break;
      case FT_2U_WINDOW:
        ft_tick_2u_window(m, step, sign, m2, step2, sign2, item, u, q, t,
                          a.s0);
        break;
    }
    if (!more) break;
    j = jn;
    jn = jnn;
    item = item_n;
    mk = mk_n;
    u = u_n;
    lane_n = lane_nn;
    item_n = item_nn;
    mk_n = mk_nn;
  }

  p[0][lane] = m;
  if (FAM == FT_2U || FAM == FT_2U_DECAY || FAM == FT_2U_WINDOW) {
    p[1][lane] = step;
    p[2][lane] = sign;
  }
  if (FAM == FT_1U_WINDOW) p[1][lane] = m2;
  if (FAM == FT_2U_WINDOW) {
    p[3][lane] = m2;
    p[4][lane] = step2;
    p[5][lane] = sign2;
  }
  a.ticks[lane] = ft_i32(tick);
}
