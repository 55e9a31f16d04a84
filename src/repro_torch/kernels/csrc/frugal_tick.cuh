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
//  (5) 64-bit item offsets: the item pointer advances by G (int64_t) per
//      tick; t * G overflows int32 at full width.
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

FT_HD void ft_tick_1u_window(float& m, float& m2, float item, float u,
                             float q, int32_t t, int32_t w) {
  bool ra, rb;
  ft_window_phase(t, w, ra, rb);
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

FT_HD void ft_tick_2u_window(float& m, float& step, float& sign, float& m2,
                             float& step2, float& sign2, float item, float u,
                             float q, int32_t t, int32_t w) {
  bool ra, rb;
  ft_window_phase(t, w, ra, rb);
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

// --------------------------------------------------------- one lane's run
// Operands of one dense ingest call. Words are the program's serialized
// state, unit-major (f32 head [+ i32 packed pair] per plane-pair), each [L]
// and handled here as raw 32-bit words; unused slots are null.
struct FtDenseArgs {
  const float* items;       // [T, G] float32, row-major (NaN = no-op tick)
  const float* quantile;    // [L] float32
  const uint32_t* in[4];    // state words in
  uint32_t* out[4];         // state words out
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
    const float* items, const float* quantile, const void* in0,
    const void* in1, const void* in2, const void* in3, void* out0,
    void* out1, void* out2, void* out3, int64_t T, int64_t G, int64_t Q,
    int32_t seed, int32_t t_offset, int32_t g_offset, int32_t s0,
    int32_t s1) {
  FtDenseArgs a;
  a.items = items;
  a.quantile = quantile;
  a.in[0] = (const uint32_t*)in0;
  a.in[1] = (const uint32_t*)in1;
  a.in[2] = (const uint32_t*)in2;
  a.in[3] = (const uint32_t*)in3;
  a.out[0] = (uint32_t*)out0;
  a.out[1] = (uint32_t*)out1;
  a.out[2] = (uint32_t*)out2;
  a.out[3] = (uint32_t*)out3;
  a.T = T;
  a.G = G;
  a.L = G * Q;
  a.Q = Q;
  a.seed = seed;
  a.t_offset = t_offset;
  a.g_offset = g_offset;
  a.s0 = s0;
  a.s1 = s1;
  return a;
}

FT_HD float ft_load(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Unpack lane `lane`'s words, run all T ticks with the state in registers,
// repack and store. The kernel runs this once per thread; the host shim
// once per lane.
template <int FAM>
FT_HD void ft_run_lane(const FtDenseArgs& a, int64_t lane) {
  const float q = a.quantile[lane];
  const int32_t lane_id = ft_i32((uint32_t)a.g_offset + (uint32_t)lane);
  const float* item_p = a.items + lane / a.Q;
  uint32_t t_abs = (uint32_t)a.t_offset;

  float m = 0.0f, step = 1.0f, sign = 1.0f;
  float m2 = 0.0f, step2 = 1.0f, sign2 = 1.0f;
  m = ft_as_float(a.in[0][lane]);
  if (FAM == FT_2U || FAM == FT_2U_DECAY || FAM == FT_2U_WINDOW)
    ft_unpack_step_sign(a.in[1][lane], &step, &sign);
  if (FAM == FT_1U_WINDOW) m2 = ft_as_float(a.in[1][lane]);
  if (FAM == FT_2U_WINDOW) {
    m2 = ft_as_float(a.in[2][lane]);
    ft_unpack_step_sign(a.in[3][lane], &step2, &sign2);
  }
  const float alpha = ft_as_float((uint32_t)a.s0);
  const float floor_ = ft_as_float((uint32_t)a.s1);

#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int64_t i = 0; i < a.T; ++i) {
    const float item = ft_load(item_p);
    item_p += a.G;
    const float u = ft_bits_to_uniform(
        ft_lane_hash(ft_tick_hash(a.seed, ft_i32(t_abs)), lane_id));
    switch (FAM) {
      case FT_1U: ft_tick_1u(m, item, u, q); break;
      case FT_2U: ft_tick_2u(m, step, sign, item, u, q); break;
      case FT_2U_DECAY:
        ft_tick_2u_decay(m, step, sign, item, u, q, alpha, floor_);
        break;
      case FT_1U_WINDOW:
        ft_tick_1u_window(m, m2, item, u, q, ft_i32(t_abs), a.s0);
        break;
      case FT_2U_WINDOW:
        ft_tick_2u_window(m, step, sign, m2, step2, sign2, item, u, q,
                          ft_i32(t_abs), a.s0);
        break;
    }
    t_abs += 1u;
  }

  a.out[0][lane] = ft_as_bits(m);
  if (FAM == FT_2U || FAM == FT_2U_DECAY || FAM == FT_2U_WINDOW)
    a.out[1][lane] = ft_pack_step_sign(step, sign);
  if (FAM == FT_1U_WINDOW) a.out[1][lane] = ft_as_bits(m2);
  if (FAM == FT_2U_WINDOW) {
    a.out[2][lane] = ft_as_bits(m2);
    a.out[3][lane] = ft_pack_step_sign(step2, sign2);
  }
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
