// Host build of frugal_tick.cuh for the CPU tests: the kernels' per-lane
// arithmetic and the dense kernel's tile loop, compiled by g++
// (-ffp-contract=off) and called through ctypes.
// Built by tests/test_torch_kernels.py; not part of the CUDA build.
#include <vector>

#include "frugal_tick.cuh"

// The dense kernel's tiles on the host: each block's threads, one after
// another, through the same plan, tick tables and group body
// (ft_run_group) as on the card. Each tile is staged as the TMA producer
// stages it: rows and columns outside [T, G] read as zeros (no lane reads
// them).
template <int FAM, int LPT>
static void ft_host_dense_blocks(const FtDenseArgs& a, const FtDensePlan& p) {
  std::vector<float> tile((size_t)p.rows * p.cols);
  std::vector<uint32_t> th(p.rows), tw(p.rows);
  std::vector<FtGroup<LPT>> st(p.threads);
  const float alpha = ft_as_float((uint32_t)a.s0);
  const float floor_ = ft_as_float((uint32_t)a.s1);
  for (int64_t b = 0; b < p.blocks; ++b) {
    const int64_t first = b * p.threads;
    const int64_t g0 = ft_tile_col0(p, first, a.Q);
    for (int32_t j = 0; j < p.threads; ++j) {
      const int64_t lane0 = (first + j) * LPT;
      if (lane0 < a.L) ft_group_load<FAM, LPT>(st[j], a, lane0);
    }
    for (int32_t k = 0; k < p.tiles; ++k) {
      const int64_t t0 = (int64_t)k * p.rows;
      for (int32_t r = 0; r < p.rows; ++r)
        for (int32_t c = 0; c < p.cols; ++c)
          tile[ft_tile_index(p, r, c)] =
              (t0 + r < a.T && g0 + c < a.G)
                  ? a.items[(t0 + r) * a.G + g0 + c] : 0.0f;
      for (int32_t i = 0; i < p.rows; ++i)
        ft_fill_tick_tables<FAM>(th.data(), tw.data(), i, a.seed,
                                 (uint32_t)a.t_offset + (uint32_t)t0, a.s0);
      const int32_t n = (int32_t)(a.T - t0 < p.rows ? a.T - t0 : p.rows);
      for (int32_t j = 0; j < p.threads; ++j) {
        const int64_t lane0 = (first + j) * LPT;
        if (lane0 >= a.L) continue;
        const int32_t c = (int32_t)(lane0 / a.Q - g0);
        ft_run_group<FAM, LPT>(st[j], tile.data() + ft_tile_index(p, 0, c),
                               p.box, th.data(), tw.data(), n, alpha,
                               floor_);
      }
    }
    for (int32_t j = 0; j < p.threads; ++j) {
      const int64_t lane0 = (first + j) * LPT;
      if (lane0 < a.L) ft_group_store<FAM, LPT>(st[j], a, lane0);
    }
  }
}

template <int FAM>
static int ft_host_dense_lpt(const FtDenseArgs& a, const FtDensePlan& p) {
  switch (p.lpt) {
    case 1: ft_host_dense_blocks<FAM, 1>(a, p); return 0;
    case 2: ft_host_dense_blocks<FAM, 2>(a, p); return 0;
    case 3: ft_host_dense_blocks<FAM, 3>(a, p); return 0;
    case 4: ft_host_dense_blocks<FAM, 4>(a, p); return 0;
    default: return 1;
  }
}

extern "C" {

void ft_host_counter(int64_t n, const int32_t* seed, const int32_t* t,
                     const int32_t* lane, uint32_t* bits, float* u) {
  for (int64_t i = 0; i < n; ++i) {
    bits[i] = ft_counter_bits(seed[i], t[i], lane[i]);
    u[i] = ft_bits_to_uniform(bits[i]);
  }
}

void ft_host_pack(int64_t n, const float* step, const float* sign,
                  uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = ft_pack_step_sign(step[i], sign[i]);
}

void ft_host_unpack(int64_t n, const uint32_t* packed, float* step,
                    float* sign) {
  for (int64_t i = 0; i < n; ++i)
    ft_unpack_step_sign(packed[i], &step[i], &sign[i]);
}

void ft_host_window_phase(int64_t n, const int32_t* t, int32_t w,
                          uint8_t* reset_a, uint8_t* reset_b) {
  for (int64_t i = 0; i < n; ++i) {
    bool a, b;
    ft_window_phase(t[i], w, a, b);
    reset_a[i] = a;
    reset_b[i] = b;
  }
}

// One tick of `family` over n lanes, in place on six plane arrays (unused
// planes are ignored): planes = (m, step, sign, m2, step2, sign2).
int ft_host_tick(int family, int64_t n, float* m, float* step, float* sign,
                 float* m2, float* step2, float* sign2, const float* item,
                 const float* u, const float* q, int32_t t, int32_t s0,
                 int32_t s1) {
  for (int64_t i = 0; i < n; ++i) {
    switch (family) {
      case FT_1U: ft_tick_1u(m[i], item[i], u[i], q[i]); break;
      case FT_2U: ft_tick_2u(m[i], step[i], sign[i], item[i], u[i], q[i]);
        break;
      case FT_2U_DECAY:
        ft_tick_2u_decay(m[i], step[i], sign[i], item[i], u[i], q[i],
                         ft_as_float((uint32_t)s0), ft_as_float((uint32_t)s1));
        break;
      case FT_1U_WINDOW:
        ft_tick_1u_window(m[i], m2[i], item[i], u[i], q[i], t, s0);
        break;
      case FT_2U_WINDOW:
        ft_tick_2u_window(m[i], step[i], sign[i], m2[i], step2[i], sign2[i],
                          item[i], u[i], q[i], t, s0);
        break;
      default: return 1;
    }
  }
  return 0;
}

// The dense kernel's whole launch (block_g threads a block, tiles at most
// FT_DENSE_TILE_ROWS ticks tall, the state in `format`: FtStateFormat),
// run on the host. Writes the launch's plan to plan_out = {lanes per
// thread, tile rows, tile columns, box columns, tiles, blocks} when it is
// not null.
int ft_host_dense(int family, int32_t format, const float* items,
                  const float* quantile, const void* in0, const void* in1,
                  const void* in2, const void* in3, const void* in4,
                  const void* in5, void* out0, void* out1, void* out2,
                  void* out3, void* out4, void* out5, int64_t T, int64_t G,
                  int64_t Q, int32_t seed, int32_t t_offset, int32_t g_offset,
                  int32_t s0, int32_t s1, int32_t block_g,
                  int64_t* plan_out) {
  if (block_g <= 0 || block_g % 32 != 0 || T <= 0 || G <= 0 || Q <= 0 ||
      (format != FT_STATE_WORDS && format != FT_STATE_PLANES))
    return 1;
  const FtDenseArgs a = ft_dense_args(
      format, items, quantile, in0, in1, in2, in3, in4, in5, out0, out1, out2,
      out3, out4, out5, T, G, Q, seed, t_offset, g_offset, s0, s1);
  const FtDensePlan p = ft_dense_plan(T, G, Q, block_g,
                                      (uint64_t)(uintptr_t)items);
  if (plan_out) {
    const int64_t v[6] = {p.lpt, p.rows, p.cols, p.box, p.tiles, p.blocks};
    for (int i = 0; i < 6; ++i) plan_out[i] = v[i];
  }
  switch (family) {
    case FT_1U: return ft_host_dense_lpt<FT_1U>(a, p);
    case FT_2U: return ft_host_dense_lpt<FT_2U>(a, p);
    case FT_2U_DECAY: return ft_host_dense_lpt<FT_2U_DECAY>(a, p);
    case FT_1U_WINDOW: return ft_host_dense_lpt<FT_1U_WINDOW>(a, p);
    case FT_2U_WINDOW: return ft_host_dense_lpt<FT_2U_WINDOW>(a, p);
    default: return 1;
  }
}

// A tile's tick-hash table for ticks t0 .. t0 + n - 1 (t0 wraps in
// uint32_t), as the kernel fills it.
void ft_host_tick_table(int64_t n, int32_t seed, int32_t t0, uint32_t* th) {
  std::vector<uint32_t> tw(1);
  for (int64_t i = 0; i < n; ++i)
    ft_fill_tick_tables<FT_2U>(th, tw.data(), (int32_t)i, seed,
                               (uint32_t)t0, 0);
}

// The run kernel's whole batch: every run's head walks its run
// (ft_run_lane_events), one run after another, in place on the planes and
// the clock. `mask` may be null (mask = item is not NaN).
int ft_host_scatter(int family, const int32_t* lanes, const float* items,
                    const int32_t* mask, const float* quantile,
                    int32_t q_per_lane, void* p0, void* p1, void* p2,
                    void* p3, void* p4, void* p5, int32_t* ticks, int64_t K,
                    int64_t L, int32_t seed, int32_t g_offset, int32_t s0,
                    int32_t s1) {
  const FtScatterArgs a = ft_scatter_args(lanes, items, mask, quantile,
                                          q_per_lane, p0, p1, p2, p3, p4, p5,
                                          ticks, K, L, seed, g_offset, s0,
                                          s1);
  for (int64_t e = 0; e < a.K; ++e) {
    if (e > 0 && a.lanes[e] == a.lanes[e - 1]) continue;
    switch (family) {
      case FT_1U: ft_run_lane_events<FT_1U>(a, e); break;
      case FT_2U: ft_run_lane_events<FT_2U>(a, e); break;
      case FT_2U_DECAY: ft_run_lane_events<FT_2U_DECAY>(a, e); break;
      case FT_1U_WINDOW: ft_run_lane_events<FT_1U_WINDOW>(a, e); break;
      case FT_2U_WINDOW: ft_run_lane_events<FT_2U_WINDOW>(a, e); break;
      default: return 1;
    }
  }
  return 0;
}

}  // extern "C"
