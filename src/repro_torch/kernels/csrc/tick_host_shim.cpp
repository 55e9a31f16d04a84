// Host build of frugal_tick.cuh for the CPU tests: the kernel's per-lane
// arithmetic, compiled by g++ (-ffp-contract=off) and called through ctypes.
// Built by tests/test_torch_kernels.py; not part of the CUDA build.
#include "frugal_tick.cuh"

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

// The kernel's whole per-lane program, run for every lane in turn.
int ft_host_dense(int family, const float* items, const float* quantile,
                  const void* in0, const void* in1, const void* in2,
                  const void* in3, void* out0, void* out1, void* out2,
                  void* out3, int64_t T, int64_t G, int64_t Q, int32_t seed,
                  int32_t t_offset, int32_t g_offset, int32_t s0, int32_t s1) {
  const FtDenseArgs a = ft_dense_args(items, quantile, in0, in1, in2, in3,
                                      out0, out1, out2, out3, T, G, Q, seed,
                                      t_offset, g_offset, s0, s1);
  for (int64_t lane = 0; lane < a.L; ++lane) {
    switch (family) {
      case FT_1U: ft_run_lane<FT_1U>(a, lane); break;
      case FT_2U: ft_run_lane<FT_2U>(a, lane); break;
      case FT_2U_DECAY: ft_run_lane<FT_2U_DECAY>(a, lane); break;
      case FT_1U_WINDOW: ft_run_lane<FT_1U_WINDOW>(a, lane); break;
      case FT_2U_WINDOW: ft_run_lane<FT_2U_WINDOW>(a, lane); break;
      default: return 1;
    }
  }
  return 0;
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
