// Per-match rating math shared by the CUDA fused-window kernel
// (fused_window.cu, nvcc for sm_90a) and its host build (fused_window_host.cc,
// g++), so the arithmetic the card runs is also differential-tested on a CPU.
//
// It mirrors analyzer_tpu_torch.core.update.rate_gathered over
// analyzer_tpu_torch.ops.trueskill / ops.normal operation for operation:
//   * the one-hot mode column (mode -1 clamps to column 1; such matches never
//     write), had_mode from mu only;
//   * NaN -> seed for the shared prior, mode -> shared for the queue prior;
//   * quality from the queue priors; two two-team updates (shared, queue);
//   * delta only where had_shared & mask;
//   * the pack_outputs layout [3 + 10T]: quality, any_afk, updated, then
//     shared_mu, shared_sigma, delta, mode_mu, mode_sigma, each [2][T].
// Team sums are add chains from 0, team 0 then team 1, slot 0..T-1, over
// masked terms x * maskf, as in the plain version. Built without FMA
// contraction (--fmad=false / -ffp-contract=off) and with IEEE sqrtf and
// division, never with fast math: NaN marks a never-rated player.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RM_HD __host__ __device__ __forceinline__
#else
#define RM_HD inline
#endif

namespace rm {

// Packed-table layout (core/state.py): mu cols 0..6, sigma cols 7..13,
// seed mu 14, seed sigma 15.
constexpr int kWidth = 16;
constexpr int kSigmaLo = 7;
constexpr int kSeedMu = 14;
constexpr int kSeedSigma = 15;

// The float32 constants of ops/normal.py and ops/trueskill.py.
constexpr float kLogSqrt2Pi = 0.9189385332046727f;
constexpr float kHalfSqrt2 = 0.5f * 1.41421356237309504880f;
constexpr float kTiny = 1e-20f;
constexpr float kLower = -10.0f;
constexpr float kUpper = 5.0f;

struct Params {
  float tau2;
  float beta2;
};

// torch.clamp(x, min=lo): NaN propagates.
RM_HD float clamp_min(float x, float lo) { return (x != x || x > lo) ? x : lo; }

// torch.clamp(x, 0, 1): NaN propagates.
RM_HD float clamp01(float x) {
  if (x != x) return x;
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Phi(x) as jax.scipy.special.ndtr.
RM_HD float ndtr(float x) {
  const float w = x * kHalfSqrt2;
  const float z = fabsf(w);
  const float y = z < kHalfSqrt2
                      ? 1.0f + erff(w)
                      : (w > 0.0f ? 2.0f - erfcf(z) : erfcf(z));
  return 0.5f * y;
}

// Asymptotic series for log Phi(x), x <= -10 (series order 3).
RM_HD float log_ndtr_lower(float x) {
  const float x2 = x * x;
  const float log_scale = -0.5f * x2 - logf(-x) - kLogSqrt2Pi;
  float odd = 1.0f / x2;
  const float x4 = x2 * x2;
  const float even = 3.0f / x4;
  odd = odd + 15.0f / (x4 * x2);
  return log_scale + logf(1.0f + even - odd);
}

// log Phi(x) by JAX's float32 formula (segments at -10 and 5).
RM_HD float log_ndtr(float x) {
  if (x > kUpper) return -ndtr(-x);
  if (x > kLower) return logf(ndtr(x));
  return log_ndtr_lower(x);
}

RM_HD float v_win(float t) {
  return expf((-0.5f * t * t - kLogSqrt2Pi) - log_ndtr(t));
}

RM_HD float w_win(float t, float v) {
  if (t <= kLower) {
    const float t2 = t * t;
    return 1.0f - 1.0f / t2 + 6.0f / (t2 * t2);
  }
  return clamp01(v * (v + t));
}

// (n, sum of x2 over real slots, team-0 minus team-1 mu) as add chains.
template <int T>
RM_HD void masked_sum_stats(const float (&mu)[2][T], const float (&x2)[2][T],
                            const float (&maskf)[2][T], float& n,
                            float& x2_sum, float& mu_diff) {
  n = 0.0f;
  x2_sum = 0.0f;
  float team_mu[2] = {0.0f, 0.0f};
  for (int k = 0; k < 2; ++k) {
    for (int t = 0; t < T; ++t) {
      n = n + maskf[k][t];
      x2_sum = x2_sum + x2[k][t] * maskf[k][t];
      team_mu[k] = team_mu[k] + mu[k][t] * maskf[k][t];
    }
  }
  mu_diff = team_mu[0] - team_mu[1];
}

// One TrueSkill win/loss update; masked slots pass through unchanged.
template <int T>
RM_HD void two_team_update(const float (&mu)[2][T], const float (&sigma)[2][T],
                           const float (&maskf)[2][T], int winner, Params p,
                           float (&mu_out)[2][T], float (&sigma_out)[2][T]) {
  float s2[2][T];
  for (int k = 0; k < 2; ++k)
    for (int t = 0; t < T; ++t) s2[k][t] = sigma[k][t] * sigma[k][t] + p.tau2;
  float n, s2_sum, mu_diff;
  masked_sum_stats<T>(mu, s2, maskf, n, s2_sum, mu_diff);
  const float c2 = clamp_min(s2_sum + n * p.beta2, kTiny);
  const float c = sqrtf(c2);
  const float sign = static_cast<float>(1 - 2 * winner);
  const float tt = sign * mu_diff / c;
  const float v = v_win(tt);
  const float w = w_win(tt, v);
  for (int k = 0; k < 2; ++k) {
    const float team_sign = sign * (k == 0 ? 1.0f : -1.0f);
    for (int t = 0; t < T; ++t) {
      if (maskf[k][t] != 0.0f) {
        mu_out[k][t] = mu[k][t] + team_sign * (s2[k][t] / c) * v;
        sigma_out[k][t] = sqrtf(s2[k][t] * (1.0f - (s2[k][t] / c2) * w));
      } else {
        mu_out[k][t] = mu[k][t];
        sigma_out[k][t] = sigma[k][t];
      }
    }
  }
}

// Match quality from the priors (no tau inflation).
template <int T>
RM_HD float quality(const float (&mu)[2][T], const float (&sigma)[2][T],
                    const float (&maskf)[2][T], Params p) {
  float sg2[2][T];
  for (int k = 0; k < 2; ++k)
    for (int t = 0; t < T; ++t) sg2[k][t] = sigma[k][t] * sigma[k][t];
  float n, s2_sum, mu_diff;
  masked_sum_stats<T>(mu, sg2, maskf, n, s2_sum, mu_diff);
  const float nb2 = n * p.beta2;
  const float denom = clamp_min(nb2 + s2_sum, kTiny);
  return sqrtf(nb2 / denom) * expf(-(mu_diff * mu_diff) / (2.0f * denom));
}

// The four values a ratable match writes per real slot, in this order.
enum { kNewShMu = 0, kNewShSigma = 1, kNewQMu = 2, kNewQSigma = 3, kNewVals = 4 };

RM_HD int mode_col(int32_t mode_id) { return (mode_id < 0 ? 0 : mode_id) + 1; }

RM_HD bool ratable(int32_t mode_id, int32_t afk) { return mode_id >= 0 && afk == 0; }

// Phase 1 of one superstep for one match: gather the match's 2T slot rows
// from the working set `ws` (slot 0 is the padding row; a slot is a real
// player iff its index is not 0), rate, write the packed outputs to `ys`
// (when not null) and the new values to `scratch` ([2][T][kNewVals]).
// Reads `ws` only: every match of a step must finish this phase before any
// match of the step writes (phase2).
template <int T>
RM_HD void phase1(const float* ws, const int32_t* sidx, int32_t winner,
                  int32_t mode_id, int32_t afk, Params p, float* ys,
                  float* scratch) {
  const int col = mode_col(mode_id);
  float maskf[2][T], mu_sh[2][T], sigma_sh[2][T], mu_q[2][T], sigma_q[2][T];
  bool had_shared[2][T];
  for (int k = 0; k < 2; ++k) {
    for (int t = 0; t < T; ++t) {
      const int32_t slot = sidx[k * T + t];
      const float* row = ws + static_cast<int64_t>(slot) * kWidth;
      maskf[k][t] = slot != 0 ? 1.0f : 0.0f;
      const float sh_mu = row[0];
      had_shared[k][t] = !(sh_mu != sh_mu);
      mu_sh[k][t] = had_shared[k][t] ? sh_mu : row[kSeedMu];
      sigma_sh[k][t] = had_shared[k][t] ? row[kSigmaLo] : row[kSeedSigma];
      const float q_mu = row[col];
      const bool had_mode = !(q_mu != q_mu);
      mu_q[k][t] = had_mode ? q_mu : mu_sh[k][t];
      sigma_q[k][t] = had_mode ? row[col + kSigmaLo] : sigma_sh[k][t];
    }
  }
  float new_sh_mu[2][T], new_sh_sigma[2][T], new_q_mu[2][T], new_q_sigma[2][T];
  const float q = quality<T>(mu_q, sigma_q, maskf, p);
  two_team_update<T>(mu_sh, sigma_sh, maskf, winner, p, new_sh_mu, new_sh_sigma);
  two_team_update<T>(mu_q, sigma_q, maskf, winner, p, new_q_mu, new_q_sigma);

  for (int k = 0; k < 2; ++k) {
    for (int t = 0; t < T; ++t) {
      float* sc = scratch + (k * T + t) * kNewVals;
      sc[kNewShMu] = new_sh_mu[k][t];
      sc[kNewShSigma] = new_sh_sigma[k][t];
      sc[kNewQMu] = new_q_mu[k][t];
      sc[kNewQSigma] = new_q_sigma[k][t];
    }
  }
  if (ys == nullptr) return;
  const bool rat = ratable(mode_id, afk);
  ys[0] = rat ? q : 0.0f;
  ys[1] = (mode_id >= 0 && afk != 0) ? 1.0f : 0.0f;
  ys[2] = rat ? 1.0f : 0.0f;
  constexpr int kBlock = 2 * T;
  for (int k = 0; k < 2; ++k) {
    for (int t = 0; t < T; ++t) {
      const int i = 3 + k * T + t;
      ys[i] = new_sh_mu[k][t];
      ys[i + kBlock] = new_sh_sigma[k][t];
      ys[i + 2 * kBlock] =
          (had_shared[k][t] && maskf[k][t] != 0.0f)
              ? (new_sh_mu[k][t] - new_sh_sigma[k][t]) - (mu_sh[k][t] - sigma_sh[k][t])
              : 0.0f;
      ys[i + 3 * kBlock] = new_q_mu[k][t];
      ys[i + 4 * kBlock] = new_q_sigma[k][t];
    }
  }
}

// Phase 2 of one superstep for one match: a ratable match writes its new
// shared and mode columns to the rows of its real slots. Every other column
// keeps its value (the step is conflict-free among ratable matches, so no
// other match writes these rows), and masked slots are simply not written,
// which leaves slot 0 pristine.
template <int T>
RM_HD void phase2(float* ws, const int32_t* sidx, int32_t mode_id, int32_t afk,
                  const float* scratch) {
  if (!ratable(mode_id, afk)) return;
  const int col = mode_col(mode_id);
  for (int j = 0; j < 2 * T; ++j) {
    const int32_t slot = sidx[j];
    if (slot == 0) continue;
    float* row = ws + static_cast<int64_t>(slot) * kWidth;
    const float* sc = scratch + j * kNewVals;
    row[0] = sc[kNewShMu];
    row[kSigmaLo] = sc[kNewShSigma];
    row[col] = sc[kNewQMu];
    row[col + kSigmaLo] = sc[kNewQSigma];
  }
}

}  // namespace rm
