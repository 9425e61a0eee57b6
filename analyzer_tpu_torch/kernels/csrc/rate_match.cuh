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
//
// The math is cut where the kernel splits it across the lanes of a match
// (slot j of the 2T is lane j, team-major: j = k * T + t):
//   1. per slot: slot_gather, then slot_terms (the masked terms it adds to
//      each team-level chain);
//   2. per chain (quality, the shared update, the queue update; each on its
//      own lane): acc_add over the slots' terms IN SLOT ORDER from 0 — team
//      0 then team 1, slot 0..T-1, as the plain version's add chains run —
//      then chain_quality or chain_update;
//   3. per slot: slot_update from its chain's stats, ys_slot, slot_write.
// The host build calls the same functions in that order. Built without FMA
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

// Working-set loads and stores. On the card they go through L2 only
// (ld/st.global.cg): another SM of the cluster wrote the row in the
// previous step, and its L1 holds no copy to go stale.
#ifdef __CUDA_ARCH__
#define RM_LD(p) __ldcg(p)
#define RM_ST(p, v) __stcg((p), (v))
#else
#define RM_LD(p) (*(p))
#define RM_ST(p, v) (*(p) = (v))
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

RM_HD int mode_col(int32_t mode_id) { return (mode_id < 0 ? 0 : mode_id) + 1; }

RM_HD bool ratable(int32_t mode_id, int32_t afk) { return mode_id >= 0 && afk == 0; }

// ---- 1. per slot --------------------------------------------------------

// One slot's priors. A slot is a real player iff its index is not 0 (slot
// 0 is the padding row).
struct Slot {
  float maskf;
  float mu_sh, sigma_sh;  // shared prior (NaN -> seed)
  float mu_q, sigma_q;    // queue prior (NaN -> shared)
  bool had_shared;
};

RM_HD Slot slot_gather(const float* ws, int32_t slot, int col) {
  const float* row = ws + static_cast<int64_t>(slot) * kWidth;
  const float sh_mu = RM_LD(row);
  const float sh_sigma = RM_LD(row + kSigmaLo);
  const float seed_mu = RM_LD(row + kSeedMu);
  const float seed_sigma = RM_LD(row + kSeedSigma);
  const float q_mu = RM_LD(row + col);
  const float q_sigma = RM_LD(row + col + kSigmaLo);
  Slot s;
  s.maskf = slot != 0 ? 1.0f : 0.0f;
  s.had_shared = !(sh_mu != sh_mu);
  s.mu_sh = s.had_shared ? sh_mu : seed_mu;
  s.sigma_sh = s.had_shared ? sh_sigma : seed_sigma;
  const bool had_mode = !(q_mu != q_mu);
  s.mu_q = had_mode ? q_mu : s.mu_sh;
  s.sigma_q = had_mode ? q_sigma : s.sigma_sh;
  return s;
}

// The three team-level chains of a match.
enum Chain { kQuality = 0, kShared = 1, kQueue = 2, kChains = 3 };

// What a slot adds to the chains: the mask (n), the masked mu (team sums;
// the quality and queue chains share the queue prior's) and the masked
// x2 term of each chain (sigma^2 for quality, sigma^2 + tau^2 for the
// updates).
struct Terms {
  float m;
  float mu_q, mu_sh;
  float x2_quality, x2_shared, x2_queue;
};

// Also returns the slot's own sigma^2 + tau^2 of both updates, which its
// slot_update needs after the chains.
RM_HD Terms slot_terms(const Slot& s, Params p, float& s2_sh, float& s2_q) {
  s2_sh = s.sigma_sh * s.sigma_sh + p.tau2;
  s2_q = s.sigma_q * s.sigma_q + p.tau2;
  Terms t;
  t.m = s.maskf;
  t.mu_q = s.mu_q * s.maskf;
  t.mu_sh = s.mu_sh * s.maskf;
  t.x2_quality = (s.sigma_q * s.sigma_q) * s.maskf;
  t.x2_shared = s2_sh * s.maskf;
  t.x2_queue = s2_q * s.maskf;
  return t;
}

// ---- 2. per chain -------------------------------------------------------

// A chain's add chains: n, the x2 sum and each team's mu sum, from 0.
struct Acc {
  float n, x2, mu[2];
};

RM_HD Acc acc_zero() { return Acc{0.0f, 0.0f, {0.0f, 0.0f}}; }

// Adds slot j's terms (team k = j / T) to `chain`'s sums. The caller runs
// j = 0 .. 2T-1 in order.
RM_HD void acc_add(Acc& a, int chain, int k, const Terms& t) {
  const float mu = chain == kShared ? t.mu_sh : t.mu_q;
  const float x2 = chain == kQuality ? t.x2_quality
                   : (chain == kShared ? t.x2_shared : t.x2_queue);
  a.n = a.n + t.m;
  a.x2 = a.x2 + x2;
  a.mu[k] = a.mu[k] + mu;
}

// Match quality from the queue priors (no tau inflation).
RM_HD float chain_quality(const Acc& a, Params p) {
  const float mu_diff = a.mu[0] - a.mu[1];
  const float nb2 = a.n * p.beta2;
  const float denom = clamp_min(nb2 + a.x2, kTiny);
  return sqrtf(nb2 / denom) * expf(-(mu_diff * mu_diff) / (2.0f * denom));
}

// A two-team update's team-level stats.
struct Update {
  float c, c2, v, w;
};

RM_HD float winner_sign(int32_t winner) { return static_cast<float>(1 - 2 * winner); }

RM_HD Update chain_update(const Acc& a, float sign, Params p) {
  const float mu_diff = a.mu[0] - a.mu[1];
  Update u;
  u.c2 = clamp_min(a.x2 + a.n * p.beta2, kTiny);
  u.c = sqrtf(u.c2);
  const float tt = sign * mu_diff / u.c;
  u.v = v_win(tt);
  u.w = w_win(tt, u.v);
  return u;
}

// ---- 3. per slot --------------------------------------------------------

// The four values a ratable match writes per real slot.
struct NewVals {
  float sh_mu, sh_sigma, q_mu, q_sigma;
};

// One slot of one TrueSkill win/loss update; masked slots pass through.
RM_HD void slot_update(float maskf, float mu, float sigma, float s2,
                       float team_sign, const Update& u, float& mu_out,
                       float& sigma_out) {
  if (maskf != 0.0f) {
    mu_out = mu + team_sign * (s2 / u.c) * u.v;
    sigma_out = sqrtf(s2 * (1.0f - (s2 / u.c2) * u.w));
  } else {
    mu_out = mu;
    sigma_out = sigma;
  }
}

// Both updates of slot j (team k) of a match won by `winner`'s sign.
RM_HD NewVals slot_new(const Slot& s, float s2_sh, float s2_q, int k,
                       float sign, const Update& shared, const Update& queue) {
  const float team_sign = sign * (k == 0 ? 1.0f : -1.0f);
  NewVals nv;
  slot_update(s.maskf, s.mu_sh, s.sigma_sh, s2_sh, team_sign, shared, nv.sh_mu, nv.sh_sigma);
  slot_update(s.maskf, s.mu_q, s.sigma_q, s2_q, team_sign, queue, nv.q_mu, nv.q_sigma);
  return nv;
}

// The match-level outputs ys[0..2]: quality, any_afk, updated.
RM_HD void ys_match(float* ys, int32_t mode_id, int32_t afk, float q) {
  const bool rat = ratable(mode_id, afk);
  ys[0] = rat ? q : 0.0f;
  ys[1] = (mode_id >= 0 && afk != 0) ? 1.0f : 0.0f;
  ys[2] = rat ? 1.0f : 0.0f;
}

// Slot j's five outputs (of 2T slots): shared mu, shared sigma, delta,
// mode mu, mode sigma.
RM_HD void ys_slot(float* ys, int j, int n_slots, const Slot& s, const NewVals& nv) {
  float* y = ys + 3 + j;
  y[0] = nv.sh_mu;
  y[n_slots] = nv.sh_sigma;
  y[2 * n_slots] = (s.had_shared && s.maskf != 0.0f)
                       ? (nv.sh_mu - nv.sh_sigma) - (s.mu_sh - s.sigma_sh)
                       : 0.0f;
  y[3 * n_slots] = nv.q_mu;
  y[4 * n_slots] = nv.q_sigma;
}

// A ratable match writes its new shared and mode columns to the row of each
// real slot. Every other column keeps its value (the step is conflict-free
// among ratable matches, so no other match writes these rows), and masked
// slots are not written, which leaves slot 0 pristine.
RM_HD void slot_write(float* ws, int32_t slot, int32_t mode_id, int32_t afk,
                      const NewVals& nv) {
  if (!ratable(mode_id, afk) || slot == 0) return;
  const int col = mode_col(mode_id);
  float* row = ws + static_cast<int64_t>(slot) * kWidth;
  RM_ST(row, nv.sh_mu);
  RM_ST(row + kSigmaLo, nv.sh_sigma);
  RM_ST(row + col, nv.q_mu);
  RM_ST(row + col + kSigmaLo, nv.q_sigma);
}

}  // namespace rm
