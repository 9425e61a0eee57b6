// Host build of the fused window (g++, -ffp-contract=off): the functions of
// rate_match.cuh that the kernel's lanes call, run as a sequential CPU loop
// in lane order — for every match of a step its slots, then its three
// team-level chains, then its slot updates and outputs; then every write of
// the step — and the inert tail's outputs after the looped steps, as the
// kernel runs them. So the arithmetic, the gating, the slot routing, the
// output layout and the n_steps split the card runs are tested on a CPU
// against the plain PyTorch window. Only the launch geometry of
// fused_window.cu waits for the card. Used by the tests, never by the
// runners.

#include <stdint.h>

#include <vector>

#include "rate_match.cuh"

namespace {

// One match in lane order; returns its new values per slot in `nv`.
template <int T>
void rate_match(const float* ws, const int32_t* sidx, int32_t winner,
                int32_t mode_id, int32_t afk, rm::Params p, float* ys,
                rm::NewVals* nv) {
  constexpr int kSlots = 2 * T;
  const int col = rm::mode_col(mode_id);
  rm::Slot slot[kSlots];
  rm::Terms terms[kSlots];
  float s2_sh[kSlots], s2_q[kSlots];
  for (int j = 0; j < kSlots; ++j) {  // the slot lanes
    slot[j] = rm::slot_gather(ws, sidx[j], col);
    terms[j] = rm::slot_terms(slot[j], p, s2_sh[j], s2_q[j]);
  }
  rm::Acc acc[rm::kChains];
  for (int c = 0; c < rm::kChains; ++c) {  // the chain lanes
    acc[c] = rm::acc_zero();
    for (int j = 0; j < kSlots; ++j) rm::acc_add(acc[c], c, j / T, terms[j]);
  }
  const float sign = rm::winner_sign(winner);
  const float q = rm::chain_quality(acc[rm::kQuality], p);
  const rm::Update shared = rm::chain_update(acc[rm::kShared], sign, p);
  const rm::Update queue = rm::chain_update(acc[rm::kQueue], sign, p);
  for (int j = 0; j < kSlots; ++j) {  // the slot lanes
    nv[j] = rm::slot_new(slot[j], s2_sh[j], s2_q[j], j / T, sign, shared, queue);
    if (ys != nullptr) rm::ys_slot(ys, j, kSlots, slot[j], nv[j]);
  }
  if (ys != nullptr) rm::ys_match(ys, mode_id, afk, q);
}

template <int T>
void run(float* ws, const int32_t* slot_idx, const int32_t* winner,
         const int32_t* mode_id, const int32_t* afk, float* ys, int k_steps,
         int n_steps, int batch, rm::Params p) {
  constexpr int kSlots = 2 * T;
  constexpr int kOut = 3 + 10 * T;
  std::vector<rm::NewVals> nv(static_cast<size_t>(batch) * kSlots);
  for (int s = 0; s < n_steps; ++s) {
    const int64_t step = static_cast<int64_t>(s) * batch;
    for (int b = 0; b < batch; ++b) {  // every gather of the step ...
      const int64_t m = step + b;
      rate_match<T>(ws, slot_idx + m * kSlots, winner[m], mode_id[m], afk[m],
                    p, ys == nullptr ? nullptr : ys + m * kOut,
                    nv.data() + static_cast<size_t>(b) * kSlots);
    }
    for (int b = 0; b < batch; ++b) {  // ... precedes any write
      const int64_t m = step + b;
      for (int j = 0; j < kSlots; ++j) {
        rm::slot_write(ws, slot_idx[m * kSlots + j], mode_id[m], afk[m],
                       nv[static_cast<size_t>(b) * kSlots + j]);
      }
    }
  }
  if (ys == nullptr) return;
  // The inert tail: outputs only, no writes.
  for (int64_t m = static_cast<int64_t>(n_steps) * batch;
       m < static_cast<int64_t>(k_steps) * batch; ++m) {
    rate_match<T>(ws, slot_idx + m * kSlots, winner[m], mode_id[m], afk[m], p,
                  ys + m * kOut, nv.data());
  }
}

}  // namespace

extern "C" int fused_window_host(float* ws, const int32_t* slot_idx,
                                 const int32_t* winner, const int32_t* mode_id,
                                 const int32_t* afk, float* ys, int k_steps,
                                 int n_steps, int batch, int team, float tau2,
                                 float beta2) {
  const rm::Params p{tau2, beta2};
  switch (team) {
    case 1: run<1>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, p); return 0;
    case 2: run<2>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, p); return 0;
    case 3: run<3>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, p); return 0;
    case 4: run<4>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, p); return 0;
    case 5: run<5>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, p); return 0;
    default: return 1;
  }
}
