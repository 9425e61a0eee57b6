// Host build of the fused window (g++, -ffp-contract=off): the kernel's two
// phases per step from rate_match.cuh, run as a sequential CPU loop — phase
// 1 for every match, then phase 2 for every match — so the arithmetic, the
// gating, the slot routing and the output layout the card runs are tested
// on a CPU against the plain PyTorch window. Only the launch geometry of
// fused_window.cu waits for the card. Used by the tests, never by the
// runners.

#include <stdint.h>

#include <vector>

#include "rate_match.cuh"

namespace {

template <int T>
void run(float* ws, const int32_t* slot_idx, const int32_t* winner,
         const int32_t* mode_id, const int32_t* afk, float* ys, int k_steps,
         int batch, rm::Params p) {
  constexpr int kSlots = 2 * T;
  constexpr int kOut = 3 + 10 * T;
  std::vector<float> scratch(static_cast<size_t>(batch) * kSlots * rm::kNewVals);
  for (int s = 0; s < k_steps; ++s) {
    const int64_t step = static_cast<int64_t>(s) * batch;
    for (int b = 0; b < batch; ++b) {
      const int64_t m = step + b;
      rm::phase1<T>(ws, slot_idx + m * kSlots, winner[m], mode_id[m], afk[m],
                    p, ys == nullptr ? nullptr : ys + m * kOut,
                    scratch.data() + static_cast<size_t>(b) * kSlots * rm::kNewVals);
    }
    for (int b = 0; b < batch; ++b) {
      const int64_t m = step + b;
      rm::phase2<T>(ws, slot_idx + m * kSlots, mode_id[m], afk[m],
                    scratch.data() + static_cast<size_t>(b) * kSlots * rm::kNewVals);
    }
  }
}

}  // namespace

extern "C" int fused_window_host(float* ws, const int32_t* slot_idx,
                                 const int32_t* winner, const int32_t* mode_id,
                                 const int32_t* afk, float* ys, int k_steps,
                                 int batch, int team, float tau2, float beta2) {
  const rm::Params p{tau2, beta2};
  switch (team) {
    case 1: run<1>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, batch, p); return 0;
    case 2: run<2>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, batch, p); return 0;
    case 3: run<3>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, batch, p); return 0;
    case 4: run<4>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, batch, p); return 0;
    case 5: run<5>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, batch, p); return 0;
    default: return 1;
  }
}
