// The fused rating window, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// analyzer_tpu/core/fused.py::_pallas_window: K dependent conflict-free
// supersteps run against a working set `ws` [n_slots, 16] of the window's
// touched player rows (gathered from the table once before the launch and
// written back once after it, by the caller). Step s gathers
// ws[slot_idx[s]], rates every match (rate_match.cuh), writes the updated
// rows of ratable matches' real slots, and with `ys` writes the packed
// per-match outputs ys[s] [B, 3 + 10T].
//
// What bounds it on this card: not HBM bytes (a window moves well under a
// megabyte) but latency — a chain of K dependent steps, each a few hundred
// dependent float32 operations per match with transcendentals, and B
// independent matches per step (about 500 on the 10M-match history).
// What this design does about it: ONE thread block per window, one thread
// per match (a stride loop when B exceeds the block), the K steps looped
// inside the kernel with __syncthreads() between them — one launch per
// window instead of one per step, and the working set (at most 32768 rows x
// 64 B = 2 MiB) stays resident in the 50 MB L2 between steps. It uses one SM
// of 132: deliberate for a first, correct kernel of a dependent chain of
// narrow steps.
//
// Within a step every match reads before any match writes (phase 1, barrier,
// phase 2): only RATABLE matches of a step are conflict-free, and
// non-ratable filler matches backfilled into the batch may hold a player
// whom a ratable match of the same step updates; their collected outputs
// must come from the pre-step rows, as in the JAX package. New values wait
// in `scratch` [B, 2T, 4] between the phases. Masked slots and non-ratable
// matches write nothing, so slot 0 (the padding row) stays pristine — the
// re-pin of the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC (IEEE sqrt and division are nvcc's
// defaults; never --use_fast_math). Plain C entry point for ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rate_match.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <int T>
__global__ void __launch_bounds__(kMaxThreads)
fused_window_kernel(float* ws, const int32_t* __restrict__ slot_idx,
                    const int32_t* __restrict__ winner,
                    const int32_t* __restrict__ mode_id,
                    const int32_t* __restrict__ afk, float* ys,
                    float* scratch, int k_steps, int batch, rm::Params p) {
  constexpr int kSlots = 2 * T;
  constexpr int kOut = 3 + 10 * T;
  for (int s = 0; s < k_steps; ++s) {
    const int64_t step = static_cast<int64_t>(s) * batch;
    for (int b = threadIdx.x; b < batch; b += blockDim.x) {
      const int64_t m = step + b;
      rm::phase1<T>(ws, slot_idx + m * kSlots, winner[m], mode_id[m], afk[m],
                    p, ys == nullptr ? nullptr : ys + m * kOut,
                    scratch + static_cast<int64_t>(b) * kSlots * rm::kNewVals);
    }
    __syncthreads();  // every gather of step s precedes any write of step s
    for (int b = threadIdx.x; b < batch; b += blockDim.x) {
      const int64_t m = step + b;
      rm::phase2<T>(ws, slot_idx + m * kSlots, mode_id[m], afk[m],
                    scratch + static_cast<int64_t>(b) * kSlots * rm::kNewVals);
    }
    __syncthreads();  // step s's writes are visible to step s + 1's gathers
  }
}

template <int T>
void launch(float* ws, const int32_t* slot_idx, const int32_t* winner,
            const int32_t* mode_id, const int32_t* afk, float* ys,
            float* scratch, int k_steps, int batch, rm::Params p,
            cudaStream_t stream) {
  int threads = ((batch + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  fused_window_kernel<T><<<1, threads, 0, stream>>>(
      ws, slot_idx, winner, mode_id, afk, ys, scratch, k_steps, batch, p);
}

}  // namespace

extern "C" {

// Runs one window in place on `ws`. ys may be null (no collect). Returns
// the cudaError_t of the launch (0 = success); the caller raises on others.
int fused_window_launch(float* ws, const int32_t* slot_idx,
                        const int32_t* winner, const int32_t* mode_id,
                        const int32_t* afk, float* ys, float* scratch,
                        int k_steps, int batch, int team, float tau2,
                        float beta2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rm::Params p{tau2, beta2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (team) {
    case 1: launch<1>(ws, slot_idx, winner, mode_id, afk, ys, scratch, k_steps, batch, p, st); break;
    case 2: launch<2>(ws, slot_idx, winner, mode_id, afk, ys, scratch, k_steps, batch, p, st); break;
    case 3: launch<3>(ws, slot_idx, winner, mode_id, afk, ys, scratch, k_steps, batch, p, st); break;
    case 4: launch<4>(ws, slot_idx, winner, mode_id, afk, ys, scratch, k_steps, batch, p, st); break;
    case 5: launch<5>(ws, slot_idx, winner, mode_id, afk, ys, scratch, k_steps, batch, p, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
