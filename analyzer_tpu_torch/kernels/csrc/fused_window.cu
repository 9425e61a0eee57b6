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
// What bounds it on this card: not HBM bytes (a window moves a few MB at
// most) nor operations (~460 float32 operations per match), but latency —
// a chain of K dependent steps, each one match's critical path (gather,
// three team-level sums, erff/erfcf/logf/expf chains, per-slot sqrtf and
// divisions) plus the barriers that order the step's reads before its
// writes and its writes before the next step's reads.
// What this design does about it:
//   * ONE THREAD-BLOCK CLUSTER of C CTAs per window (C = 16, a
//     non-portable size, where it fits, else the portable 8; the wrapper
//     picks), launched with cudaLaunchKernelEx; each CTA owns a contiguous
//     share of every step's B matches (a stride loop where B exceeds the
//     CTA's lanes), so a step's matches run on C SMs. Measured on an H100,
//     a window's time falls almost as 1/C up to C = 8: at these batch
//     sizes a step is bound as much by each SM's share of the matches as
//     by latency;
//   * A GROUP OF 2T LANES PER MATCH (at least 3; three groups side by side
//     in a warp at T=5): lane j gathers slot j's row (all slots' loads in
//     flight together) and computes its per-slot terms; the three
//     team-level chains (quality, the shared update, the queue update)
//     each run on their own lane, fed by __shfl_sync and summed in the
//     plain version's order, so the bits do not change; lane j then
//     updates its own slot. New values stay in registers (shared memory
//     for a group's further matches in a step) — no global scratch round
//     trip;
//   * TWO CLUSTER BARRIERS PER STEP (barrier.cluster.arrive.release /
//     wait.acquire): gather, then write. The first is split: each thread
//     arrives after its gathers and waits only before its writes, so the
//     barrier's latency hides behind the match's arithmetic;
//   * the next step's inputs of the CTA are copied into a shared-memory
//     double buffer with cp.async while the current step computes;
//   * the INERT TAIL (steps >= n_steps, window padding that reads only
//     slot 0 and writes nothing) is not looped: without ys it is skipped,
//     with ys its outputs are computed after the loop in one parallel pass
//     without barriers (no step writes after n_steps, so every read sees
//     the final working set, as the plain version's would).
// `ws` (at most 32768 rows x 64 B = 2 MiB) stays in global memory, resident
// in the 50 MB L2 between steps; it is read and written with ld/st.global.cg
// (L2 only) and never through the read-only path, so no SM reads a stale
// L1 line of a row another SM of the cluster wrote in the previous step.
// Keeping ws in distributed shared memory instead would need all 16 CTAs'
// shared memory for a 2 MiB working set and saves one L2 round trip per
// step; it is left out.
//
// Within a step every match reads before any match writes: only RATABLE
// matches of a step are conflict-free, and non-ratable filler matches
// backfilled into the batch may hold a player whom a ratable match of the
// same step updates; their collected outputs must come from the pre-step
// rows, as in the JAX package. Masked slots and non-ratable matches write
// nothing, so slot 0 (the padding row) stays pristine.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC (IEEE sqrt and division are nvcc's
// defaults; never --use_fast_math). Plain C entry points for ctypes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rate_match.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;

// Lanes per match: one per slot, and at least one per team-level chain. A
// warp holds 32 / G such groups side by side (3 at T=5); its last 32 mod G
// lanes are idle.
template <int T>
__host__ __device__ constexpr int lanes_per_match() {
  return 2 * T < 3 ? 3 : 2 * T;
}

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The launch geometry (computed on the host, see Shape).
struct Geometry {
  int k_steps;  // K: steps in the arrays
  int n_steps;  // real steps, looped; the rest are the inert tail
  int batch;    // B
  int mpc;      // matches per CTA per step (the CTA's contiguous share)
  int m_group;  // matches per lane group per step
};

// A CTA's inputs of one step in shared memory: slot_idx [mpc, 2T], then
// winner, mode_id and afk [mpc] each.
template <int T>
__device__ __forceinline__ void stage_inputs(int32_t* dst, int s, int b0,
                                             int count, const Geometry& g,
                                             const int32_t* slot_idx,
                                             const int32_t* winner,
                                             const int32_t* mode_id,
                                             const int32_t* afk) {
  constexpr int kSlots = 2 * T;
  const int64_t m0 = static_cast<int64_t>(s) * g.batch + b0;
  const int32_t* src = slot_idx + m0 * kSlots;
  for (int e = threadIdx.x; e < count * kSlots; e += blockDim.x) {
    __pipeline_memcpy_async(dst + e, src + e, sizeof(int32_t));
  }
  int32_t* sc = dst + g.mpc * kSlots;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    __pipeline_memcpy_async(sc + e, winner + m0 + e, sizeof(int32_t));
    __pipeline_memcpy_async(sc + g.mpc + e, mode_id + m0 + e, sizeof(int32_t));
    __pipeline_memcpy_async(sc + 2 * g.mpc + e, afk + m0 + e, sizeof(int32_t));
  }
  __pipeline_commit();
}

// One match rated by its group of lanes (warp lanes base .. base+G-1),
// from each slot lane's gathered `slot`. Every lane of the warp calls it
// together (the shuffles span the warp); a lane of no active match passes
// zeros and no `ys_row`. Returns the lane's new values (slot lanes only);
// writes the match's outputs to `ys_row` when not null.
template <int T>
__device__ __forceinline__ rm::NewVals lane_rate(const rm::Slot& slot, int lane,
                                                 int base, int32_t winner,
                                                 int32_t mode_id, int32_t afk,
                                                 rm::Params p, float* ys_row) {
  constexpr int kSlots = 2 * T;
  float s2_sh = 0.0f, s2_q = 0.0f;
  rm::Terms mine = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < kSlots) mine = rm::slot_terms(slot, p, s2_sh, s2_q);
  // Lane c < kChains sums chain c's terms in slot order; the other lanes'
  // sums are not used.
  const int chain = lane < rm::kChains ? lane : rm::kQuality;
  rm::Acc acc = rm::acc_zero();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    rm::Terms t;
    t.m = __shfl_sync(kFullWarp, mine.m, base + j);
    t.mu_q = __shfl_sync(kFullWarp, mine.mu_q, base + j);
    t.mu_sh = __shfl_sync(kFullWarp, mine.mu_sh, base + j);
    t.x2_quality = __shfl_sync(kFullWarp, mine.x2_quality, base + j);
    t.x2_shared = __shfl_sync(kFullWarp, mine.x2_shared, base + j);
    t.x2_queue = __shfl_sync(kFullWarp, mine.x2_queue, base + j);
    rm::acc_add(acc, chain, j < T ? 0 : 1, t);
  }
  const float sign = rm::winner_sign(winner);
  float q = 0.0f;
  rm::Update u = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lane == rm::kQuality) {
    q = rm::chain_quality(acc, p);
  } else if (lane < rm::kChains) {
    u = rm::chain_update(acc, sign, p);
  }
  rm::Update shared, queue;
  shared.c = __shfl_sync(kFullWarp, u.c, base + rm::kShared);
  shared.c2 = __shfl_sync(kFullWarp, u.c2, base + rm::kShared);
  shared.v = __shfl_sync(kFullWarp, u.v, base + rm::kShared);
  shared.w = __shfl_sync(kFullWarp, u.w, base + rm::kShared);
  queue.c = __shfl_sync(kFullWarp, u.c, base + rm::kQueue);
  queue.c2 = __shfl_sync(kFullWarp, u.c2, base + rm::kQueue);
  queue.v = __shfl_sync(kFullWarp, u.v, base + rm::kQueue);
  queue.w = __shfl_sync(kFullWarp, u.w, base + rm::kQueue);
  rm::NewVals nv = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < kSlots) {
    nv = rm::slot_new(slot, s2_sh, s2_q, lane < T ? 0 : 1, sign, shared, queue);
    if (ys_row != nullptr) rm::ys_slot(ys_row, lane, kSlots, slot, nv);
  }
  if (ys_row != nullptr && lane == rm::kQuality) rm::ys_match(ys_row, mode_id, afk, q);
  return nv;
}

template <int T>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_window_kernel(float* ws, const int32_t* __restrict__ slot_idx,
                    const int32_t* __restrict__ winner,
                    const int32_t* __restrict__ mode_id,
                    const int32_t* __restrict__ afk, float* __restrict__ ys,
                    Geometry geo, rm::Params p) {
  constexpr int kSlots = 2 * T;
  constexpr int kOut = 3 + 10 * T;
  constexpr int G = lanes_per_match<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_words = geo.mpc * (kSlots + 3);
  int32_t* const in_buf = reinterpret_cast<int32_t*>(smem);  // 2 x in_words
  rm::NewVals* const spill = reinterpret_cast<rm::NewVals*>(
      smem + ((2 * in_words * sizeof(int32_t) + 15) & ~static_cast<size_t>(15)));

  constexpr int kGroupsPerWarp = 32 / G;
  const int lane_in_warp = threadIdx.x & 31;
  const bool in_group = lane_in_warp < kGroupsPerWarp * G;
  const int lane = in_group ? lane_in_warp % G : G;  // an idle lane: no slot, no chain
  const int base = (lane_in_warp / G) * G;  // the group's first lane in the warp
  const int group = (threadIdx.x >> 5) * kGroupsPerWarp + lane_in_warp / G;
  const int gpc = (blockDim.x >> 5) * kGroupsPerWarp;  // lane groups per CTA
  const int b0 = blockIdx.x * geo.mpc;  // this CTA's first match of a step
  const int count = max(0, min(geo.mpc, geo.batch - b0));
  const int m_group = geo.m_group;  // the same on every thread

  if (geo.n_steps > 0) {
    stage_inputs<T>(in_buf, 0, b0, count, geo, slot_idx, winner, mode_id, afk);
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  rm::NewVals nv0 = {0.0f, 0.0f, 0.0f, 0.0f};  // the group's first match
  for (int s = 0; s < geo.n_steps; ++s) {
    if (s > 0) cluster_wait();  // step s-1's writes are visible
    if (s + 1 < geo.n_steps) {
      stage_inputs<T>(in_buf + ((s + 1) & 1) * in_words, s + 1, b0, count, geo,
                      slot_idx, winner, mode_id, afk);
    }
    const int32_t* in_sidx = in_buf + (s & 1) * in_words;
    const int32_t* in_winner = in_sidx + geo.mpc * kSlots;
    const int32_t* in_mode = in_winner + geo.mpc;
    const int32_t* in_afk = in_mode + geo.mpc;
    const int64_t step = static_cast<int64_t>(s) * geo.batch + b0;

    for (int i = 0; i < m_group; ++i) {
      const int bl = group + i * gpc;
      const bool active = in_group && bl < count;
      rm::Slot slot{};
      int32_t win = 0, mode = -1, afk_b = 0;
      if (active) {
        win = in_winner[bl];
        mode = in_mode[bl];
        afk_b = in_afk[bl];
        if (lane < kSlots) {
          slot = rm::slot_gather(ws, in_sidx[bl * kSlots + lane], rm::mode_col(mode));
        }
      }
      // Every gather of step s precedes any write of step s: arrive after
      // the last gather, wait only before the first write.
      if (i == m_group - 1) cluster_arrive();
      const rm::NewVals nv = lane_rate<T>(
          slot, lane, base, win, mode, afk_b, p,
          (active && ys != nullptr) ? ys + (step + bl) * kOut : nullptr);
      if (active && lane < kSlots) {
        if (i == 0) {
          nv0 = nv;
        } else {
          spill[((i - 1) * gpc + group) * kSlots + lane] = nv;
        }
      }
    }
    cluster_wait();
    for (int i = 0; i < m_group; ++i) {
      const int bl = group + i * gpc;
      if (in_group && bl < count && lane < kSlots) {
        rm::slot_write(ws, in_sidx[bl * kSlots + lane], in_mode[bl], in_afk[bl],
                       i == 0 ? nv0 : spill[((i - 1) * gpc + group) * kSlots + lane]);
      }
    }
    __pipeline_wait_prior(0);  // step s+1's inputs have landed
    cluster_arrive();  // step s's writes precede step s+1's gathers
  }
  if (geo.n_steps > 0) cluster_wait();

  // The inert tail's outputs: its steps write nothing, so each match reads
  // the final working set, in any order, with no barrier. Every lane runs
  // the same number of rounds (the shuffles span the warp).
  if (ys == nullptr) return;
  const int64_t tail_begin = static_cast<int64_t>(geo.n_steps) * geo.batch;
  const int64_t tail_end = static_cast<int64_t>(geo.k_steps) * geo.batch;
  const int n_groups = gridDim.x * gpc;
  for (int64_t m0 = tail_begin; m0 < tail_end; m0 += n_groups) {
    const int64_t m = m0 + blockIdx.x * gpc + group;
    const bool active = in_group && m < tail_end;
    rm::Slot slot{};
    int32_t win = 0, mode = -1, afk_b = 0;
    if (active) {
      win = __ldg(winner + m);
      mode = __ldg(mode_id + m);
      afk_b = __ldg(afk + m);
      if (lane < kSlots) {
        slot = rm::slot_gather(ws, __ldg(slot_idx + m * kSlots + lane), rm::mode_col(mode));
      }
    }
    lane_rate<T>(slot, lane, base, win, mode, afk_b, p, active ? ys + m * kOut : nullptr);
  }
}

// The launch shape of one window (the same on every call with these sizes).
struct Shape {
  Geometry geo;
  int threads;
  size_t smem;
};

template <int T>
Shape shape(int k_steps, int n_steps, int batch, int cluster) {
  constexpr int kSlots = 2 * T;
  constexpr int G = lanes_per_match<T>();
  Shape sh;
  sh.geo.k_steps = k_steps;
  sh.geo.n_steps = n_steps;
  sh.geo.batch = batch;
  constexpr int kGroupsPerWarp = 32 / G;
  sh.geo.mpc = (batch + cluster - 1) / cluster;
  int groups = sh.geo.mpc < 1 ? 1 : sh.geo.mpc;
  if (groups > (kMaxThreads / 32) * kGroupsPerWarp) groups = (kMaxThreads / 32) * kGroupsPerWarp;
  const int warps = (groups + kGroupsPerWarp - 1) / kGroupsPerWarp;
  sh.threads = warps * 32;
  const int gpc = warps * kGroupsPerWarp;
  sh.geo.m_group = sh.geo.mpc <= gpc ? 1 : (sh.geo.mpc + gpc - 1) / gpc;
  const size_t in_bytes =
      (2 * static_cast<size_t>(sh.geo.mpc) * (kSlots + 3) * sizeof(int32_t) + 15) & ~static_cast<size_t>(15);
  sh.smem = in_bytes + static_cast<size_t>(sh.geo.m_group - 1) * gpc * kSlots * sizeof(rm::NewVals);
  return sh;
}

template <int T>
cudaError_t configure(const Shape& sh, int cluster, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto kernel = fused_window_kernel<T>;
  if (sh.smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sh.smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster, 1, 1);  // one cluster: one window
  cfg.blockDim = dim3(sh.threads, 1, 1);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int T>
cudaError_t launch(float* ws, const int32_t* slot_idx, const int32_t* winner,
                   const int32_t* mode_id, const int32_t* afk, float* ys,
                   int k_steps, int n_steps, int batch, int cluster,
                   rm::Params p, cudaStream_t stream) {
  const Shape sh = shape<T>(k_steps, n_steps, batch, cluster);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(sh, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, fused_window_kernel<T>, ws, slot_idx, winner,
                            mode_id, afk, ys, sh.geo, p);
}

template <int T>
cudaError_t occupancy(int batch, int cluster, int* n_clusters, int* threads,
                      int* smem) {
  const Shape sh = shape<T>(1, 1, batch, cluster);
  *threads = sh.threads;
  *smem = static_cast<int>(sh.smem);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(sh, cluster, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n_clusters, fused_window_kernel<T>, &cfg);
}

bool valid_cluster(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
}

}  // namespace

extern "C" {

// How many clusters of `cluster` CTAs of this kernel (team size `team`,
// batch `batch`) the card can hold at once, with the CTA's threads and
// dynamic shared memory. 0 clusters means the launch cannot run. Returns
// the cudaError_t of the query (0 = success).
int fused_window_occupancy(int batch, int team, int cluster, int device,
                           int* n_clusters, int* threads, int* smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_cluster(cluster) || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (team) {
    case 1: return static_cast<int>(occupancy<1>(batch, cluster, n_clusters, threads, smem));
    case 2: return static_cast<int>(occupancy<2>(batch, cluster, n_clusters, threads, smem));
    case 3: return static_cast<int>(occupancy<3>(batch, cluster, n_clusters, threads, smem));
    case 4: return static_cast<int>(occupancy<4>(batch, cluster, n_clusters, threads, smem));
    case 5: return static_cast<int>(occupancy<5>(batch, cluster, n_clusters, threads, smem));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Runs one window in place on `ws` as one cluster of `cluster` CTAs: steps
// [0, n_steps) looped, the inert tail [n_steps, k_steps) only for ys. ys
// may be null (no collect). Returns the cudaError_t of the launch (0 =
// success); the caller raises on others.
int fused_window_launch(float* ws, const int32_t* slot_idx,
                        const int32_t* winner, const int32_t* mode_id,
                        const int32_t* afk, float* ys, int k_steps,
                        int n_steps, int batch, int team, int cluster,
                        float tau2, float beta2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_cluster(cluster) || n_steps < 0 || n_steps > k_steps || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rm::Params p{tau2, beta2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (team) {
    case 1: err = launch<1>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, cluster, p, st); break;
    case 2: err = launch<2>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, cluster, p, st); break;
    case 3: err = launch<3>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, cluster, p, st); break;
    case 4: err = launch<4>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, cluster, p, st); break;
    case 5: err = launch<5>(ws, slot_idx, winner, mode_id, afk, ys, k_steps, n_steps, batch, cluster, p, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
