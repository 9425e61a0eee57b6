// Row scatter into a table in place, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// experiments/scatter_floor.py::pallas_kernel, run as its harness runs it: a
// scan over S steps, step s writing R rows into an aliased [P, W] float32
// table, table[idx[s, r], :] = rows[s, r, :], with the indices distinct
// within a step. Steps apply in order, so where two steps write one row
// (steps s and s + 8 do, in the harness) the later step's row wins.
//
// What bounds it on this card: bytes, not operations — a step reads R rows
// and R indices and writes R rows (2*R*W*4 + R*4 bytes, ~0.68 MB at R=5120,
// W=16), which at 3.35 TB/s is a fraction of a microsecond. That is far
// below what a launch costs: a launch from Python takes ~20 us of host
// time, and a step of 20,480 float4 copies (W=16) fills under one wave of
// the 132 SMs, so a launch of one step is launch latency and a tail.
// What this design does about it: ONE COOPERATIVE LAUNCH for a run of S
// steps (cudaLaunchCooperativeKernel), its grid no larger than what the
// card holds resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs; the wrapper refuses a larger grid before launching). Each block
// grid-strides over a step's R*W/4 float4 copies — one thread per 16-byte
// float4 of a row, a coalesced 16-byte load and store each, every thread
// reading its row's index — and cooperative_groups::this_grid().sync()
// separates consecutive steps, because steps s and s + 8 write the same
// rows. A thread loads its first copy of step s+1 (the rows and indices
// are never written) before the barrier, so the load's latency overlaps
// it. The floor of a step is then the grid barrier plus the step's bytes;
// the byte bound stays out of reach by the barrier.
//
// The steps are NOT collapsed into one "last writer wins" pass (an
// atomicMax of the step number per row, then only the surviving rows
// written). That is exact for this harness, whose rows do not depend on
// earlier steps, but it measures nothing about a superstep's scatter: in
// the system each step's rows are computed from the step before, so every
// step's scatter has to land before the next step reads.
//
// row_scatter (one step) is the S = 1 case of the same kernel.
//
// Drop mode (drop != 0): an entry whose index lies outside [0, n_table)
// writes nothing, as XLA's scatter with mode="drop" does; the sharded
// re-rate pads each shard's compacted row list with such entries. The
// branch skips the store only: every thread still reaches the grid barrier
// between steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC. Plain C entry points for ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// Copy t of a step (0 <= t < n_vec): the float4 it reads and where it goes;
// dst is -1 where drop mode skips the entry (its index is out of range).
__device__ __forceinline__ void copy_src(const int32_t* __restrict__ idx,
                                         const float4* __restrict__ rows,
                                         int64_t t, int vec_per_row,
                                         int64_t n_table, int drop,
                                         float4& v, int64_t& dst) {
  const int64_t r = t / vec_per_row;
  const int64_t c = t - r * vec_per_row;
  const int64_t row = static_cast<int64_t>(__ldg(idx + r));
  dst = (drop && (row < 0 || row >= n_table)) ? -1 : row * vec_per_row + c;
  v = __ldg(rows + t);
}

__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(float4* __restrict__ table, const int32_t* __restrict__ idx,
                   const float4* __restrict__ rows, int n_steps, int64_t n_rows,
                   int vec_per_row, int64_t n_table, int drop) {
  const int64_t n_vec = n_rows * vec_per_row;  // float4 copies per step
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 v;
  int64_t dst = -1;
  if (t0 < n_vec) copy_src(idx, rows, t0, vec_per_row, n_table, drop, v, dst);
  for (int s = 0; s < n_steps; ++s) {
    const int32_t* step_idx = idx + static_cast<int64_t>(s) * n_rows;
    const float4* step_rows = rows + static_cast<int64_t>(s) * n_vec;
    if (t0 < n_vec && dst >= 0) table[dst] = v;
    for (int64_t t = t0 + stride; t < n_vec; t += stride) {
      float4 u;
      int64_t d;
      copy_src(step_idx, step_rows, t, vec_per_row, n_table, drop, u, d);
      if (d >= 0) table[d] = u;
    }
    if (s + 1 < n_steps) {
      if (t0 < n_vec) {
        copy_src(step_idx + n_rows, step_rows + n_vec, t0, vec_per_row, n_table,
                 drop, v, dst);
      }
      cg::this_grid().sync();  // step s's writes land before step s+1's
    }
  }
}

}  // namespace

extern "C" {

// The most blocks of the kernel the card holds resident at once: blocks per
// SM at kThreads threads, times the SMs. Returns the cudaError_t of the
// query (0 = success); cudaErrorNotSupported where the device cannot launch
// cooperatively.
int row_scatter_max_blocks(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_scatter_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

// Applies S steps in order: rows [S, n_rows, width] into table
// [n_table, width] at the rows idx [S, n_rows], as one cooperative launch
// of `blocks` blocks (at most row_scatter_max_blocks); with drop != 0 an
// index outside [0, n_table) writes nothing. width % 4 == 0 and table and
// rows 16-byte aligned (the wrapper checks). Returns the cudaError_t of
// the launch (0 = success).
int row_scatter_launch(float* table, const int32_t* idx, const float* rows,
                       int n_steps, int64_t n_rows, int width, int blocks,
                       int device, void* stream, int64_t n_table, int drop) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_steps <= 0 || n_rows <= 0 || width <= 0 || width % 4 != 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float4* table4 = reinterpret_cast<float4*>(table);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  int vec_per_row = width / 4;
  void* args[] = {&table4, &idx, &rows4, &n_steps, &n_rows, &vec_per_row,
                  &n_table, &drop};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(row_scatter_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
