// Row scatter into a table in place, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// experiments/scatter_floor.py::pallas_kernel: one call writes R rows into
// an aliased [P, W] float32 table, table[idx[r], :] = rows[r, :], with the
// indices distinct within the call. The Pallas kernel walks the rows with a
// ring of 8 asynchronous row DMAs; this kernel computes the same function
// without a DMA ring.
//
// What bounds it on this card: bytes, not operations — it reads R rows and
// R indices and writes R rows (2*R*W*4 + R*4 bytes, ~0.68 MB at R=5120,
// W=16), which at 3.35 TB/s is a fraction of a microsecond, so a single
// launch is bound in practice by launch latency and by the scattered
// (one 64-byte or 512-byte row per index) write pattern.
// What this design does about it: one thread per 16-byte float4 of a row
// (W/4 threads per row: 4 at W=16, 32 at W=128), so every row is a
// contiguous run of threads doing one coalesced 16-byte load and one
// 16-byte store, and every thread reads its own row's index (a broadcast
// within the row's threads). Distinct indices mean no two threads write the
// same address, so no ordering or atomics are needed inside a launch.
// Launches that write the same rows (a later step of the same table) are
// ordered by the stream they are issued on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC. Plain C entry point for ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(float4* __restrict__ table, const int32_t* __restrict__ idx,
                   const float4* __restrict__ rows, int64_t n_vec,
                   int vec_per_row) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const int64_t r = t / vec_per_row;
  const int64_t c = t - r * vec_per_row;
  const int64_t dst = static_cast<int64_t>(__ldg(idx + r)) * vec_per_row + c;
  table[dst] = __ldg(rows + t);
}

}  // namespace

extern "C" {

// Writes rows [n_rows, width] into table [*, width] at the rows idx
// [n_rows]; width % 4 == 0 and table and rows 16-byte aligned (the wrapper
// checks). Returns the cudaError_t of the launch (0 = success).
int row_scatter_launch(float* table, const int32_t* idx, const float* rows,
                       int64_t n_rows, int width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || width <= 0 || width % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_per_row = width / 4;
  const int64_t n_vec = n_rows * vec_per_row;
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(table), idx,
      reinterpret_cast<const float4*>(rows), n_vec, vec_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
