// A kernel's run counter: a __device__ array of counts that block 0 of every
// launch adds one to.  It counts what ran on the device, so the launches of a
// CUDA-graph replay, which calls no host entry, are counted as well.  The
// host reads it (read_runs) only after the device has finished its work.
// Included by the .cu sources; CUDA only.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void count_run(unsigned long long* counter) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(counter, 1ull);
}

// Waits for every stream of `device`, copies the counts of `counter` into
// out and, where `reset`, sets them to 0.  Returns the first CUDA error.
template <size_t N>
cudaError_t read_runs(const unsigned long long (&counter)[N], int device, int reset,
                      unsigned long long* out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, counter, sizeof(counter));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[N] = {};
    err = cudaMemcpyToSymbol(counter, zero, sizeof(counter));
  }
  const cudaError_t restored = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restored;
}
