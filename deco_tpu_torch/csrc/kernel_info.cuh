// The runtime's view of one compiled kernel, for the `*_info` C entries.
#pragma once

#include <cuda_runtime.h>

namespace deco {

// Registers, local (spill) bytes, static and dynamic shared memory, resident
// CTAs per SM and threads of `kernel` launched with `threads` threads and
// `smem` bytes of dynamic shared memory, into out[0..5].
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = smem;
  out[4] = ctas;
  out[5] = threads;
  return cudaSuccess;
}

}  // namespace deco
