// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the mask value, the block size of the fp32 kernels, bf16 packing and the
// launch helper. The wgmma kernels' pieces are in csrc/hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // NEG_INF of ray_tpu/ops/attention.py:16
constexpr int kThreads = 128;      // four warps: the fp32 kernels' blocks

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sets the kernel's dynamic shared memory and launches it on `stream`;
// returns the CUDA error of the launch (a refused launch never runs, and only
// this check reports it).
template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const P& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash
