// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the mask value, the block size of the fp32 kernels, bf16 packing and the
// launch helper. The wgmma kernels' pieces are in csrc/hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace flash {

constexpr float kNegInf = -1e30f;  // NEG_INF of ray_tpu/ops/attention.py:16
constexpr int kThreads = 128;      // four warps: the fp32 kernels' blocks

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` on the current
// device, once per (kernel, device) and larger size. Launches after the first
// set nothing: a launch recorded into a CUDA graph must not change a function
// attribute, and the train step's graph records every flash launch.
inline cudaError_t reserve_smem(const void* kernel, int smem) {
  struct Reserved {
    const void* kernel;
    int device;
    int smem;
  };
  static std::mutex mu;
  static std::vector<Reserved> reserved;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  for (Reserved& r : reserved) {
    if (r.kernel != kernel || r.device != device) continue;
    if (smem <= r.smem) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) r.smem = smem;
    return err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) reserved.push_back({kernel, device, smem});
  return err;
}

// Launches `kernel` on `stream` with `smem` bytes of dynamic shared memory
// (reserved once, above); returns the CUDA error of the launch (a refused
// launch never runs, and only this check reports it).
template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const P& p,
                   cudaStream_t stream) {
  cudaError_t err = reserve_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash
