// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the mask value, fragment packing, and, for the dQ kernel, bf16 tensor-core
// products with mma.sync and the padded shared-memory tile load. The
// loops here assume blocks of kThreads threads (the dQ and fp32 kernels;
// the wgmma kernels use csrc/hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // NEG_INF of ray_tpu/ops/attention.py:16
constexpr int kThreads = 128;      // four warps

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b 16x8 (k-major), fp32 c.
// Lane (g = lane / 4, t = lane % 4) holds a at rows g, g + 8 and columns
// 2t, 2t + 1, 2t + 8, 2t + 9; b at k rows 2t, 2t + 1, 2t + 8, 2t + 9 of
// column g; c at rows g, g + 8 and columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16-row strip from a shared tile of row pitch `pitch`:
// rows r0 and r0 + 8 of the lane, columns k0 + 2t (+ 8).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int pitch, int r0, int k0, int t) {
  const __nv_bfloat16* p = tile + r0 * pitch + k0 + t * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * pitch);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * pitch + 8);
}

// The A fragment of a 16-deep k step made of two neighbouring 8-column
// accumulator tiles (lo, hi), rounded to bf16: c's layout is a's, so a
// product's result feeds the next product without leaving registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_floats(lo[0], lo[1]);
  a[1] = pack_floats(lo[2], lo[3]);
  a[2] = pack_floats(hi[0], hi[1]);
  a[3] = pack_floats(hi[2], hi[3]);
}

// Copies rows [row0, row0 + rows) of one head into a shared tile of row pitch
// DP + 8 (the pad spreads the fragment reads over all banks), 16 bytes a
// thread; zeros past S and past D.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int rows,
                                          int S, int D) {
  constexpr int kPitch = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && c < D) {
      val = *reinterpret_cast<const uint4*>(src + s * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kPitch + c) = val;
  }
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
