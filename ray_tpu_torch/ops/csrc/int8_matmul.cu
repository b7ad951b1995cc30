// Int8 weight-only matrix product for Hopper (sm_90a), bound to Python with
// ctypes.
//
// y[m, n] = sum_k x[m, k] * w[k, n], w = q.to(x.dtype) * s.to(x.dtype): x is
// [M, K] bf16 or fp32, q is [K, N] int8 read as stored (row-major), s holds N
// fp32 scales, one per output column, and y is [M, N] in x's dtype.
//
// Replaces no Pallas kernel: the reference dequantizes inside the consuming
// matmul's XLA fusion (QTensor.astype, ray_tpu/models/quant.py:43-44, feeding
// the six weight einsums of ray_tpu/models/transformer.py:300-327), so its
// decode streams the int8 bytes only. Without this kernel the port wrote a
// bf16 copy of every weight and read it back before each product.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16). Decoding 8
// slots, a weight's bytes dominate: 16.8 MB of int8 for a 4096 x 4096 weight
// (5.0 us), 67.1 MB for a 4096 x 16384 MLP weight (20.0 us); a serve_7b decode
// step reads 6.44 GB of them, 1.92 ms. So the design streams q (and x)
// through shared memory with cp.async, which holds no registers while the
// copies are in flight:
//
// - A block owns 32 output columns and 16 * MT rows of x (MT 1, 2 or 4 by M),
//   and its warps split K into equal contiguous ranges (8 warps where K / 64
//   allows, else 4, 2 or 1: the split depends on K alone). Each warp streams
//   its range in stages of 64 k rows through a two-stage ring of its own in
//   shared memory (one stage copied while the other is computed): a stage is
//   the q tile [64, 32] and the x tile [16 MT, 64], copied with 16-byte
//   cp.async, rows of x past M zero-filled. At MT 1 a block's ring is 86 KB,
//   so two blocks share an SM (deeper rings, one block per SM, were no
//   faster at N 4096 and slower at N 16384, where they ran in four waves).
//   Rows are padded (q to 48 bytes, x to 144) so that the fragment loads
//   below hit 32 distinct banks.
// - bf16 tensor cores through mma.sync m16n8k16. A thread's 32-bit word of a
//   q row holds columns 4g..4g+3 of the block (g = lane / 4), and the B
//   fragment of m16n8k16 wants, from each thread, k pairs of one column g:
//   so mma j of the four takes column 4g + j of the block as its column g,
//   and the epilogue maps the accumulators back. Each weight is dequantized
//   in registers as the plain version rounds it, bf16(bf16(q) * bf16(s)),
//   so the kernel multiplies the plain version's weights bit for bit and
//   only the order of the sums differs. The dequant uses full-rate
//   instructions only (byte permutes, an fp32 subtraction, a bf16x2
//   multiply): int-to-float and float-to-bf16 conversions issue at a
//   fraction of that rate, and at 1.5 of them per weight they, not the
//   memory, set the time of an earlier version of this kernel.
// - fp32 (the engine's fp32 check on int8 weights): plain FMA on the CUDA
//   cores, one column per lane, 16 rows per block, w = fp32(q) * s rounded
//   once as the plain version rounds it.
// - The warps' partial sums are added in shared memory in warp order, so a
//   row's sum order depends on K alone: never on M, on the other rows, or on
//   the order in which warps finish. No atomics, no second pass.
//
// The wrapper (ops/int8_matmul.py) allocates y, checks shapes, dtypes and
// alignment, and passes the current stream. This file allocates nothing and
// never synchronizes, and it sets the kernels' shared-memory attribute once
// per device, at the first launch (before any capture), so a launch can be
// captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;       // output columns per block
constexpr int kStageRows = 64;  // k rows per stage: 4 mma k steps
constexpr int kQStride = 48;    // bytes per q row in shared memory: 32 + 16
constexpr int kXStride = 144;   // bytes per x row in shared memory: 128 + 16
constexpr int kMaxWarps = 8;
constexpr int kMaxDevices = 64;

struct Params {
  const void* x;    // [M, K] bf16 or fp32
  const int8_t* q;  // [K, N]
  const float* s;   // [N]
  void* y;          // [M, N], x's dtype
  int M, K, N;
  int warps;  // warps splitting K
};

// One warp's ring: two stages of [64, 32] q and [16 MT, 64] x.
template <int MT>
struct Ring {
  static constexpr int kQBytes = kStageRows * kQStride;
  static constexpr int kStageBytes = kQBytes + MT * 16 * kXStride;
  static constexpr int kStages = 2;
  static constexpr int kWarpBytes = kStageBytes * kStages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with src_bytes 0, 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q_j, byte j of a word of q, exactly, from u = word ^ 0x80808080 (q + 128
// per byte): prmt builds the fp32 2^23 + u_j, and one subtraction leaves q_j.
// Full-rate instructions only; an int-to-float conversion issues at a
// fraction of that rate.
template <int J>
__device__ __forceinline__ float int8_value(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + J)) - 8388736.f;
}

// Two exact q values as a bf16 pair, lo in the low half: a |q| <= 127 is
// exact in bf16, so its bf16 is the high half of its fp32.
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, __nv_bfloat162 b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a), b);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma j = J of a k16 step: the B fragment of column 4g + J from the step's
// 4 words of q (``u``: XORed with 0x80808080), dequantized as the plain
// version rounds it: bf16(q) * bf16(s), one bf16 multiply (its exact product
// rounded once), times every m tile.
template <int J, int MT>
__device__ __forceinline__ void mma_column(float (&acc)[MT][4][4], const uint32_t (&a)[MT][4],
                                           const uint32_t (&u)[4], __nv_bfloat162 s) {
  const uint32_t b0 = mul_bf16x2(pack_bf16_exact(int8_value<J>(u[0]), int8_value<J>(u[1])), s);
  const uint32_t b1 = mul_bf16x2(pack_bf16_exact(int8_value<J>(u[2]), int8_value<J>(u[3])), s);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][J], a[mt], b0, b1);
}

// Queues one stage's copies: q rows [k0, k0 + 64) of the block's 32 columns
// (two 16-byte chunks a row) and x rows [m0, m0 + 16 MT) of columns
// [k0, k0 + 64) (eight a row; rows past M zero-filled).
template <int MT>
__device__ __forceinline__ void issue_stage(uint32_t stage, const Params& p,
                                            const __nv_bfloat16* x, int k0, int n0, int m0,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    const int row = c >> 1;
    const int half = c & 1;
    cp_async16(stage + row * kQStride + 16 * half,
               p.q + static_cast<size_t>(k0 + row) * p.N + n0 + 16 * half, 16);
  }
  const uint32_t xs = stage + Ring<MT>::kQBytes;
#pragma unroll
  for (int i = 0; i < 4 * MT; ++i) {
    const int c = lane + 32 * i;
    const int row = c >> 3;
    const int part = c & 7;
    const bool valid = m0 + row < p.M;
    cp_async16(xs + row * kXStride + 16 * part,
               x + static_cast<size_t>(valid ? m0 + row : 0) * p.K + k0 + 8 * part,
               valid ? 16 : 0);
  }
}

// The 4 k16 steps of one stage from shared memory. Thread (g, t) reads q rows
// 2t, 2t + 1, 2t + 8, 2t + 9 of a step at byte 4g, and x rows g and g + 8 of
// each m tile at columns 2t and 2t + 8 (the A fragment of m16n8k16).
template <int MT>
__device__ __forceinline__ void compute_stage(float (&acc)[MT][4][4], const unsigned char* stage,
                                              const __nv_bfloat162 (&sc)[4], int g, int t) {
  const unsigned char* xs = stage + Ring<MT>::kQBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* qr = stage + (kk * 16 + 2 * t) * kQStride + 4 * g;
    const uint32_t u[4] = {lds32(qr) ^ 0x80808080u, lds32(qr + kQStride) ^ 0x80808080u,
                           lds32(qr + 8 * kQStride) ^ 0x80808080u,
                           lds32(qr + 9 * kQStride) ^ 0x80808080u};
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const unsigned char* xr = xs + (mt * 16 + g) * kXStride + (kk * 16 + 2 * t) * 2;
      a[mt][0] = lds32(xr);
      a[mt][1] = lds32(xr + 8 * kXStride);
      a[mt][2] = lds32(xr + 16);
      a[mt][3] = lds32(xr + 8 * kXStride + 16);
    }
    mma_column<0, MT>(acc, a, u, sc[0]);
    mma_column<1, MT>(acc, a, u, sc[1]);
    mma_column<2, MT>(acc, a, u, sc[2]);
    mma_column<3, MT>(acc, a, u, sc[3]);
  }
}

template <int MT>
__global__ void __launch_bounds__(32 * kMaxWarps) int8_mm_bf16(const Params p) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  __shared__ float red[MT * 16 * kCols];
  using R = Ring<MT>;
  constexpr int NS = R::kStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * MT * 16;
  const int kw = p.K / p.warps;
  const int kbeg = warp * kw;
  const int stages = kw / kStageRows;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  unsigned char* ring = ring_smem + warp * R::kWarpBytes;
  const uint32_t ring_addr = smem_addr(ring);

  __nv_bfloat162 sc[4];  // bf16(s) of columns 4g..4g+3, in both halves
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = __bfloat162bfloat162(__float2bfloat16_rn(p.s[n0 + 4 * g + j]));

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // The warp's own ring: NS - 1 stages in flight ahead of the one computed.
  // The __syncwarp after the wait makes every lane's copies visible to the
  // warp; the one after the compute keeps a stage from being refilled while
  // a lane still reads it.
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < stages)
      issue_stage<MT>(ring_addr + s * R::kStageBytes, p, x, kbeg + s * kStageRows, n0, m0, lane);
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    const int ahead = st + NS - 1;
    if (ahead < stages)
      issue_stage<MT>(ring_addr + (ahead % NS) * R::kStageBytes, p, x,
                      kbeg + ahead * kStageRows, n0, m0, lane);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncwarp();
    compute_stage<MT>(acc, ring + (st % NS) * R::kStageBytes, sc, g, t);
    __syncwarp();
  }

  // Warp w adds its accumulators after warps 0..w-1: mma j's columns 2t and
  // 2t + 1 are the block's columns 8t + j and 8t + 4 + j.
  for (int w = 0; w < p.warps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* r0 = red + (mt * 16 + g) * kCols + 8 * t + j;
          float* r1 = r0 + 8 * kCols;
          if (w == 0) {
            r0[0] = acc[mt][j][0];
            r0[4] = acc[mt][j][1];
            r1[0] = acc[mt][j][2];
            r1[4] = acc[mt][j][3];
          } else {
            r0[0] += acc[mt][j][0];
            r0[4] += acc[mt][j][1];
            r1[0] += acc[mt][j][2];
            r1[4] += acc[mt][j][3];
          }
        }
    }
    __syncthreads();
  }
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  for (int i = threadIdx.x; i < MT * 16 * kCols; i += blockDim.x) {
    const int r = m0 + i / kCols;
    if (r < p.M) y[static_cast<size_t>(r) * p.N + n0 + i % kCols] = __float2bfloat16_rn(red[i]);
  }
}

constexpr int kRowsF32 = 16;  // fp32 kernel: rows of x per block

__global__ void __launch_bounds__(32 * kMaxWarps) int8_mm_f32(const Params p) {
  __shared__ float red[kRowsF32 * kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * kRowsF32;
  const int rows = min(kRowsF32, p.M - m0);
  const int kw = p.K / p.warps;
  const int kbeg = warp * kw;
  const float* x = static_cast<const float*>(p.x);
  const float sc = p.s[n];

  float acc[kRowsF32];
#pragma unroll
  for (int r = 0; r < kRowsF32; ++r) acc[r] = 0.f;
  for (int k0 = kbeg; k0 < kbeg + kw; k0 += 16) {
    float w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = __fmul_rn(static_cast<float>(p.q[static_cast<size_t>(k0 + i) * p.N + n]), sc);
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) {
      if (r < rows) {
        const float* xr = x + static_cast<size_t>(m0 + r) * p.K + k0;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[r] = fmaf(__ldg(xr + i), w[i], acc[r]);
      }
    }
  }
  for (int w = 0; w < p.warps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < kRowsF32; ++r)
        red[r * kCols + lane] = w == 0 ? acc[r] : red[r * kCols + lane] + acc[r];
    }
    __syncthreads();
  }
  float* y = static_cast<float*>(p.y);
  for (int i = threadIdx.x; i < kRowsF32 * kCols; i += blockDim.x) {
    const int r = i / kCols;
    if (r < rows) y[static_cast<size_t>(m0 + r) * p.N + blockIdx.x * kCols + i % kCols] = red[i];
  }
}

// Sets the ring's dynamic shared memory (above the 48 KB default) once per
// device, then launches on `stream`; returns the CUDA error of the launch.
template <int MT>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(int8_mm_bf16<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxWarps * Ring<MT>::kWarpBytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid(p.N / kCols, (p.M + MT * 16 - 1) / (MT * 16));
  int8_mm_bf16<MT><<<grid, 32 * p.warps, p.warps * Ring<MT>::kWarpBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x and y). Needs K a multiple of 64, N of 32, and x
// and q 16-byte aligned (the wrapper checks). Returns the CUDA error of the
// launch, 0 on success.
extern "C" int int8_matmul(const void* x, const void* q, const void* s, void* y, int dtype,
                           int M, int K, int N, void* stream) {
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.s = static_cast<const float*>(s);
  p.y = y;
  p.M = M;
  p.K = K;
  p.N = N;
  const int k64 = K / kStageRows;
  p.warps = k64 % 8 == 0 ? 8 : k64 % 4 == 0 ? 4 : k64 % 2 == 0 ? 2 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(N / kCols, (M + kRowsF32 - 1) / kRowsF32);
    int8_mm_f32<<<grid, 32 * p.warps, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (M <= 16)
    err = launch_bf16<1>(p, st);
  else if (M <= 32)
    err = launch_bf16<2>(p, st);
  else
    err = launch_bf16<4>(p, st);
  return static_cast<int>(err);
}
