// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ray_tpu/ops/flash_attention.py:72,
// launched by `_fwd` at :120, pallas_call at :128). Same function, not the same
// blocking: o = softmax(scale * q k^T, causal mask on global positions) v and
// lse = logsumexp of the masked scores, over q, k, v in the [B, S, H, D] layout
// read through strides (no transposes), with GQA by indexing kv head h / n_rep.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM). At the 400M
// model's shape (B 8, S 2048, H 8, D 128, causal, bf16) the two products need
// 2 * B * H * S^2 * D ~ 6.9e10 FLOP (the causal half of 4 * B * H * S^2 * D),
// >= ~70 us on the tensor cores, while q, k, v and o are only ~134 MB, ~40 us
// at the memory rate. So it is compute-bound: the design keeps both products on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), keeps the
// S x S scores out of device memory (online softmax in registers), reads each
// k/v tile once per 64 query rows from shared memory, and stops the kv loop at
// the diagonal tile under the causal mask (the counterpart of the @pl.when
// skip at flash_attention.py:87), which halves the work.
//
// Grid: one block per (64-row q tile, batch * head); the kv axis, sequential
// in the TPU grid, is a loop inside the block, since Hopper blocks run in no
// order and carry nothing between them. Four warps, sixteen q rows each.
// Ragged S is masked at both the q and the kv edge. wgmma, TMA and warp
// specialisation are left for a later change.
//
// The fp32 path (used to check the algorithm on the card) is plain FMA with
// the same tiling of the q axis and the same online softmax.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;  // q rows per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, S]
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Number of kv tiles a q tile needs: under the causal mask, up to the tile
// holding its last row.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int block_n) {
  const int kv_end = p.causal ? min(q0 + kBlockM, p.S) : p.S;
  return (kv_end + block_n - 1) / block_n;
}

// bf16 kernel. DP: head dim padded to the template (D <= DP, D % 16 == 0).
// BN: kv tile rows. Each warp owns 16 q rows; lane (g = lane / 4, t = lane % 4)
// holds rows g and g + 8 of the warp's strip and columns 2t, 2t + 1 of each
// 8-wide column tile, the accumulator layout of mma.m16n8k16.
template <int DP, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(Params p) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + BN * kPitch;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kBlockM;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<DP>(sQ, Q, p.q_ss, q0, kBlockM, p.S, p.D);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp * 16 + g;  // tile row of this lane's first row
  const int qa = q0 + r_lo;        // global positions of its two rows
  const int qb = qa + 8;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_a = kNegInf, m_b = kNegInf;  // running row max
  float l_a = 0.f, l_b = 0.f;          // this lane's share of the row sum

  const int n_tiles = kv_tiles(p, q0, BN);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    load_tile<DP>(sK, K, p.k_ss, k0, BN, p.S, p.D);
    load_tile<DP>(sV, V, p.v_ss, k0, BN, p.S, p.D);
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's BN columns.
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qp = sQ + r_lo * kPitch + kk * 16 + t * 2;
      const uint32_t a[4] = {lds32(qp), lds32(qp + 8 * kPitch), lds32(qp + 8),
                             lds32(qp + 8 * kPitch + 8)};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * kPitch + kk * 16 + t * 2;
        mma_bf16(s[n], a, lds32(kp), lds32(kp + 8));
      }
    }

    // Scale, mask, and the running max of each row (a row spans one quad).
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? qa : qb;
        float x = s[n][e] * p.scale;
        if (col >= p.S || (p.causal && col > row)) x = kNegInf;
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a);
    const float corr_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = expf(s[n][0] - mn_a);
      s[n][1] = expf(s[n][1] - mn_a);
      s[n][2] = expf(s[n][2] - mn_b);
      s[n][3] = expf(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // acc += p v, with p rounded to bf16 first (as p.astype(v.dtype) at
    // flash_attention.py:107). The score accumulators of two neighbouring
    // column tiles are exactly the A fragment of one 16-deep k step.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {
          pack_floats(s[2 * kk][0], s[2 * kk][1]),
          pack_floats(s[2 * kk][2], s[2 * kk][3]),
          pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vp = sV + (kk * 16 + t * 2) * kPitch + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vq = vp + n * 8;
        const uint32_t b0 = pack_halves(vq[0], vq[kPitch]);
        const uint32_t b1 = pack_halves(vq[8 * kPitch], vq[9 * kPitch]);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (col < p.D) {
      if (qa < p.S) {
        *reinterpret_cast<uint32_t*>(O + qa * p.o_ss + col) =
            pack_floats(acc[n][0] / den_a, acc[n][1] / den_a);
      }
      if (qb < p.S) {
        *reinterpret_cast<uint32_t*>(O + qb * p.o_ss + col) =
            pack_floats(acc[n][2] / den_b, acc[n][3] / den_b);
      }
    }
  }
  if (t == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.S;
    if (qa < p.S) lse[qa] = m_a + logf(den_a);
    if (qb < p.S) lse[qb] = m_b + logf(den_b);
  }
}

// fp32 kernel: shared-memory tiles, one score or output element per thread
// and step, one thread per row for the softmax statistics. D is a runtime
// value; the shared tiles are sized for it by the launcher.
constexpr int kBlockN32 = 32;

__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D;
  constexpr int kSPitch = kBlockN32 + 1;
  float* sQ = reinterpret_cast<float*>(smem);  // [BM][D]
  float* sK = sQ + kBlockM * D;                // [BN][D + 1]
  float* sV = sK + kBlockN32 * (D + 1);        // [BN][D]
  float* sS = sV + kBlockN32 * D;              // [BM][BN + 1]
  float* sO = sS + kBlockM * kSPitch;          // [BM][D]
  float* sM = sO + kBlockM * D;                // [BM] running max
  float* sL = sM + kBlockM;                    // [BM] running sum
  float* sC = sL + kBlockM;                    // [BM] this tile's correction

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kBlockM;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int tid = threadIdx.x;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[i] = s < p.S ? Q[s * p.q_ss + c] : 0.f;
    sO[i] = 0.f;
  }
  for (int r = tid; r < kBlockM; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  const int n_tiles = kv_tiles(p, q0, kBlockN32);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN32;
    __syncthreads();
    for (int i = tid; i < kBlockN32 * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      sK[r * (D + 1) + c] = s < p.S ? K[s * p.k_ss + c] : 0.f;
      sV[i] = s < p.S ? V[s * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kBlockM * kBlockN32; i += kThreads) {
      const int r = i / kBlockN32, c = i % kBlockN32;
      const float* qr = sQ + r * D;
      const float* kr = sK + c * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * p.scale;
      const int col = k0 + c;
      if (col >= p.S || (p.causal && col > q0 + r)) x = kNegInf;
      sS[r * kSPitch + c] = x;
    }
    __syncthreads();

    if (tid < kBlockM) {
      float* sr = sS + tid * kSPitch;
      float mx = kNegInf;
      for (int c = 0; c < kBlockN32; ++c) mx = fmaxf(mx, sr[c]);
      const float m_new = fmaxf(sM[tid], mx);
      const float corr = expf(sM[tid] - m_new);
      float sum = 0.f;
      for (int c = 0; c < kBlockN32; ++c) {
        const float e = expf(sr[c] - m_new);
        sr[c] = e;
        sum += e;
      }
      sL[tid] = sL[tid] * corr + sum;
      sM[tid] = m_new;
      sC[tid] = corr;
    }
    __syncthreads();

    for (int i = tid; i < kBlockM * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* sr = sS + r * kSPitch;
      float a = sO[i] * sC[r];
      for (int c = 0; c < kBlockN32; ++c) a = fmaf(sr[c], sV[c * D + d], a);
      sO[i] = a;
    }
  }
  __syncthreads();

  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    if (s < p.S) O[s * p.o_ss + d] = sO[i] / fmaxf(sL[r], 1e-30f);
  }
  if (tid < kBlockM && q0 + tid < p.S) {
    p.lse[static_cast<long long>(bh) * p.S + q0 + tid] =
        sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
  }
}

template <int DP, int BN>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * BN) * (DP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<DP, BN><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  const int D = p.D;
  const int floats = kBlockM * D + kBlockN32 * (D + 1) + kBlockN32 * D +
                     kBlockM * (kBlockN32 + 1) + kBlockM * D + 3 * kBlockM;
  const int smem = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements; the last dim is
// contiguous. The caller checks shapes, dtypes and alignment. Returns the
// CUDA error of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int B, int S, int H, int Hkv, int D,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return static_cast<int>(launch_bf16<64, 64>(p, grid, st));
    if (D <= 128) return static_cast<int>(launch_bf16<128, 64>(p, grid, st));
    return static_cast<int>(launch_bf16<256, 32>(p, grid, st));
  }
  return static_cast<int>(launch_f32(p, grid, st));
}
