// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two Pallas TPU kernels launched by `_bwd`
// (ray_tpu/ops/flash_attention.py:244): `_bwd_dq_kernel` (:158, pallas_call
// at :251) and `_bwd_dkv_kernel` (:197, pallas_call at :271). Same functions,
// not the same blocking. From q, k, v, dO in the [B, S, H, D] layout (read
// through strides; GQA by kv head h / n_rep), the forward's row logsumexp
// lse and delta = rowsum(dO * O), both fp32 [B, H, S], they recompute
//   p = exp(scale * q k^T - lse)  (causal mask on global positions),
//   dp = dO v^T,  ds = p (dp - delta) scale,
// and write dQ = ds k (dq kernel) and dV = p^T dO, dK = ds^T q (dkv kernel)
// without ever writing an S x S matrix. As in the TPU kernels, p and ds are
// rounded to bf16 before the products that consume them and every sum is fp32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM). At the 400M
// model's shape (B 8, S 2048, H 8, D 128, causal, bf16) there are 1.34e8
// unmasked (q, k) pairs per head and batch row summed; dQ does 3 products of
// 2D FLOP per pair (q k^T, dO v^T, ds k: 1.03e11 FLOP, >= 0.104 ms) and dK/dV
// 4 (q k^T, dO v^T, p^T dO, ds^T q: 1.37e11 FLOP, >= 0.139 ms), against
// ~0.05-0.06 ms to move their ~170-200 MB. Both are compute-bound, so the
// design keeps every product on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate), keeps p and ds in registers (a product's accumulator
// tiles are the next product's A fragment), and skips the tiles that the
// causal mask empties (the @pl.when skips at :169 and :209), which halves
// the work. wgmma, TMA and warp specialisation are left for a later change.
//
// dq kernel: one block per (64-row q tile, batch * head), four warps of 16 q
// rows; q, dO, lse and delta of its rows stay in the block while it loops
// over kv tiles up to the diagonal. Each block owns its dQ rows: no atomics.
//
// dkv kernel: one block per (64-row kv tile, batch * kv head); the products
// are taken transposed (s^T = k q^T, dp^T = v dO^T) so kv rows are the M
// dimension and both fp32 accumulators stay in registers. It loops over the
// n_rep q heads that share its kv head and, for each, over 32-row q tiles
// from the first that reaches the kv tile to the end, so the GQA sum of the
// repeated heads happens inside the block: deterministic, no atomics. At
// D 256 two accumulators of 16 x 256 per warp would not fit the 255
// registers of a thread, so the block's output columns are split in chunks
// of 128 (grid z), each chunk recomputing s^T and dp^T.
//
// Ragged S: q rows past S are zero-filled and their lse/delta read as 0, and
// p is forced to 0 there, so nothing from them reaches dK/dV; rows past S are
// never stored. The fp32 kernels (used to check the algorithm on the card)
// are plain FMA on shared tiles, with the same loops and masks.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;  // dq: q rows per block; dkv: kv rows per block
constexpr int kBlockQ = 32;  // dkv: q rows per inner tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  void* dq;            // contiguous [B, S, H, D]
  void* dk;            // contiguous [B, S, Hkv, D]
  void* dv;            // contiguous [B, S, Hkv, D]
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // of dO
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// bf16 kernels. DP: head dim padded to the template (D <= DP, D % 16 == 0).
// Lane (g = lane / 4, t = lane % 4) of warp w holds rows 16w + g and
// 16w + g + 8 of the block's M rows, columns 2t, 2t + 1 of each 8-wide tile.
// ---------------------------------------------------------------------------

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + kBlockM * kPitch;  // dO
  __nv_bfloat16* sK = sO + kBlockM * kPitch;
  __nv_bfloat16* sV = sK + BN * kPitch;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kBlockM;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dO =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<DP>(sQ, Q, p.q_ss, q0, kBlockM, p.S, p.D);
  load_tile<DP>(sO, dO, p.o_ss, q0, kBlockM, p.S, p.D);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp * 16 + g;
  const int qa = q0 + r_lo;  // global positions of the lane's two rows
  const int qb = qa + 8;
  const float* lse = p.lse + static_cast<long long>(bh) * p.S;
  const float* delta = p.delta + static_cast<long long>(bh) * p.S;
  const float lse_a = qa < p.S ? lse[qa] : 0.f;
  const float lse_b = qb < p.S ? lse[qb] : 0.f;
  const float dl_a = qa < p.S ? delta[qa] : 0.f;
  const float dl_b = qb < p.S ? delta[qb] : 0.f;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = p.causal ? min(q0 + kBlockM, p.S) : p.S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile is consumed (and sQ, sO are written)
    load_tile<DP>(sK, K, p.k_ss, k0, BN, p.S, p.D);
    load_tile<DP>(sV, V, p.v_ss, k0, BN, p.S, p.D);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows and the tile's BN
    // columns.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, kPitch, r_lo, kk * 16, t);
      load_a(ao, sO, kPitch, r_lo, kk * 16, t);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * kPitch + kk * 16 + t * 2;
        mma_bf16(s[n], aq, lds32(kp), lds32(kp + 8));
        const __nv_bfloat16* vp = sV + (n * 8 + g) * kPitch + kk * 16 + t * 2;
        mma_bf16(dp[n], ao, lds32(vp), lds32(vp + 8));
      }
    }

    // p = exp(scale s - lse), 0 where masked; ds = p (dp - delta) scale,
    // kept in s.
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? qa : qb;
        const bool live = col < p.S && row < p.S && !(p.causal && col > row);
        const float pr = live ? expf(s[n][e] * p.scale - (e < 2 ? lse_a : lse_b)) : 0.f;
        s[n][e] = pr * (dp[n][e] - (e < 2 ? dl_a : dl_b)) * p.scale;
      }
    }

    // dQ += bf16(ds) k: k is the B operand [kv, d].
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      const __nv_bfloat16* kp = sK + (kk * 16 + t * 2) * kPitch + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* kq = kp + n * 8;
        mma_bf16(acc[n], a, pack_halves(kq[0], kq[kPitch]),
                 pack_halves(kq[8 * kPitch], kq[9 * kPitch]));
      }
    }
  }

  const long long row = static_cast<long long>(p.H) * p.D;
  __nv_bfloat16* dQ = static_cast<__nv_bfloat16*>(p.dq) +
                      static_cast<long long>(b) * p.S * row + h * p.D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (col < p.D) {
      if (qa < p.S) {
        *reinterpret_cast<uint32_t*>(dQ + qa * row + col) = pack_floats(acc[n][0], acc[n][1]);
      }
      if (qb < p.S) {
        *reinterpret_cast<uint32_t*>(dQ + qb * row + col) = pack_floats(acc[n][2], acc[n][3]);
      }
    }
  }
}

// DC: output columns per block (grid z splits DP into DP / DC chunks).
template <int DP, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(Params p) {
  constexpr int kPitch = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBlockM * kPitch;
  __nv_bfloat16* sQ = sV + kBlockM * kPitch;
  __nv_bfloat16* sO = sQ + kBlockQ * kPitch;  // dO
  float* sL = reinterpret_cast<float*>(sO + kBlockQ * kPitch);  // lse of the q tile
  float* sD = sL + kBlockQ;                                     // delta

  const int bhk = blockIdx.y;
  const int b = bhk / p.Hkv;
  const int hk = bhk % p.Hkv;
  const int n_rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * kBlockM;
  const int dc0 = blockIdx.z * DC;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<DP>(sK, K, p.k_ss, k0, kBlockM, p.S, p.D);
  load_tile<DP>(sV, V, p.v_ss, k0, kBlockM, p.S, p.D);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp * 16 + g;
  const int ka = k0 + r_lo;  // global positions of the lane's two kv rows
  const int kb = ka + 8;

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // Under the causal mask, q tiles wholly before the kv tile are empty.
  const int i0 = p.causal ? k0 / kBlockQ : 0;
  const int n_q = (p.S + kBlockQ - 1) / kBlockQ;
  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const __nv_bfloat16* Q =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dO =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int i = i0; i < n_q; ++i) {
      const int qt0 = i * kBlockQ;
      __syncthreads();  // the previous q tile is consumed
      load_tile<DP>(sQ, Q, p.q_ss, qt0, kBlockQ, p.S, p.D);
      load_tile<DP>(sO, dO, p.o_ss, qt0, kBlockQ, p.S, p.D);
      for (int c = threadIdx.x; c < kBlockQ; c += kThreads) {
        const int qi = qt0 + c;
        sL[c] = qi < p.S ? p.lse[stat + qi] : 0.f;
        sD[c] = qi < p.S ? p.delta[stat + qi] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T: kv rows by the tile's q columns.
      float st[kBlockQ / 8][4], dpt[kBlockQ / 8][4];
#pragma unroll
      for (int n = 0; n < kBlockQ / 8; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, kPitch, r_lo, kk * 16, t);
        load_a(av, sV, kPitch, r_lo, kk * 16, t);
#pragma unroll
        for (int n = 0; n < kBlockQ / 8; ++n) {
          const __nv_bfloat16* qp = sQ + (n * 8 + g) * kPitch + kk * 16 + t * 2;
          mma_bf16(st[n], ak, lds32(qp), lds32(qp + 8));
          const __nv_bfloat16* op = sO + (n * 8 + g) * kPitch + kk * 16 + t * 2;
          mma_bf16(dpt[n], av, lds32(op), lds32(op + 8));
        }
      }

      // p^T (kept in st) and ds^T = p^T (dp^T - delta) scale (kept in dpt);
      // p is 0 where masked and at q rows past S.
#pragma unroll
      for (int n = 0; n < kBlockQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + t * 2 + (e & 1);
          const int qi = qt0 + c;
          const int kr = e < 2 ? ka : kb;
          const bool live = qi < p.S && !(p.causal && kr > qi);
          const float pr = live ? expf(st[n][e] * p.scale - sL[c]) : 0.f;
          st[n][e] = pr;
          dpt[n][e] = pr * (dpt[n][e] - sD[c]) * p.scale;
        }
      }

      // dV += bf16(p^T) dO and dK += bf16(ds^T) q over this block's columns:
      // dO and q are the B operands [q, d].
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        uint32_t ap[4], as[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
        const __nv_bfloat16* op = sO + (kk * 16 + t * 2) * kPitch + dc0 + g;
        const __nv_bfloat16* qp = sQ + (kk * 16 + t * 2) * kPitch + dc0 + g;
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          const __nv_bfloat16* o2 = op + n * 8;
          mma_bf16(dv[n], ap, pack_halves(o2[0], o2[kPitch]),
                   pack_halves(o2[8 * kPitch], o2[9 * kPitch]));
          const __nv_bfloat16* q2 = qp + n * 8;
          mma_bf16(dk[n], as, pack_halves(q2[0], q2[kPitch]),
                   pack_halves(q2[8 * kPitch], q2[9 * kPitch]));
        }
      }
    }
  }

  const long long row = static_cast<long long>(p.Hkv) * p.D;
  const long long base = static_cast<long long>(b) * p.S * row + hk * p.D;
  __nv_bfloat16* dK = static_cast<__nv_bfloat16*>(p.dk) + base;
  __nv_bfloat16* dV = static_cast<__nv_bfloat16*>(p.dv) + base;
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = dc0 + n * 8 + t * 2;
    if (col < p.D) {
      if (ka < p.S) {
        *reinterpret_cast<uint32_t*>(dK + ka * row + col) = pack_floats(dk[n][0], dk[n][1]);
        *reinterpret_cast<uint32_t*>(dV + ka * row + col) = pack_floats(dv[n][0], dv[n][1]);
      }
      if (kb < p.S) {
        *reinterpret_cast<uint32_t*>(dK + kb * row + col) = pack_floats(dk[n][2], dk[n][3]);
        *reinterpret_cast<uint32_t*>(dV + kb * row + col) = pack_floats(dv[n][2], dv[n][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 kernels: 32-row tiles in shared memory, one score or output element
// per thread and step. D is a runtime value; the launcher sizes the tiles.
// ---------------------------------------------------------------------------

constexpr int kTile32 = 32;

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = kTile32, BN = kTile32;
  const int D = p.D;
  float* sQ = reinterpret_cast<float*>(smem);  // [BM][D]
  float* sO = sQ + BM * D;                     // [BM][D] dO
  float* sA = sO + BM * D;                     // [BM][D] dQ accumulator
  float* sK = sA + BM * D;                     // [BN][D + 1]
  float* sV = sK + BN * (D + 1);               // [BN][D + 1]
  float* sS = sV + BN * (D + 1);               // [BM][BN + 1] ds
  float* sL = sS + BM * (BN + 1);              // [BM] lse
  float* sD = sL + BM;                         // [BM] delta

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BM;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dO = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int tid = threadIdx.x;

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[i] = s < p.S ? Q[s * p.q_ss + c] : 0.f;
    sO[i] = s < p.S ? dO[s * p.o_ss + c] : 0.f;
    sA[i] = 0.f;
  }
  for (int r = tid; r < BM; r += kThreads) {
    const int s = q0 + r;
    sL[r] = s < p.S ? p.lse[static_cast<long long>(bh) * p.S + s] : 0.f;
    sD[r] = s < p.S ? p.delta[static_cast<long long>(bh) * p.S + s] : 0.f;
  }

  const int kv_end = p.causal ? min(q0 + BM, p.S) : p.S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    for (int i = tid; i < BN * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      sK[r * (D + 1) + c] = s < p.S ? K[s * p.k_ss + c] : 0.f;
      sV[r * (D + 1) + c] = s < p.S ? V[s * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const float* qr = sQ + r * D;
      const float* orow = sO + r * D;
      const float* kr = sK + c * (D + 1);
      const float* vr = sV + c * (D + 1);
      float qk = 0.f, ov = 0.f;
      for (int d = 0; d < D; ++d) {
        qk = fmaf(qr[d], kr[d], qk);
        ov = fmaf(orow[d], vr[d], ov);
      }
      const int row = q0 + r, col = k0 + c;
      const bool live = row < p.S && col < p.S && !(p.causal && col > row);
      const float pr = live ? expf(qk * p.scale - sL[r]) : 0.f;
      sS[r * (BN + 1) + c] = pr * (ov - sD[r]) * p.scale;
    }
    __syncthreads();

    for (int i = tid; i < BM * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* sr = sS + r * (BN + 1);
      float a = sA[i];
      for (int c = 0; c < BN; ++c) a = fmaf(sr[c], sK[c * (D + 1) + d], a);
      sA[i] = a;
    }
  }
  __syncthreads();

  const long long row = static_cast<long long>(p.H) * D;
  float* dQ = static_cast<float*>(p.dq) + static_cast<long long>(b) * p.S * row + h * D;
  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    if (s < p.S) dQ[s * row + d] = sA[i];
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = kTile32, BM = kTile32;  // kv rows per block, q rows per tile
  const int D = p.D;
  float* sK = reinterpret_cast<float*>(smem);  // [BN][D + 1]
  float* sV = sK + BN * (D + 1);               // [BN][D + 1]
  float* sdK = sV + BN * (D + 1);              // [BN][D]
  float* sdV = sdK + BN * D;                   // [BN][D]
  float* sQ = sdV + BN * D;                    // [BM][D + 1]
  float* sO = sQ + BM * (D + 1);               // [BM][D + 1] dO
  float* sP = sO + BM * (D + 1);               // [BN][BM + 1] p^T
  float* sS = sP + BN * (BM + 1);              // [BN][BM + 1] ds^T
  float* sL = sS + BN * (BM + 1);              // [BM] lse
  float* sD = sL + BM;                         // [BM] delta

  const int bhk = blockIdx.y;
  const int b = bhk / p.Hkv;
  const int hk = bhk % p.Hkv;
  const int n_rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * BN;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int tid = threadIdx.x;

  for (int i = tid; i < BN * D; i += kThreads) {
    const int r = i / D, c = i % D, s = k0 + r;
    sK[r * (D + 1) + c] = s < p.S ? K[s * p.k_ss + c] : 0.f;
    sV[r * (D + 1) + c] = s < p.S ? V[s * p.v_ss + c] : 0.f;
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }

  const int i0 = p.causal ? k0 / BM : 0;
  const int n_q = (p.S + BM - 1) / BM;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dO = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int it = i0; it < n_q; ++it) {
      const int qt0 = it * BM;
      __syncthreads();
      for (int i = tid; i < BM * D; i += kThreads) {
        const int r = i / D, c = i % D, s = qt0 + r;
        sQ[r * (D + 1) + c] = s < p.S ? Q[s * p.q_ss + c] : 0.f;
        sO[r * (D + 1) + c] = s < p.S ? dO[s * p.o_ss + c] : 0.f;
      }
      for (int r = tid; r < BM; r += kThreads) {
        const int s = qt0 + r;
        sL[r] = s < p.S ? p.lse[stat + s] : 0.f;
        sD[r] = s < p.S ? p.delta[stat + s] : 0.f;
      }
      __syncthreads();

      for (int i = tid; i < BN * BM; i += kThreads) {
        const int r = i / BM, c = i % BM;
        const float* kr = sK + r * (D + 1);
        const float* vr = sV + r * (D + 1);
        const float* qc = sQ + c * (D + 1);
        const float* oc = sO + c * (D + 1);
        float kq = 0.f, vo = 0.f;
        for (int d = 0; d < D; ++d) {
          kq = fmaf(kr[d], qc[d], kq);
          vo = fmaf(vr[d], oc[d], vo);
        }
        const int kv = k0 + r, qi = qt0 + c;
        const bool live = qi < p.S && !(p.causal && kv > qi);
        const float pr = live ? expf(kq * p.scale - sL[c]) : 0.f;
        sP[r * (BM + 1) + c] = pr;
        sS[r * (BM + 1) + c] = pr * (vo - sD[c]) * p.scale;
      }
      __syncthreads();

      for (int i = tid; i < BN * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const float* pr = sP + r * (BM + 1);
        const float* sr = sS + r * (BM + 1);
        float av = sdV[i], ak = sdK[i];
        for (int c = 0; c < BM; ++c) {
          av = fmaf(pr[c], sO[c * (D + 1) + d], av);
          ak = fmaf(sr[c], sQ[c * (D + 1) + d], ak);
        }
        sdV[i] = av;
        sdK[i] = ak;
      }
    }
  }
  __syncthreads();

  const long long row = static_cast<long long>(p.Hkv) * D;
  const long long base = static_cast<long long>(b) * p.S * row + hk * D;
  float* dK = static_cast<float*>(p.dk) + base;
  float* dV = static_cast<float*>(p.dv) + base;
  for (int i = tid; i < BN * D; i += kThreads) {
    const int r = i / D, d = i % D, s = k0 + r;
    if (s < p.S) {
      dK[s * row + d] = sdK[i];
      dV[s * row + d] = sdV[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, int BN>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  const int smem = (2 * kBlockM + 2 * BN) * (DP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  const dim3 grid((p.S + kBlockM - 1) / kBlockM, p.B * p.H);
  return launch(flash_bwd_dq_bf16_kernel<DP, BN>, grid, smem, p, stream);
}

template <int DP, int DC>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  const int smem = (2 * kBlockM + 2 * kBlockQ) * (DP + 8) * static_cast<int>(sizeof(__nv_bfloat16)) +
                   2 * kBlockQ * static_cast<int>(sizeof(float));
  const dim3 grid((p.S + kBlockM - 1) / kBlockM, p.B * p.Hkv, DP / DC);
  return launch(flash_bwd_dkv_bf16_kernel<DP, DC>, grid, smem, p, stream);
}

cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  const int D = p.D, T = kTile32;
  const int floats = 3 * T * D + 2 * T * (D + 1) + T * (T + 1) + 2 * T;
  const dim3 grid((p.S + T - 1) / T, p.B * p.H);
  return launch(flash_bwd_dq_f32_kernel, grid, floats * static_cast<int>(sizeof(float)), p,
                stream);
}

cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  const int D = p.D, T = kTile32;
  const int floats = 4 * T * (D + 1) + 2 * T * D + 2 * T * (T + 1) + 2 * T;
  const dim3 grid((p.S + T - 1) / T, p.B * p.Hkv);
  return launch(flash_bwd_dkv_f32_kernel, grid, floats * static_cast<int>(sizeof(float)), p,
                stream);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                   int S, int H, int Hkv, int D, const long long* st, float scale,
                   int causal) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.q_sb = st[0];
  p.q_ss = st[1];
  p.q_sh = st[2];
  p.k_sb = st[3];
  p.k_ss = st[4];
  p.k_sh = st[5];
  p.v_sb = st[6];
  p.v_ss = st[7];
  p.v_sh = st[8];
  p.o_sb = st[9];
  p.o_ss = st[10];
  p.o_sh = st[11];
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q, k, v, dout are read through their strides
// (in elements, batch / sequence / head of q, k, v, dout in that order; the
// last dim is contiguous); lse and delta are contiguous fp32 [B, H, S]; dq,
// dk, dv are written contiguous, in the inputs' dtype. The caller checks
// shapes, dtypes and alignment. Each returns the CUDA error of its launch
// (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int dtype, int B,
                            int S, int H, int Hkv, int D, const long long* strides,
                            float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, Hkv, D,
                               strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return static_cast<int>(launch_dq_bf16<64, 64>(p, st));
    if (D <= 128) return static_cast<int>(launch_dq_bf16<128, 64>(p, st));
    return static_cast<int>(launch_dq_bf16<256, 32>(p, st));
  }
  return static_cast<int>(launch_dq_f32(p, st));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int S, int H, int Hkv, int D, const long long* strides,
                             float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, H, Hkv, D,
                               strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return static_cast<int>(launch_dkv_bf16<64, 64>(p, st));
    if (D <= 128) return static_cast<int>(launch_dkv_bf16<128, 128>(p, st));
    return static_cast<int>(launch_dkv_bf16<256, 128>(p, st));
  }
  return static_cast<int>(launch_dkv_f32(p, st));
}
