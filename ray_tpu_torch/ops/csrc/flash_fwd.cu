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
// at the memory rate. So it is compute-bound, and only wgmma reaches the
// tensor cores' full rate. The bf16 design (csrc/hopper.cuh has the pieces):
//
// - A block owns 128 q rows of one (batch row, head): two consumer
//   warpgroups of 64 rows (one wgmma M each) and a producer warpgroup whose
//   one thread issues every copy; setmaxnreg hands the producer's registers
//   to the consumers. At D 64 and 128 the consumers (o, s and p of 128 kv
//   columns) compile without spills. At D 256, where o alone is 128 fp32
//   registers, two consumers spilled (ptxas, on the card), so a block there
//   is one consumer warpgroup of 64 rows and the producer (256 threads, up
//   to 255 registers, no setmaxnreg).
// - TMA copies the q tile once, and the k and v tiles (BN rows) through a
//   ring of NS stages (3 at D <= 128), each with full barriers for k and v
//   and an empty barrier the consumer warps release. Tensor maps over
//   [B, S, H, D] (dims D, H, S, B) read strided operands and the kv head
//   h / n_rep without a copy and zero-fill rows past S and columns past D.
// - s = q k^T: wgmma m64nBNk16, q and k from shared memory (K-major).
//   o += p v: wgmma m64nDk16 with p from registers (the score accumulators
//   rounded to bf16 pairs: one wgmma's accumulator layout is the next one's
//   A fragment, as p.astype(v.dtype) at flash_attention.py:107) and v from
//   shared memory as MN-major (transpose bit), so no thread gathers v.
// - Online softmax in registers with exp2 and scale * log2(e) folded into one
//   multiply-add; masks only on the tiles that the causal diagonal or the
//   ragged end of S cross; tiles wholly above the diagonal are skipped (the
//   counterpart of the @pl.when skip at :87), which halves the work.
// - Under the causal mask the heaviest q tiles (the last ones) are scheduled
//   first, so the last wave is made of short blocks.
//
// The fp32 path (used to check the algorithm on the card) is plain FMA on
// 64-row q tiles with the same online softmax.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;  // fp32 kernel: q rows per block

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

// Number of kv tiles a q tile of `rows` rows from q0 needs: under the causal
// mask, up to the tile holding its last row.
__device__ __forceinline__ int kv_tiles(int S, int causal, int q0, int rows, int block_n) {
  const int kv_end = causal ? min(q0 + rows, S) : S;
  return (kv_end + block_n - 1) / block_n;
}

// ---------------------------------------------------------------------------
// bf16 kernel (wgmma, TMA, warp specialisation)
// ---------------------------------------------------------------------------

struct TmaParams {
  CUtensorMap tm_q, tm_k, tm_v;
  void* o;
  float* lse;  // [B, H, S]
  int S, H, D, n_rep, n_q_tiles;
  long long o_sb, o_ss, o_sh;
  float scale, scale_log2;  // scale, scale * log2(e)
  int causal;
};

// DP: head dim padded to the template (D <= DP); BN: kv rows per tile; NS:
// ring stages; NWG: consumer warpgroups, 64 q rows each.
template <int DP, int BN, int NS, int NWG>
struct FwdSmem {
  static constexpr int kRowsM = 64 * NWG;      // q rows per block
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQ = kRowsM * DP * 2;  // bytes of the q tile
  static constexpr int kKV = BN * DP * 2;     // bytes of one k or v tile
  static constexpr int kBars = 1 + 3 * NS;    // q; k full, v full, empty per stage
  static constexpr int kBytes = 1024 + kQ + 2 * NS * kKV + 8 * kBars;  // 1024: alignment slack
};

template <int DP, int BN, int NS, int NWG>
__global__ void __launch_bounds__(FwdSmem<DP, BN, NS, NWG>::kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ TmaParams p) {
  using L = FwdSmem<DP, BN, NS, NWG>;
  constexpr int kRowsM = L::kRowsM;
  // kv tiles start on q-tile boundaries, so under the causal mask every
  // warpgroup has a live column in every tile its block loads.
  static_assert(BN % kRowsM == 0, "BN must be a multiple of the block's q rows");
  constexpr int ON = DP < 128 ? DP : 128;  // N of one p v wgmma
  constexpr int NO = DP / ON;              // p v wgmmas per k step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  const uint32_t sKV = sQ + L::kQ;              // stage s: k at sKV + 2s kKV, v after it
  const uint32_t bars = sKV + 2 * NS * L::kKV;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + NS + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * NS + s); };
  auto sK = [&](int s) { return sKV + 2u * s * L::kKV; };
  auto sV = [&](int s) { return sKV + (2u * s + 1u) * L::kKV; };

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.n_rep;
  const int qt = p.causal ? p.n_q_tiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * kRowsM;
  const int n_tiles = kv_tiles(p.S, p.causal, q0, kRowsM, BN);
  // Warpgroup index, broadcast from lane 0 so the compiler sees it is uniform
  // across each warp: the role branches below then do not diverge inside a
  // warpgroup, which setmaxnreg and wgmma need.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), 4 * NWG);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // Producer: one thread keeps the ring full.
    if constexpr (NWG > 1) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * 128) {
      hopper::mbar_arrive_expect_tx(q_full, L::kQ);
      hopper::tma_tile<DP>(sQ, &p.tm_q, q_full, kRowsM, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        hopper::mbar_wait(empty(s), ((j / NS) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(k_full(s), L::kKV);
        hopper::tma_tile<DP>(sK(s), &p.tm_k, k_full(s), BN, hk, j * BN, b);
        hopper::mbar_arrive_expect_tx(v_full(s), L::kKV);
        hopper::tma_tile<DP>(sV(s), &p.tm_v, v_full(s), BN, hk, j * BN, b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns q rows [row0, row0 + 64).
    if constexpr (NWG > 1) hopper::setmaxnreg_inc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = q0 + wg * 64;
    const int qa = row0 + warp * 16 + g;  // global positions of the thread's two rows
    const int qb = qa + 8;
    const float c = p.scale_log2;

    float o[NO][ON / 2];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
#pragma unroll
      for (int x = 0; x < ON / 2; ++x) o[i][x] = 0.f;
    }
    float m_a = kNegInf, m_b = kNegInf;  // running max of the raw scores
    float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sums

    const uint64_t q_desc = hopper::desc_k_major(sQ + wg * 64 * 128);
    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NS;
      const uint32_t parity = (j / NS) & 1;
      const int k0 = j * BN;
      hopper::mbar_wait(k_full(s), parity);
      float sc[BN / 2];
      const uint64_t k_desc = hopper::desc_k_major(sK(s));
      hopper::fence_acc(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // k step kk: 16 columns of column block kk / 4
        const uint32_t col = (kk % 4) * 32u;
        hopper::wgmma_ss<BN>(sc, hopper::desc_at(q_desc, (kk / 4) * kRowsM * 128 + col),
                             hopper::desc_at(k_desc, (kk / 4) * BN * 128 + col), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(sc);

      // Masks only where the diagonal or the end of S crosses the tile.
      if ((p.causal && k0 + BN - 1 > row0) || k0 + BN > p.S) {
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) {
          const int col = k0 + (x / 4) * 8 + 2 * t + (x & 1);
          const int row = (x & 2) ? qb : qa;
          if (col >= p.S || (p.causal && col > row)) sc[x] = kNegInf;
        }
      }
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f((m_a - mn_a) * c);
      const float corr_b = exp2f((m_b - mn_b) * c);
      m_a = mn_a;
      m_b = mn_b;
      const float off_a = mn_a * c;
      const float off_b = mn_b * c;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        sc[4 * n] = exp2f(fmaf(sc[4 * n], c, -off_a));
        sc[4 * n + 1] = exp2f(fmaf(sc[4 * n + 1], c, -off_a));
        sc[4 * n + 2] = exp2f(fmaf(sc[4 * n + 2], c, -off_b));
        sc[4 * n + 3] = exp2f(fmaf(sc[4 * n + 3], c, -off_b));
        sum_a += sc[4 * n] + sc[4 * n + 1];
        sum_b += sc[4 * n + 2] + sc[4 * n + 3];
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
      // The previous tile's p v has completed (waited below), so o can be
      // rescaled here.
#pragma unroll
      for (int i = 0; i < NO; ++i) {
#pragma unroll
        for (int x = 0; x < ON / 2; ++x) o[i][x] *= (x & 2) ? corr_b : corr_a;
      }
      // p in bf16 as the A fragments of the BN / 16 k steps of p v.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_floats(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_floats(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_floats(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_floats(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      hopper::mbar_wait(v_full(s), parity);
      const uint64_t v_desc = hopper::desc_mn_major(sV(s), BN * 128);
#pragma unroll
      for (int i = 0; i < NO; ++i) hopper::fence_acc(o[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          // kv rows 16 kk.., output columns i ON.. (column block i ON / 64)
          hopper::wgmma_rs<ON>(o[i], pa[kk],
                               hopper::desc_at(v_desc, kk * 16 * 128 + (i * ON / 64) * BN * 128),
                               1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NO; ++i) hopper::fence_acc(o[i]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f);
    const float den_b = fmaxf(l_b, 1e-30f);
    const float inv_a = 1.f / den_a;
    const float inv_b = 1.f / den_b;

    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
#pragma unroll
      for (int n = 0; n < ON / 8; ++n) {
        const int col = i * ON + n * 8 + 2 * t;
        if (col < p.D) {
          if (qa < p.S) {
            *reinterpret_cast<uint32_t*>(O + qa * p.o_ss + col) =
                pack_floats(o[i][4 * n] * inv_a, o[i][4 * n + 1] * inv_a);
          }
          if (qb < p.S) {
            *reinterpret_cast<uint32_t*>(O + qb * p.o_ss + col) =
                pack_floats(o[i][4 * n + 2] * inv_b, o[i][4 * n + 3] * inv_b);
          }
        }
      }
    }
    if (t == 0) {
      float* lse = p.lse + static_cast<long long>(bh) * p.S;
      if (qa < p.S) lse[qa] = m_a * p.scale + logf(den_a);
      if (qb < p.S) lse[qb] = m_b * p.scale + logf(den_b);
    }
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

  const int n_tiles = kv_tiles(p.S, p.causal, q0, kBlockM, kBlockN32);
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

// The one table from head dim to the bf16 kernel's configuration: returns
// f(layout) for the layout that flash_fwd launches at D.
template <typename F>
int with_fwd_config(int D, F f) {
  if (D <= 64) return f(FwdSmem<64, 128, 3, 2>{});
  if (D <= 128) return f(FwdSmem<128, 128, 3, 2>{});
  return f(FwdSmem<256, 64, 2, 1>{});
}

template <int DP, int BN, int NS, int NWG>
int launch_bf16(FwdSmem<DP, BN, NS, NWG>, const Params& p, cudaStream_t stream) {
  using L = FwdSmem<DP, BN, NS, NWG>;
  constexpr int kRowsM = L::kRowsM;
  TmaParams tp;
  int rc = hopper::encode_bshd(&tp.tm_q, p.q, p.B, p.S, p.H, p.D, p.q_sb, p.q_ss, p.q_sh, kRowsM);
  if (rc == 0) {
    rc = hopper::encode_bshd(&tp.tm_k, p.k, p.B, p.S, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, BN);
  }
  if (rc == 0) {
    rc = hopper::encode_bshd(&tp.tm_v, p.v, p.B, p.S, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, BN);
  }
  if (rc != 0) return rc;
  tp.o = p.o;
  tp.lse = p.lse;
  tp.S = p.S;
  tp.H = p.H;
  tp.D = p.D;
  tp.n_rep = p.H / p.Hkv;
  tp.n_q_tiles = (p.S + kRowsM - 1) / kRowsM;
  tp.o_sb = p.o_sb;
  tp.o_ss = p.o_ss;
  tp.o_sh = p.o_sh;
  tp.scale = p.scale;
  tp.scale_log2 = p.scale * 1.4426950408889634f;
  tp.causal = p.causal;
  const dim3 grid(p.B * p.H, tp.n_q_tiles);
  return static_cast<int>(
      launch(flash_fwd_bf16_kernel<DP, BN, NS, NWG>, grid, L::kThreads, L::kBytes, tp, stream));
}

cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  const int D = p.D;
  const int floats = kBlockM * D + kBlockN32 * (D + 1) + kBlockN32 * D +
                     kBlockM * (kBlockN32 + 1) + kBlockM * D + 3 * kBlockM;
  return launch(flash_fwd_f32_kernel, grid, kThreads, floats * static_cast<int>(sizeof(float)), p,
                stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements; the last dim is
// contiguous. The caller checks shapes and dtypes, and (for the tensor maps
// of the bf16 path) a 16-byte aligned base and strides that are positive
// multiples of 16 bytes. Returns the CUDA error of the launch (0 on
// success), or hopper::kErrNoEncodeEntryPoint / kErrEncode + CUresult when a
// tensor map cannot be made.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return with_fwd_config(D, [&](auto layout) { return launch_bf16(layout, p, st); });
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  return static_cast<int>(launch_f32(p, grid, st));
}

// Dynamic shared memory (bytes) of the bf16 kernel that flash_fwd launches
// for head dim D.
extern "C" int flash_fwd_smem_bytes(int D) {
  return with_fwd_config(D, [](auto layout) { return decltype(layout)::kBytes; });
}
