// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two Pallas TPU kernels launched by `_bwd`
// (ray_tpu/ops/flash_attention.py:244): `_bwd_dq_kernel` (:158, pallas_call
// at :251) and `_bwd_dkv_kernel` (:197, pallas_call at :271), and folds in
// the jnp preprocess between them, delta = rowsum(dO * O) (:247). Same
// functions, not the same blocking. From q, k, v, dO in the [B, S, H, D]
// layout (read through strides; GQA by kv head h / n_rep) and the forward's
// row logsumexp lse (fp32 [B, H, S]) they recompute
//   p = exp(scale * q k^T - lse)  (causal mask on global positions),
//   dp = dO v^T,  ds = p (dp - delta) scale,
// and write dQ = ds k and delta (dq kernel), then dV = p^T dO, dK = ds^T q
// (dkv kernel, on the dq kernel's delta), without ever writing an S x S
// matrix. As in the TPU kernels, p and ds are rounded to bf16 before the
// products that consume them and every sum is fp32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM). At the 400M
// model's shape (B 8, S 2048, H 8, D 128, causal, bf16) there are 1.34e8
// unmasked (q, k) pairs per head and batch row summed; dQ does 3 products of
// 2D FLOP per pair (q k^T, dO v^T, ds k: 1.03e11 FLOP, >= 0.104 ms) and dK/dV
// 4 (q k^T, dO v^T, p^T dO, ds^T q: 1.37e11 FLOP, >= 0.139 ms), against
// ~0.06 ms to move their ~202 MB each. Both are compute-bound; both skip the
// tiles that the causal mask empties (the @pl.when skips at :169 and :209),
// which halves the work. Only wgmma reaches the tensor cores' full rate, so
// both kernels keep every product on it and feed it from a TMA ring
// (csrc/hopper.cuh), a producer warp beside the consumer warpgroups.
//
// dq kernel: one block per (q tile, batch * head), the heaviest causal q
// tiles first (slow grid dim).
// - Two consumer warpgroups of 64 q rows (a 128-row q tile; one at D 256)
//   and a producer warpgroup whose one thread issues every copy. q and dO of
//   the tile are copied once by TMA and stay; k and v of kv head h / n_rep
//   stream through a ring of 2 stages of 64 kv rows (full and empty
//   mbarriers) up to the causal diagonal: 2 stages measured 2-3% faster
//   than 3 or 4 at the model's shape (ops/sweep_dq.py). 64-row kv tiles keep a consumer
//   at dQ, s and dp = 64 + 32 + 32 fp32 registers at D 128: 128-row tiles
//   (192) are what spilled two consumer warpgroups in the dK/dV kernel.
// - s = q k^T and dp = dO v^T: wgmma, both operands K-major from shared
//   memory, in two commit groups, so that p = exp2(s scale log2 e - lse
//   log2 e) is made while dO v^T still runs (masks only on diagonal and
//   ragged tiles). ds = p (dp - delta) scale is made in registers, rounded
//   to bf16 and packed as the register A operand of dQ += ds k, which reads
//   the same k tile MN-major (transpose bit): nothing is gathered by hand.
//   dQ stays in fp32 registers for the whole loop and is stored once; each
//   block owns its rows, so there are no atomics and the result is
//   deterministic.
// - delta in the prologue: while the producer's first copies are in flight,
//   each consumer reads its rows of dO and O with 16-byte loads, sums
//   dO * O in fp32 (four lanes a row, then two shuffles), keeps delta in
//   registers in the accumulator's row layout and writes it, fp32
//   [B, H, S], for the dkv kernel.
// - With 128 q rows and 64-row kv tiles a warpgroup can have no live row
//   (S mod 128 in 1..64) or, on the diagonal's last kv tile, no live
//   column. It skips the products, but still waits for every stage to fill
//   before it releases it, so the two warpgroups release each stage of the
//   ring in the same phase.
//
// dkv kernel: one block per (kv tile, batch * kv head).
// - Consumer warpgroups of 64 kv rows each and a producer warpgroup. A
//   consumer keeps dK and dV in fp32 registers for the whole loop, beside
//   s^T and dp^T: 192 registers at D 128. With two consumers (384 threads,
//   setmaxnreg 240 / 24) ptxas spilled and serialized the wgmmas (C7512;
//   0.68 ms against 0.43 ms on the card), so at D 128 and 256 a block is
//   one consumer warpgroup and the producer (256 threads, up to 255
//   registers, no setmaxnreg); at D 64 (128 registers) it is two.
// - K and V are copied once by TMA and stay in shared memory. The q and dO
//   tiles (64 rows) stream through a ring of NS stages (3 at D <= 128; full
//   and empty mbarriers) by TMA over [B, S, H, D] tensor maps, so a strided
//   dO from autograd needs no copy; the producer lanes copy the tile's lse
//   (times log2 e) and delta rows beside them. The ring runs over the n_rep q heads
//   of the kv head and, under the causal mask, from the first q tile that
//   reaches the kv tile: the GQA sum happens inside the block,
//   deterministic, no atomics.
// - s^T = k q^T and dp^T = v dO^T: wgmma with k, v and q, dO from shared
//   memory (K-major). p^T and ds^T are made in registers (exp2, masks only on
//   diagonal and ragged tiles) and packed to bf16 as register A operands of
//   dV += p^T dO and dK += ds^T q, with dO and q read as MN-major (transpose
//   bit): no thread gathers an operand.
// - D 256: two 64 x 256 fp32 accumulators do not fit a thread's registers,
//   so the block's output columns are split in chunks of 128 (grid z), each
//   chunk recomputing s^T and dp^T.
// - kv tiles are the slow grid dim, so the tiles with the most q tiles
//   (the first, under the causal mask) are scheduled first.
//
// Ragged S: TMA zero-fills q, dO, k and v rows past S, their lse/delta read
// as 0 and p is forced to 0 there; rows past S are never stored. The fp32
// kernels (used to check the algorithm on the card) are plain FMA on shared
// tiles, with the same loops and masks and the same delta prologue.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // the forward's output (dq kernel only)
  const void* dout;
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S]: written by the dq kernel, read by the dkv kernel
  void* dq;          // contiguous [B, S, H, D]
  void* dk;          // contiguous [B, S, Hkv, D]
  void* dv;          // contiguous [B, S, Hkv, D]
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 dQ kernel (wgmma, TMA, warp specialisation), delta in its prologue
// ---------------------------------------------------------------------------

struct DqParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const void* o;     // [B, S, H, D] through strides (delta's loads)
  const void* dout;  // the same for dO
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S], written
  void* dq;          // contiguous [B, S, H, D]
  int S, H, D, n_rep, n_q_tiles;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  float scale, scale_log2;  // scale, scale * log2(e)
  int causal;
};

// DP: head dim padded to the template (D <= DP); BN: kv rows per ring
// stage; NS: ring stages; NWG: consumer warpgroups, 64 q rows each.
template <int DP, int BN, int NS, int NWG>
struct DqSmem {
  static constexpr int kRowsM = 64 * NWG;     // q rows per block
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQ = kRowsM * DP * 2;  // bytes of the q (or dO) tile
  static constexpr int kKV = BN * DP * 2;     // bytes of one k or v tile
  static constexpr int kBars = 1 + 2 * NS;    // q and dO; full, empty per stage
  static constexpr int kBytes = 1024 + 2 * kQ + 2 * NS * kKV + 8 * kBars;  // 1024: alignment slack
};

// The sum of a[i] * b[i] over 8 bf16 pairs (one 16-byte load each), added
// to acc in fp32; the products of two bf16 values are exact in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

template <int DP, int BN, int NS, int NWG>
__global__ void __launch_bounds__(DqSmem<DP, BN, NS, NWG>::kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ DqParams p) {
  using L = DqSmem<DP, BN, NS, NWG>;
  constexpr int kRowsM = L::kRowsM;
  constexpr int ON = DP < 128 ? DP : 128;  // N of one ds k wgmma
  constexpr int NO = DP / ON;              // ds k wgmmas per k step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  const uint32_t sO = sQ + L::kQ;              // dO
  const uint32_t sKV = sO + L::kQ;             // stage s: k at sKV + 2s kKV, v after it
  const uint32_t bars = sKV + 2 * NS * L::kKV;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + NS + s); };
  auto sK = [&](int s) { return sKV + 2u * s * L::kKV; };
  auto sV = [&](int s) { return sKV + (2u * s + 1u) * L::kKV; };

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.n_rep;
  // Under the causal mask the heaviest q tiles (the last) come first.
  const int qt = p.causal ? p.n_q_tiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * kRowsM;
  const int kv_end = p.causal ? min(q0 + kRowsM, p.S) : p.S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  // Warpgroup index, broadcast from lane 0 so the compiler sees it is uniform
  // across each warp: the role branches below then do not diverge inside a
  // warpgroup, which setmaxnreg and wgmma need.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 4 * NWG);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // Producer: one thread keeps the ring full.
    if constexpr (NWG > 1) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * 128) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * L::kQ);
      hopper::tma_tile<DP>(sQ, &p.tm_q, q_full, kRowsM, h, q0, b);
      hopper::tma_tile<DP>(sO, &p.tm_do, q_full, kRowsM, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        hopper::mbar_wait(empty(s), ((j / NS) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full(s), 2 * L::kKV);
        hopper::tma_tile<DP>(sK(s), &p.tm_k, full(s), BN, hk, j * BN, b);
        hopper::tma_tile<DP>(sV(s), &p.tm_v, full(s), BN, hk, j * BN, b);
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

    // delta = rowsum(dO * O) of the two rows: lane t sums the 16-byte
    // chunks t, t + 4, ... of each row, then the row's four lanes add up.
    float dl_a = 0.f, dl_b = 0.f;
    {
      const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
      const __nv_bfloat16* O = static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int i = 0; i < DP / 32; ++i) {
        const int col = (t + 4 * i) * 8;
        if (col < p.D) {
          if (qa < p.S) {
            dl_a = dot8(*reinterpret_cast<const uint4*>(dO + qa * p.do_ss + col),
                        *reinterpret_cast<const uint4*>(O + qa * p.o_ss + col), dl_a);
          }
          if (qb < p.S) {
            dl_b = dot8(*reinterpret_cast<const uint4*>(dO + qb * p.do_ss + col),
                        *reinterpret_cast<const uint4*>(O + qb * p.o_ss + col), dl_b);
          }
        }
      }
      dl_a += __shfl_xor_sync(0xffffffffu, dl_a, 1);
      dl_a += __shfl_xor_sync(0xffffffffu, dl_a, 2);
      dl_b += __shfl_xor_sync(0xffffffffu, dl_b, 1);
      dl_b += __shfl_xor_sync(0xffffffffu, dl_b, 2);
      float* delta = p.delta + static_cast<long long>(bh) * p.S;
      if (t == 0) {
        if (qa < p.S) delta[qa] = dl_a;
        if (qb < p.S) delta[qb] = dl_b;
      }
    }
    // lse * log2(e), 0 past S.
    const float* lse = p.lse + static_cast<long long>(bh) * p.S;
    const float ls_a = qa < p.S ? lse[qa] * kLog2e : 0.f;
    const float ls_b = qb < p.S ? lse[qb] * kLog2e : 0.f;

    float dq[NO][ON / 2];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
#pragma unroll
      for (int x = 0; x < ON / 2; ++x) dq[i][x] = 0.f;
    }

    const uint64_t q_desc = hopper::desc_k_major(sQ + wg * 64 * 128);
    const uint64_t o_desc = hopper::desc_k_major(sO + wg * 64 * 128);
    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NS;
      const int k0 = j * BN;
      // Every consumer waits for the stage to fill before it releases it,
      // even one that skips the tile: a warpgroup that released stages it
      // never saw filled could complete a phase of empty(s) alone, a lap
      // ahead, while the other still reads the stage.
      hopper::mbar_wait(full(s), (j / NS) & 1);
      // No live row (all past S), or (causal) every column past every row.
      if (row0 < p.S && !(p.causal && k0 > row0 + 63)) {
        // s = q k^T and dp = dO v^T: the warpgroup's 64 q rows by the tile's
        // BN kv columns.
        float sc[BN / 2], dp[BN / 2];
        const uint64_t k_desc = hopper::desc_k_major(sK(s));
        const uint64_t v_desc = hopper::desc_k_major(sV(s));
        hopper::fence_acc(sc);
        hopper::fence_acc(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          // k step kk: 16 columns of column block kk / 4
          const uint32_t col = (kk % 4) * 32u;
          hopper::wgmma_ss<BN>(sc, hopper::desc_at(q_desc, (kk / 4) * kRowsM * 128 + col),
                               hopper::desc_at(k_desc, (kk / 4) * BN * 128 + col), kk > 0);
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32u;
          hopper::wgmma_ss<BN>(dp, hopper::desc_at(o_desc, (kk / 4) * kRowsM * 128 + col),
                               hopper::desc_at(v_desc, (kk / 4) * BN * 128 + col), kk > 0);
        }
        hopper::wgmma_commit();
        // p = exp(scale s - lse) (0 where masked, at columns past S and at
        // rows past S), made while dO v^T runs; masks only where the
        // diagonal or the end of S crosses the tile.
        hopper::wgmma_wait<1>();
        hopper::fence_acc(sc);
        const bool masked = (p.causal && k0 + BN - 1 > row0) || k0 + BN > p.S || row0 + 64 > p.S;
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) {
          float pr = exp2f(fmaf(sc[x], c, -((x & 2) ? ls_b : ls_a)));
          if (masked) {
            const int col = k0 + (x / 4) * 8 + 2 * t + (x & 1);
            const int row = (x & 2) ? qb : qa;
            if (col >= p.S || row >= p.S || (p.causal && col > row)) pr = 0.f;
          }
          sc[x] = pr;
        }
        // ds = p (dp - delta) scale, kept in sc.
        hopper::wgmma_wait<0>();
        hopper::fence_acc(dp);
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) sc[x] = sc[x] * (dp[x] - ((x & 2) ? dl_b : dl_a)) * p.scale;
        // bf16 ds as the A fragments of the BN / 16 k steps of ds k.
        uint32_t as[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) as[kk][r] = pack_floats(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
        const uint64_t kn_desc = hopper::desc_mn_major(sK(s), BN * 128);
#pragma unroll
        for (int i = 0; i < NO; ++i) hopper::fence_acc(dq[i]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            // kv rows 16 kk.., output columns i ON.. (column block i ON / 64)
            hopper::wgmma_rs<ON>(dq[i], as[kk],
                                 hopper::desc_at(kn_desc, kk * 16 * 128 + (i * ON / 64) * BN * 128),
                                 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NO; ++i) hopper::fence_acc(dq[i]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    const long long row = static_cast<long long>(p.H) * p.D;
    __nv_bfloat16* dQ = static_cast<__nv_bfloat16*>(p.dq) + static_cast<long long>(b) * p.S * row + h * p.D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
#pragma unroll
      for (int n = 0; n < ON / 8; ++n) {
        const int col = i * ON + n * 8 + 2 * t;
        if (col < p.D) {
          if (qa < p.S) {
            *reinterpret_cast<uint32_t*>(dQ + qa * row + col) = pack_floats(dq[i][4 * n], dq[i][4 * n + 1]);
          }
          if (qb < p.S) {
            *reinterpret_cast<uint32_t*>(dQ + qb * row + col) =
                pack_floats(dq[i][4 * n + 2], dq[i][4 * n + 3]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV kernel (wgmma, TMA, warp specialisation)
// ---------------------------------------------------------------------------

struct DkvParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  void* dk;            // contiguous [B, S, Hkv, D]
  void* dv;
  int S, H, Hkv, D, n_rep;
  float scale, scale_log2;  // scale, scale * log2(e)
  int causal;
};

constexpr int kRowsQ = 64;  // q rows per ring tile

// DP: head dim padded to the template (D <= DP); DC: output columns per
// block (grid z splits DP into DP / DC chunks); NWG: consumer warpgroups,
// 64 kv rows each; NS: ring stages.
template <int DP, int DC, int NWG, int NS>
struct DkvSmem {
  static constexpr int kRowsK = 64 * NWG;      // kv rows per block
  static constexpr int kKV = kRowsK * DP * 2;  // bytes of the k (or v) tile
  static constexpr int kQ = kRowsQ * DP * 2;   // bytes of one q (or dO) tile
  static constexpr int kStats = 2 * kRowsQ * 4;  // lse * log2(e) and delta of a tile
  static constexpr int kBars = 1 + 2 * NS;     // k and v; full, empty per stage
  static constexpr int kBytes = 1024 + 2 * kKV + NS * (2 * kQ + kStats) + 8 * kBars;
};

template <int DP, int DC, int NWG, int NS>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvSmem<DP, DC, NWG, NS>;
  constexpr int BK = L::kRowsK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  const uint32_t sV = sK + L::kKV;
  const uint32_t sRing = sV + L::kKV;  // stage s: q, then dO
  const uint32_t sStats = sRing + NS * 2 * L::kQ;
  const uint32_t bars = sStats + NS * L::kStats;
  float* stats = reinterpret_cast<float*>(smem_raw + (sStats - raw));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + NS + s); };
  auto sQ = [&](int s) { return sRing + 2u * s * L::kQ; };
  auto sO = [&](int s) { return sRing + (2u * s + 1u) * L::kQ; };

  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv;
  const int hk = bhk % p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int dc0 = blockIdx.z * DC;
  // The ring runs over the n_rep q heads of the kv head and, for each, over
  // the q tiles from the first that reaches the kv tile (causal) to the end.
  const int i0 = p.causal ? k0 / kRowsQ : 0;
  const int per_rep = (p.S + kRowsQ - 1) / kRowsQ - i0;
  const int n_items = p.n_rep * per_rep;
  // Warpgroup index, broadcast from lane 0 so the compiler sees it is uniform
  // across each warp: the role branches below then do not diverge inside a
  // warpgroup, which setmaxnreg and wgmma need.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full(s), 32);          // every producer lane
      hopper::mbar_init(empty(s), 4 * NWG);    // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // Producer: one warp. Lane 0 issues the TMA copies; the lanes copy the
    // fp32 lse and delta rows (rows of a ragged S are not 16-byte aligned for
    // a bulk copy) and each arrives on the stage's full barrier.
    if constexpr (NWG > 1) hopper::setmaxnreg_dec<24>();
    if (__shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32), 0) == NWG * 4) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
        hopper::tma_tile<DP>(sK, &p.tm_k, kv_full, BK, hk, k0, b);
        hopper::tma_tile<DP>(sV, &p.tm_v, kv_full, BK, hk, k0, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % NS;
        const int h = hk * p.n_rep + it / per_rep;
        const int qt0 = (i0 + it % per_rep) * kRowsQ;
        hopper::mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
        const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
        float* st = stats + s * 2 * kRowsQ;
        for (int c = lane; c < kRowsQ; c += 32) {
          const int qi = qt0 + c;
          st[c] = qi < p.S ? p.lse[row + qi] * kLog2e : 0.f;
          st[kRowsQ + c] = qi < p.S ? p.delta[row + qi] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(full(s), 2 * L::kQ);
          hopper::tma_tile<DP>(sQ(s), &p.tm_q, full(s), kRowsQ, h, qt0, b);
          hopper::tma_tile<DP>(sO(s), &p.tm_do, full(s), kRowsQ, h, qt0, b);
        } else {
          hopper::mbar_arrive(full(s));
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns kv rows [kr0, kr0 + 64).
    if constexpr (NWG > 1) hopper::setmaxnreg_inc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kr0 = k0 + wg * 64;
    const int ka = kr0 + warp * 16 + g;  // global positions of the thread's two kv rows
    const int kb = ka + 8;
    const float c = p.scale_log2;

    float dk[DC / 2], dv[DC / 2];
#pragma unroll
    for (int x = 0; x < DC / 2; ++x) dk[x] = dv[x] = 0.f;

    const uint64_t k_desc = hopper::desc_k_major(sK + wg * 64 * 128);
    const uint64_t v_desc = hopper::desc_k_major(sV + wg * 64 * 128);
    hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % NS;
      const int qt0 = (i0 + it % per_rep) * kRowsQ;
      // Every consumer waits for the stage to fill before it releases it,
      // even one that skips the tile: a warpgroup that released stages it
      // never saw filled could complete a phase of empty(s) alone, a lap
      // ahead, while the other still reads the stage.
      hopper::mbar_wait(full(s), (it / NS) & 1);
      // q tiles wholly before this warpgroup's kv rows are empty (causal).
      if (!p.causal || qt0 + kRowsQ - 1 >= kr0) {
        // s^T = k q^T and dp^T = v dO^T: the warpgroup's 64 kv rows by the
        // tile's 64 q columns.
        float st[32], dpt[32];
        const uint64_t q_desc = hopper::desc_k_major(sQ(s));
        const uint64_t o_desc = hopper::desc_k_major(sO(s));
        hopper::fence_acc(st);
        hopper::fence_acc(dpt);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          // k step kk: 16 columns of column block kk / 4
          const uint32_t col = (kk % 4) * 32u;
          const uint32_t a_off = (kk / 4) * BK * 128 + col;
          const uint32_t b_off = (kk / 4) * kRowsQ * 128 + col;
          hopper::wgmma_ss<64>(st, hopper::desc_at(k_desc, a_off), hopper::desc_at(q_desc, b_off),
                               kk > 0);
          hopper::wgmma_ss<64>(dpt, hopper::desc_at(v_desc, a_off),
                               hopper::desc_at(o_desc, b_off), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(st);
        hopper::fence_acc(dpt);

        // p^T = exp(scale s^T - lse) (0 where masked and at q rows past S)
        // and ds^T = p^T (dp^T - delta) scale; masks only where the diagonal
        // or the end of S crosses the tile.
        const float* sL = stats + s * 2 * kRowsQ;
        const float* sD = sL + kRowsQ;
        const bool masked = (p.causal && qt0 < kr0 + 63) || qt0 + kRowsQ > p.S;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int cq = n * 8 + 2 * t;
          const float2 lse2 = *reinterpret_cast<const float2*>(sL + cq);
          const float2 dl = *reinterpret_cast<const float2*>(sD + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * n + e;
            float pr = exp2f(fmaf(st[x], c, -((e & 1) ? lse2.y : lse2.x)));
            if (masked) {
              const int qi = qt0 + cq + (e & 1);
              const int kv = (e & 2) ? kb : ka;
              if (qi >= p.S || (p.causal && kv > qi)) pr = 0.f;
            }
            st[x] = pr;
            dpt[x] = pr * (dpt[x] - ((e & 1) ? dl.y : dl.x)) * p.scale;
          }
        }
        // bf16 p^T and ds^T as the A fragments of the 4 k steps (16 q rows
        // each) of dV += p^T dO and dK += ds^T q.
        uint32_t ap[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ap[kk][r] = pack_floats(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            as[kk][r] = pack_floats(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }
        }
        const uint64_t qn_desc = hopper::desc_mn_major(sQ(s), kRowsQ * 128);
        const uint64_t on_desc = hopper::desc_mn_major(sO(s), kRowsQ * 128);
        hopper::fence_acc(dk);
        hopper::fence_acc(dv);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // q rows 16 kk.., output columns dc0.. (column block dc0 / 64)
          const uint32_t off = kk * 16 * 128 + (dc0 / 64) * kRowsQ * 128;
          hopper::wgmma_rs<DC>(dv, ap[kk], hopper::desc_at(on_desc, off), 1);
          hopper::wgmma_rs<DC>(dk, as[kk], hopper::desc_at(qn_desc, off), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(dk);
        hopper::fence_acc(dv);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    const long long row = static_cast<long long>(p.Hkv) * p.D;
    const long long base = static_cast<long long>(b) * p.S * row + hk * p.D;
    __nv_bfloat16* dK = static_cast<__nv_bfloat16*>(p.dk) + base;
    __nv_bfloat16* dV = static_cast<__nv_bfloat16*>(p.dv) + base;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int col = dc0 + n * 8 + 2 * t;
      if (col < p.D) {
        if (ka < p.S) {
          *reinterpret_cast<uint32_t*>(dK + ka * row + col) = pack_floats(dk[4 * n], dk[4 * n + 1]);
          *reinterpret_cast<uint32_t*>(dV + ka * row + col) = pack_floats(dv[4 * n], dv[4 * n + 1]);
        }
        if (kb < p.S) {
          *reinterpret_cast<uint32_t*>(dK + kb * row + col) =
              pack_floats(dk[4 * n + 2], dk[4 * n + 3]);
          *reinterpret_cast<uint32_t*>(dV + kb * row + col) =
              pack_floats(dv[4 * n + 2], dv[4 * n + 3]);
        }
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
  const float* dO = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* O = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int tid = threadIdx.x;

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[i] = s < p.S ? Q[s * p.q_ss + c] : 0.f;
    sO[i] = s < p.S ? dO[s * p.do_ss + c] : 0.f;
    sA[i] = 0.f;
  }
  __syncthreads();
  // delta = rowsum(dO * O), written for the dkv kernel.
  for (int r = tid; r < BM; r += kThreads) {
    const int s = q0 + r;
    const long long at = static_cast<long long>(bh) * p.S + s;
    float dl = 0.f;
    if (s < p.S) {
      for (int d = 0; d < D; ++d) dl = fmaf(sO[r * D + d], O[s * p.o_ss + d], dl);
      p.delta[at] = dl;
    }
    sL[r] = s < p.S ? p.lse[at] : 0.f;
    sD[r] = dl;
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
    const float* dO = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int it = i0; it < n_q; ++it) {
      const int qt0 = it * BM;
      __syncthreads();
      for (int i = tid; i < BM * D; i += kThreads) {
        const int r = i / D, c = i % D, s = qt0 + r;
        sQ[r * (D + 1) + c] = s < p.S ? Q[s * p.q_ss + c] : 0.f;
        sO[r * (D + 1) + c] = s < p.S ? dO[s * p.do_ss + c] : 0.f;
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

// The one table from head dim to the bf16 dQ kernel's configuration:
// returns f(layout) for the layout that flash_bwd_dq launches at D.
template <typename F>
int with_dq_config(int D, F f) {
  if (D <= 64) return f(DqSmem<64, 64, 2, 2>{});
  if (D <= 128) return f(DqSmem<128, 64, 2, 2>{});
  return f(DqSmem<256, 64, 2, 1>{});
}

template <int DP, int BN, int NS, int NWG>
int launch_dq_bf16(DqSmem<DP, BN, NS, NWG>, const Params& p, cudaStream_t stream) {
  using L = DqSmem<DP, BN, NS, NWG>;
  DqParams dp;
  int rc = hopper::encode_bshd(&dp.tm_q, p.q, p.B, p.S, p.H, p.D, p.q_sb, p.q_ss, p.q_sh,
                               L::kRowsM);
  if (rc == 0) {
    rc = hopper::encode_bshd(&dp.tm_do, p.dout, p.B, p.S, p.H, p.D, p.do_sb, p.do_ss, p.do_sh,
                             L::kRowsM);
  }
  if (rc == 0) {
    rc = hopper::encode_bshd(&dp.tm_k, p.k, p.B, p.S, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, BN);
  }
  if (rc == 0) {
    rc = hopper::encode_bshd(&dp.tm_v, p.v, p.B, p.S, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, BN);
  }
  if (rc != 0) return rc;
  dp.o = p.o;
  dp.dout = p.dout;
  dp.lse = p.lse;
  dp.delta = p.delta;
  dp.dq = p.dq;
  dp.S = p.S;
  dp.H = p.H;
  dp.D = p.D;
  dp.n_rep = p.H / p.Hkv;
  dp.n_q_tiles = (p.S + L::kRowsM - 1) / L::kRowsM;
  dp.o_sb = p.o_sb;
  dp.o_ss = p.o_ss;
  dp.o_sh = p.o_sh;
  dp.do_sb = p.do_sb;
  dp.do_ss = p.do_ss;
  dp.do_sh = p.do_sh;
  dp.scale = p.scale;
  dp.scale_log2 = p.scale * kLog2e;
  dp.causal = p.causal;
  const dim3 grid(p.B * p.H, dp.n_q_tiles);
  return static_cast<int>(
      launch(flash_bwd_dq_bf16_kernel<DP, BN, NS, NWG>, grid, L::kThreads, L::kBytes, dp, stream));
}

// The one table from head dim to the bf16 dK/dV kernel's configuration:
// returns f(layout) for the layout that flash_bwd_dkv launches at D.
template <typename F>
int with_dkv_config(int D, F f) {
  if (D <= 64) return f(DkvSmem<64, 64, 2, 3>{});
  if (D <= 128) return f(DkvSmem<128, 128, 1, 3>{});
  return f(DkvSmem<256, 128, 1, 2>{});
}

template <int DP, int DC, int NWG, int NS>
int launch_dkv_bf16(DkvSmem<DP, DC, NWG, NS>, const Params& p, cudaStream_t stream) {
  using L = DkvSmem<DP, DC, NWG, NS>;
  DkvParams dp;
  int rc = hopper::encode_bshd(&dp.tm_q, p.q, p.B, p.S, p.H, p.D, p.q_sb, p.q_ss, p.q_sh, kRowsQ);
  if (rc == 0) {
    rc = hopper::encode_bshd(&dp.tm_do, p.dout, p.B, p.S, p.H, p.D, p.do_sb, p.do_ss, p.do_sh,
                             kRowsQ);
  }
  if (rc == 0) {
    rc = hopper::encode_bshd(&dp.tm_k, p.k, p.B, p.S, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh,
                             L::kRowsK);
  }
  if (rc == 0) {
    rc = hopper::encode_bshd(&dp.tm_v, p.v, p.B, p.S, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh,
                             L::kRowsK);
  }
  if (rc != 0) return rc;
  dp.lse = p.lse;
  dp.delta = p.delta;
  dp.dk = p.dk;
  dp.dv = p.dv;
  dp.S = p.S;
  dp.H = p.H;
  dp.Hkv = p.Hkv;
  dp.D = p.D;
  dp.n_rep = p.H / p.Hkv;
  dp.scale = p.scale;
  dp.scale_log2 = p.scale * kLog2e;
  dp.causal = p.causal;
  // kv tiles in the slow grid dim: every (b, kv head) of tile 0, the tile
  // with the most q tiles under the causal mask, is scheduled first.
  const dim3 grid(p.B * p.Hkv, (p.S + L::kRowsK - 1) / L::kRowsK, DP / DC);
  return static_cast<int>(launch(flash_bwd_dkv_bf16_kernel<DP, DC, NWG, NS>, grid,
                                 128 * (NWG + 1), L::kBytes, dp, stream));
}

cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  const int D = p.D, T = kTile32;
  const int floats = 3 * T * D + 2 * T * (D + 1) + T * (T + 1) + 2 * T;
  const dim3 grid((p.S + T - 1) / T, p.B * p.H);
  return launch(flash_bwd_dq_f32_kernel, grid, kThreads, floats * static_cast<int>(sizeof(float)),
                p, stream);
}

cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  const int D = p.D, T = kTile32;
  const int floats = 4 * T * (D + 1) + 2 * T * D + 2 * T * (T + 1) + 2 * T;
  const dim3 grid((p.S + T - 1) / T, p.B * p.Hkv);
  return launch(flash_bwd_dkv_f32_kernel, grid, kThreads, floats * static_cast<int>(sizeof(float)),
                p, stream);
}

// st: the strides (in elements; batch, sequence, head) of q, k, v, dout
// and, when o is given, o.
Params make_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int Hkv, int D, const long long* st, float scale, int causal) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
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
  p.do_sb = st[9];
  p.do_ss = st[10];
  p.do_sh = st[11];
  p.o_sb = o ? st[12] : 0;
  p.o_ss = o ? st[13] : 0;
  p.o_sh = o ? st[14] : 0;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q, k, v, o, dout are read through their
// strides (in elements; the last dim is contiguous); lse and delta are
// contiguous fp32 [B, H, S]; dq, dk, dv are written contiguous, in the
// inputs' dtype. The caller checks shapes and dtypes, and (for the tensor
// maps of the bf16 path) a 16-byte aligned base and strides that are
// positive multiples of 16 bytes. Each returns the CUDA error of its launch
// (0 on success), or hopper::kErrNoEncodeEntryPoint / kErrEncode + CUresult
// when a tensor map cannot be made.

// dQ and delta = rowsum(dO * O), which it writes for flash_bwd_dkv.
// strides: 15, batch / sequence / head of q, k, v, dout and o in that order.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq, int dtype,
                            int B, int S, int H, int Hkv, int D, const long long* strides,
                            float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, B, S, H, Hkv,
                               D, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return with_dq_config(D, [&](auto layout) { return launch_dq_bf16(layout, p, st); });
  }
  return static_cast<int>(launch_dq_f32(p, st));
}

// dK and dV from delta as flash_bwd_dq wrote it. strides: 12, batch /
// sequence / head of q, k, v and dout in that order.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int S, int H, int Hkv, int D, const long long* strides,
                             float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk,
                               dv, B, S, H, Hkv, D, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return with_dkv_config(D, [&](auto layout) { return launch_dkv_bf16(layout, p, st); });
  }
  return static_cast<int>(launch_dkv_f32(p, st));
}

// Dynamic shared memory (bytes) of the bf16 kernel that flash_bwd_dq
// launches for head dim D.
extern "C" int flash_bwd_dq_smem_bytes(int D) {
  return with_dq_config(D, [](auto layout) { return decltype(layout)::kBytes; });
}

// Dynamic shared memory (bytes) of the bf16 kernel that flash_bwd_dkv
// launches for head dim D.
extern "C" int flash_bwd_dkv_smem_bytes(int D) {
  return with_dkv_config(D, [](auto layout) { return decltype(layout)::kBytes; });
}
