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
// step reads 6.44 GB of them, 1.92 ms. Prefilling 128 rows, the tensor cores'
// time (2 M K N operations) is about the bytes' time. The bf16 design:
//
// - Swap AB: y^T = w^T x^T on wgmma. A block owns 128 output columns (a
//   128-byte-wide strip of q, so every row request is a whole line) and up
//   to 128 rows of x; a consumer warpgroup computes them as two m64 tiles
//   whose A operand is the weight, dequantized in registers, and whose B
//   operand is x from shared memory (K-major, wgmma's N = M rounded up to 8,
//   16, 32, 64 or 128). q is read and dequantized once for all of those
//   rows: decoding 8 slots pads no row, prefilling 128 rows takes one
//   instruction per tile and k step. Above 128 rows, blocks tile M.
// - The A fragment wants, from each thread, k pairs of one column; a 32-bit
//   word of a q row holds 4 columns. Thread (warp w, g = lane / 4, t = lane
//   % 4) reads the word of columns 32w + 4g .. +3 in k rows 2t, 2t + 1,
//   2t + 8, 2t + 9 of a k step, which is the fragment of rows 16w + g and
//   16w + g + 8 of both tiles: tile T's row 16w + g is column 32w + 4g + 2T,
//   its row 16w + g + 8 column 32w + 4g + 2T + 1. The epilogue maps them
//   back. Under TMA's 128-byte swizzle those loads hit 32 distinct banks.
// - Each weight is dequantized as the plain version rounds it, bf16(bf16(q)
//   * bf16(s)), the scale applied before the product, so the kernel
//   multiplies the plain version's weights bit for bit and only the order
//   of the sums differs. Full-rate instructions only (byte permutes, an fp32
//   subtraction, a bf16x2 multiply): int-to-float and float-to-bf16
//   conversions issue at a fraction of that rate.
// - ptxas serializes wgmmas (C7513) when a register they read is written
//   while an earlier wgmma is in flight, so a warpgroup cannot dequantize
//   one k step under the products of the last. Instead each consumer
//   warpgroup dequantizes a group of k steps (a whole stage, 4, below N 128;
//   one at N 128, where 128 accumulators leave room for only 8 fragment
//   registers), issues their wgmmas as one group and waits, and two
//   consumer warpgroups take alternate stages: one dequantizes while the
//   other's products run. Every accumulator gets the same products in the
//   same order at every N. The two warpgroups' partials are added in the
//   block (odd stages, then even).
// - Copies: a producer warp keeps a ring of stages (64 k rows: the q box
//   [64, 128] and the x box [NW, 64]) full by TMA, with full and empty
//   mbarriers. The ring takes the shared memory a block can have (up to
//   ~226 KB: 25 stages of q at decode), so one block per SM keeps far more
//   than 32 KB of q in flight. Issuing a copy holds the issuing thread for a
//   while: when the consumers issued them, their wgmmas waited (3-4 us more
//   per product at decode on an H100), so a warp does only that. It makes
//   the block 288 threads, which ptxas budgets at 168 registers a thread.
// - K is split over `split` (1, 2, 4 or 8) blocks of each strip, so that
//   blocks fill the card at decode (N 4096 has only 32 strips: 4 blocks
//   each, 128 in all). The split depends on K and N alone (the wrapper's
//   launch_plan). A block with all of K writes y; otherwise each writes its
//   fp32 partial to a workspace, and a second small kernel adds the
//   partials in rank order (the order of the K ranges) and rounds to bf16.
//   It is launched as a programmatic dependent, so its launch overlaps the
//   product. A row's sum order never depends on M or on the other rows. No
//   atomics. (Thread-block clusters adding the partials through distributed
//   shared memory were tried: at one block per SM an H100 holds only 30
//   clusters of 4, so N 4096's 32 ran in two waves.)
// - fp32 (the engine's fp32 check on int8 weights): plain FMA on the CUDA
//   cores, one column per lane, 16 rows per block, w = fp32(q) * s rounded
//   once as the plain version rounds it; its warps' partial sums are added
//   in warp order.
//
// The wrapper (ops/int8_matmul.py) allocates y and the workspace, checks
// shapes, dtypes and alignment, computes the launch plan, and passes the
// current stream. This
// file allocates nothing and never synchronizes, and it sets the bf16
// kernels' shared-memory attribute once per device, at the first launch
// (before any capture), so a launch can be captured in a CUDA graph.

#include "hopper.cuh"

namespace {

// fp32 kernel
constexpr int kCols = 32;  // output columns per block
constexpr int kMaxWarps = 8;
constexpr int kMaxDevices = 64;

struct Params {
  const void* x;    // [M, K] fp32
  const int8_t* q;  // [K, N]
  const float* s;   // [N]
  void* y;          // [M, N] fp32
  int M, K, N;
  int warps;  // warps splitting K
};

// bf16 kernel
constexpr int kTileCols = 128;   // output columns per block: one 128-byte q box row
constexpr int kStageRows = 64;   // k rows per ring stage: 4 wgmma k steps
constexpr int kQStage = kStageRows * kTileCols;  // bytes of q per stage
constexpr int kMaxRows = 128;    // rows of x per block (the largest wgmma N used)
constexpr int kMaxSplit = 8;     // blocks per strip
constexpr int kRedStride = kTileCols + 4;  // floats per row of a staged partial
constexpr int kConsumers = 2;               // consumer warpgroups, alternating stages
constexpr int kThreads = 128 * kConsumers + 32;  // and a producer warp
constexpr int kSmemLimit = 232448;          // a block's dynamic shared memory on sm_90

// NW: wgmma's N (rows of x per block, padded). A stage holds the q box
// [64, 128] and the x box [NW, 64] (NW rows of 128 bytes), both 1024-byte
// aligned; the staged partial [NW, 128] fp32 (rows padded to kRedStride)
// reuses the ring once it is drained.
template <int NW>
struct Layout {
  static constexpr int kStage = kQStage + NW * 128;
  static constexpr int kRed = NW * kRedStride * 4;
  __host__ __device__ static constexpr int ring_bytes(int stages) {
    return stages * kStage > kRed ? stages * kStage : kRed;
  }
  // 1024 bytes of alignment slack, the ring, a full and an empty barrier per stage
  __host__ __device__ static constexpr int smem_bytes(int stages) {
    return 1024 + ring_bytes(stages) + 16 * stages;
  }
  // k steps whose wgmmas are issued as one group: all their A fragments are
  // live at once (8 registers a step), which at N 128 (64 accumulators a
  // tile) must fit the 168 registers a 288-thread block has.
  static constexpr int kGroupSteps = NW >= 128 ? 1 : 4;
};

struct BfParams {
  CUtensorMap tm_q;  // q [K, N] as bytes: dims (N, K), boxes of 128 columns by 64 rows
  CUtensorMap tm_x;  // x [M, K] bf16: dims (K, M), boxes of 64 columns by NW rows
  const float* s;
  __nv_bfloat16* y;
  float* ws;   // [split, M, N] fp32 partials when split > 1
  int M, N, K;
  int split;   // blocks per strip; block r sums k rows [r K / split, (r + 1) K / split)
  int stages;  // ring stages
};

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

// The A fragment of one m64 tile for a k step from the thread's four words
// of q (``u``, XORed with 0x80808080: k rows 2t, 2t + 1, 2t + 8, 2t + 9):
// byte B is the column of row g, byte B + 1 that of row g + 8, each
// dequantized as the plain version rounds it: bf16(q) * bf16(s), one bf16
// multiply (its exact product rounded once).
template <int B>
__device__ __forceinline__ void dequant_fragment(uint32_t (&a)[4], const uint32_t (&u)[4],
                                                 __nv_bfloat162 s_lo, __nv_bfloat162 s_hi) {
  a[0] = mul_bf16x2(pack_bf16_exact(int8_value<B>(u[0]), int8_value<B>(u[1])), s_lo);
  a[1] = mul_bf16x2(pack_bf16_exact(int8_value<B + 1>(u[0]), int8_value<B + 1>(u[1])), s_hi);
  a[2] = mul_bf16x2(pack_bf16_exact(int8_value<B>(u[2]), int8_value<B>(u[3])), s_lo);
  a[3] = mul_bf16x2(pack_bf16_exact(int8_value<B + 1>(u[2]), int8_value<B + 1>(u[3])), s_hi);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 out;
  out.x = *reinterpret_cast<const uint32_t*>(&lo);
  out.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = out;
}

// The reduction pass: y = bf16(ws[0] + ws[1] + ... + ws[split - 1]), the
// partials added in rank order (the order of the K ranges), 4 columns a
// thread. Launched as a programmatic dependent of the product: it may start
// while the product runs, and waits for its end before reading ws; the next
// kernel may start launching as soon as it runs.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads) int8_mm_reduce(const float* ws,
                                                                 __nv_bfloat16* y, int M, int N,
                                                                 int split) {
  hopper::wait_prerequisites();
  hopper::launch_dependents();
  const size_t quads = static_cast<size_t>(M) * N / 4;
  const size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= quads) return;
  const float4* w = reinterpret_cast<const float4*>(ws);
  float4 v = w[i];
  for (int r = 1; r < split; ++r) {
    const float4 o = w[r * quads + i];
    v.x += o.x;
    v.y += o.y;
    v.z += o.z;
    v.w += o.w;
  }
  store_bf16x4(y + 4 * i, v);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumer warpgroups only
}

template <int NW>
__global__ void __launch_bounds__(kThreads, 1) int8_mm_bf16(const __grid_constant__ BfParams p) {
  using L = Layout<NW>;
  constexpr int KG = L::kGroupSteps;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  const int NS = p.stages;
  const uint32_t bars = ring + L::ring_bytes(NS);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NS + s); };

  // Blocks x of one strip are split consecutive ranks, in k order.
  const int rank = blockIdx.x % p.split;
  const int n0 = (blockIdx.x / p.split) * kTileCols;
  const int m0 = blockIdx.y * kMaxRows;
  const int krange = p.K / p.split;
  const int kbeg = rank * krange;
  const int nst = krange / kStageRows;
  // Warp index, broadcast from lane 0 so the compiler sees it is uniform
  // across each warp: the role branches below do not diverge inside a warp.
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32), 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&p.tm_q);
    hopper::prefetch_tensormap(&p.tm_x);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 4);  // one arrival per warp of the consuming warpgroup
    }
    hopper::fence_barrier_init();
  }
  // Launched as a programmatic dependent: the launch and the lines above
  // overlap the previous kernel; nothing in global memory is touched before
  // that kernel has ended.
  hopper::wait_prerequisites();
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // Producer: one thread keeps the ring full, stages in k order. (Issuing
    // a TMA copy holds the issuing thread for a while; a consumer that did it
    // would hold its warpgroup's wgmmas.)
    if (lane == 0) {
      for (int j = 0; j < nst; ++j) {
        const int s = j % NS;
        hopper::mbar_wait(empty(s), ((j / NS) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full(s), L::kStage);
        const uint32_t dst = ring + s * L::kStage;
        const int k0 = kbeg + j * kStageRows;
        hopper::tma_load_2d(dst, &p.tm_q, full(s), n0, k0);
        hopper::tma_load_2d(dst + kQStage, &p.tm_x, full(s), k0, m0);
      }
    }
    __syncwarp();
  } else {
    // Consumer warpgroup wg takes stages wg, wg + 2, ...; its warp w
    // dequantizes columns 32w .. 32w + 31 of the strip.
    const int wg = warp / 4;
    const int w = warp % 4;
    const int g = lane >> 2;
    const int t = lane & 3;
    __nv_bfloat162 sc[4];  // bf16(s) of columns 32w + 4g + b, in both halves
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = n0 + 32 * w + 4 * g + b;
      sc[b] = __bfloat162bfloat162(__float2bfloat16_rn(col < p.N ? p.s[col] : 0.f));
    }
    float acc[2][NW / 2];  // the two m64 tiles: rows are columns of y, columns rows of y
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[T][i] = 0.f;
    // Nothing but the wgmmas touches the accumulators while one is in flight.
    hopper::fence_acc(acc[0]);
    hopper::fence_acc(acc[1]);
    // Byte offsets of the thread's word in a q row r under the swizzle
    // (16-byte chunk c of row r at chunk c ^ (r % 8)), for r % 8 = 2t and 2t + 1.
    const int chunk = 2 * w + (g >> 2);
    const int off0 = ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
    const int off1 = ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
    for (int j = wg; j < nst; j += kConsumers) {
      const int s = j % NS;
      hopper::mbar_wait(full(s), (j / NS) & 1);
      const unsigned char* qs = ring_ptr + s * L::kStage;
      const uint32_t xs = ring + s * L::kStage + kQStage;
      // KG k steps at a time: their words of q, their fragments, then their
      // wgmmas as one group, waited on before the next fragments are built
      // (ptxas serializes wgmmas, C7513, if a fragment is built while an
      // earlier wgmma is in flight): the other warpgroup's stage is what
      // overlaps this one's products.
#pragma unroll
      for (int k0 = 0; k0 < 4; k0 += KG) {
        uint32_t u[KG][4];
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const unsigned char* qr = qs + ((k0 + i) * 16 + 2 * t) * kTileCols;
          u[i][0] = lds32(qr + off0);
          u[i][1] = lds32(qr + kTileCols + off1);
          u[i][2] = lds32(qr + 8 * kTileCols + off0);
          u[i][3] = lds32(qr + 9 * kTileCols + off1);
        }
        uint32_t a[KG][2][4];  // [k step][tile]
#pragma unroll
        for (int i = 0; i < KG; ++i) {
#pragma unroll
          for (int r = 0; r < 4; ++r) u[i][r] ^= 0x80808080u;
          dequant_fragment<0>(a[i][0], u[i], sc[0], sc[1]);
          dequant_fragment<2>(a[i][1], u[i], sc[2], sc[3]);
          hopper::fence_regs(a[i][0]);
          hopper::fence_regs(a[i][1]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const uint64_t desc = hopper::desc_k_major(xs + (k0 + i) * 32);
          hopper::wgmma_rs_k<NW>(acc[0], a[i][0], desc, 1);
          hopper::wgmma_rs_k<NW>(acc[1], a[i][1], desc, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      }
      hopper::fence_acc(acc[0]);
      hopper::fence_acc(acc[1]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }
    // The reduction pass may start launching (it waits for this grid's end).
    hopper::launch_dependents();
    // The block's partial [NW, 128] over the drained ring: accumulator
    // d[4n + e] of tile T is row 8n + 2t + (e & 1) of y and column
    // 32w + 4g + 2T + (e >> 1), so e = 0, 2 of both tiles make four adjacent
    // columns of one row. Warpgroup 1 stores its sums (odd stages), then
    // warpgroup 0 adds its own (even stages).
    consumer_sync();
    float* red = reinterpret_cast<float*>(ring_ptr);
#pragma unroll
    for (int pass = 1; pass >= 0; --pass) {
      if (wg == pass) {
#pragma unroll
        for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float4* r =
                reinterpret_cast<float4*>(red + (8 * n + 2 * t + e) * kRedStride + 32 * w + 4 * g);
            float4 v = make_float4(acc[0][4 * n + e], acc[0][4 * n + e + 2], acc[1][4 * n + e],
                                   acc[1][4 * n + e + 2]);
            if (pass == 0) {
              const float4 o = *r;
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            *r = v;
          }
        }
      }
      if (pass == 1) consumer_sync();
    }
  }

  // The block's sums, 4 columns a thread: y in bf16 when the block has all
  // of K, else its fp32 partial for the reduction pass.
  __syncthreads();
  for (int q4 = threadIdx.x; q4 < NW * kTileCols / 4; q4 += kThreads) {
    const int row = q4 / (kTileCols / 4);
    const int col4 = q4 % (kTileCols / 4);
    const int m = m0 + row;
    const int n = n0 + 4 * col4;
    if (m >= p.M || n >= p.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(ring_ptr + (row * kRedStride + 4 * col4) * 4);
    if (p.split == 1) {
      store_bf16x4(p.y + static_cast<size_t>(m) * p.N + n, v);
    } else {
      *reinterpret_cast<float4*>(p.ws + (static_cast<size_t>(rank) * p.M + m) * p.N + n) = v;
    }
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

template <int N>
struct Nw {
  static constexpr int value = N;
};

// f(Nw<wgmma_n>{}) for the wgmma N's the kernel is built for, else an error.
template <typename F>
int with_nw(int wgmma_n, F f) {
  switch (wgmma_n) {
    case 8: return f(Nw<8>{});
    case 16: return f(Nw<16>{});
    case 32: return f(Nw<32>{});
    case 64: return f(Nw<64>{});
    case 128: return f(Nw<128>{});
    default: return cudaErrorInvalidValue;
  }
}

// Raises the bf16 kernel's dynamic shared-memory limit once per device
// (before any capture: a captured launch must not set it).
template <int NW>
int prepare_bf16() {
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    void (*kernel)(BfParams) = int8_mm_bf16<NW>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return 0;
}

// Launches the bf16 kernel on `stream`, and the reduction pass after it when
// split > 1; returns the CUDA error of the launches, or an error code of
// hopper.cuh. Refuses a plan the kernel cannot run: a split that is not a
// power of two up to kMaxSplit dividing K's stages, or without a workspace;
// no ring stage; more shared memory than a block has; fewer rows than M (up
// to kMaxRows) in wgmma's N.
template <int NW>
int launch_bf16(const void* x, const void* q, const float* s, void* y, float* ws, int M, int K,
                int N, int split, int stages, cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 ||
      (K / kStageRows) % split != 0 || (split > 1 && ws == nullptr) || stages < 1 ||
      Layout<NW>::smem_bytes(stages) > kSmemLimit || NW < (M < kMaxRows ? M : kMaxRows))
    return cudaErrorInvalidValue;
  int rc = prepare_bf16<NW>();
  if (rc != 0) return rc;
  BfParams p;
  rc = hopper::encode_2d(&p.tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, kTileCols,
                         kStageRows);
  if (rc != 0) return rc;
  rc = hopper::encode_2d(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2ll * K, 64, NW);
  if (rc != 0) return rc;
  p.s = s;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ws = ws;
  p.M = M;
  p.N = N;
  p.K = K;
  p.split = split;
  p.stages = stages;
  // Both kernels are programmatic dependents of what precedes them on the
  // stream (each waits for it to end before touching global memory).
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileCols - 1) / kTileCols * split, (M + kMaxRows - 1) / kMaxRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<NW>::smem_bytes(stages);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, int8_mm_bf16<NW>, p);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  cfg.gridDim = dim3(static_cast<unsigned>(
      (static_cast<size_t>(M) * N / 4 + kReduceThreads - 1) / kReduceThreads));
  cfg.blockDim = dim3(kReduceThreads);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, int8_mm_reduce, static_cast<const float*>(ws),
                           static_cast<__nv_bfloat16*>(y), M, N, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x and y). Needs K a multiple of 64, N of 32, and x
// and q 16-byte aligned (the wrapper checks). workspace, split, stages and
// wgmma_n are the bf16 kernel's launch plan (ops/int8_matmul.py launch_plan:
// workspace holds split * M * N fp32 partials when split > 1; the fp32
// kernel ignores all four). Returns 0 on success, else the CUDA error of the
// launch or an error code of hopper.cuh.
extern "C" int int8_matmul(const void* x, const void* q, const void* s, void* y, int dtype,
                           int M, int K, int N, void* stream, void* workspace, int split,
                           int stages, int wgmma_n) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params p;
    p.x = x;
    p.q = static_cast<const int8_t*>(q);
    p.s = static_cast<const float*>(s);
    p.y = y;
    p.M = M;
    p.K = K;
    p.N = N;
    const int k64 = K / 64;
    p.warps = k64 % 8 == 0 ? 8 : k64 % 4 == 0 ? 4 : k64 % 2 == 0 ? 2 : 1;
    const dim3 grid(N / kCols, (M + kRowsF32 - 1) / kRowsF32);
    int8_mm_f32<<<grid, 32 * p.warps, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return with_nw(wgmma_n, [&](auto nw) {
    return launch_bf16<decltype(nw)::value>(x, q, static_cast<const float*>(s), y,
                                            static_cast<float*>(workspace), M, K, N, split,
                                            stages, st);
  });
}
