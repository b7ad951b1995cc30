// Decode attention for Hopper (sm_90a), bound to Python with ctypes: one
// query token per sequence against that sequence's rows of a KV cache.
//
// out[b, h] = sum_j p[b, h, j] v[b, j, h / n_rep] (+ p_self v_new[b, h / n_rep])
// over the cache rows j < lengths[b] (clamped to [0, S_max]), with
// s_j = fp32(q . k_j) * D^-0.5, the optional "self" score s_self = fp32(q .
// k_new) * D^-0.5, and p the fp32 softmax over those scores rounded to q's
// dtype before the product with v, as the reference rounds it. q is [B, 1, H,
// D], the caches one layer's [B, S_max, Hkv, D] (any batch, row and head
// strides, unit last stride), k_new and v_new [B, 1, Hkv, D], out [B, 1, H,
// D]; bf16 or fp32, D a multiple of 8 up to 256. A slot with no row and no
// self column gets zeros.
//
// Replaces no Pallas kernel: the reference leaves a decode step's cached
// attention to XLA, which fuses it over the bf16 cache as it lies
// (ray_tpu/models/generation.py: _attend_prefix_plus_self :151-180, the
// engine's per-slot step; _attend_cached :61-76 at S = 1, generate's loop).
//
// Bound on an H100 SXM (3.35 TB/s): the bytes of each slot's valid K and V
// rows, read once. A serve_7b step at position 160 of 512 (8 slots, 32 heads
// of 128) reads 21 MB per layer (6.3 us); its products are ~1 FLOP per byte,
// far below the ~295 where the tensor cores would bind, so CUDA cores do
// them and no wgmma is involved.
//
// Design: one launch per call, a thread-block cluster of C blocks (C in 1, 2,
// 4, 8, from the wrapper's launch plan) per (slot, kv head, group of G of its
// q heads), nothing in device memory but the operands.
//
// - The split follows the lengths on the device. Each block reads
//   lengths[b] and takes its rank's share of the slot's ceil(n / R) tiles of
//   R rows: C shares of consecutive tiles, the first (tiles % C) one tile
//   longer (`share_of`; ops/decode_attention.py `share_of` is its Python
//   mirror, which the CPU tests hold to cover [0, n) exactly once). No host
//   read, so a CUDA graph replays it at any lengths. A block with no share
//   still takes part in every cluster barrier.
// - TMA row tiles. One producer warp keeps R x D tiles of its share in flight
//   through a ring of `stages` mbarrier stages: all K tiles, then the V
//   tiles, which do not depend on the softmax and so load while the scores
//   and the cluster's exchange run. The ring is as deep as the card allows
//   while it still holds every cluster of the grid at once, as CUDA's
//   occupancy query says at the first launch of each shape (`choose_ring`;
//   at most a share's K and V tiles: at serve_7b's step, 10 stages hold a
//   block's whole share of 5 K and 5 V tiles). A tile can carry rows at or
//   past n (stale rows, NaN included): every loop is bounded by n, never by
//   the tile, so they cannot reach the output.
// - Scores in shared memory only: four consumer warps dot each K row with
//   the G heads' q (held in registers), tpr threads per row reading 16
//   bytes each, reduced by xor shuffles, fp32 scores [G][share] kept in the
//   block.
// - Softmax statistics across the cluster: each block writes its (m_r, l_r)
//   per head (-inf and 0 for an empty share) into row r of every block's
//   statistics through distributed shared memory (stores, which do not wait
//   on a round trip as loads would); after a cluster barrier every block
//   combines the C rows in rank order, m = max(s_self, m_r), l = sum_r l_r
//   exp(m_r - m) + exp(s_self - m) (an empty share's term skipped: no
//   exp(-inf - -inf)), so every block holds the same bits.
// - p rounded as the reference rounds: p = round_to<T>(exp(s - m) / l),
//   normalised in fp32 and rounded to the dtype, overwrites its score; the
//   block sums p v over its valid V rows in fp32, per thread, then across
//   the row lanes in lane order (in the ring's memory, free by then).
// - The partials reduced through distributed shared memory: rank r owns a
//   C-th of the G * D outputs; every block writes its partial of each
//   output into row `rank` of the owner's gather, and after a second
//   cluster barrier each owner adds its outputs' C partials in rank order,
//   rounds the sum to T and adds the self term as the reference does,
//   bf16(bf16(p_self) v_new) added in the dtype. No block reads another's
//   shared memory, so none waits for the others before it exits; a relaxed
//   barrier arrival at the start, waited before the first remote write,
//   makes sure every block of the cluster has started.
// - Deterministic: no atomics; every sum's order is fixed by the shapes and
//   the plan, so two launches agree bit for bit.
// - Capturable: no host read, no allocation, a launch by cudaLaunchKernelEx
//   with the cluster dimension on the caller's stream. The tensor maps are
//   encoded on the host at each call (a graph bakes the cache's address
//   in). The dynamic shared-memory limit is raised, and the ring chosen by
//   the occupancy query (an error if no cluster fits), once per kernel,
//   device and shape of launch, at the first call: the callers warm up
//   before they capture.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 128;            // four warps: scores, softmax, p v
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxRows = 256;              // a TMA box's rows at most
constexpr int kSmemLimit = 232448;         // dynamic shared memory of a block

struct Params {
  CUtensorMap tm_k;  // the K cache [B, S_max, Hkv, D]: boxes of `rows` rows x D of one head
  CUtensorMap tm_v;  // the V cache, the same
  const void* q;
  const long long* lengths;
  const void* k_new;  // null: no self column
  const void* v_new;
  void* out;
  int H, Hkv, S_max, D, n_rep, groups, cluster, rows, stages, share_rows, tpr, has_self;
  float scale;
};

// Byte offsets of a block's dynamic shared memory (the one account of it:
// `choose_ring` sizes launches by its total): the ring of `stages` tiles
// [rows x D] of T (`stage` bytes apart), which the row lanes' p v sums
// [128 / tpr][G][tpr * 8] reuse after the last tile; the cluster's p v
// partials of the outputs this block owns [C][chunk] and the cluster's
// softmax statistics [C][G][2] (each block writes its own row of both in
// every block of the cluster); the combined statistics [G][2]; the self
// scores [G]; the scores, then p, [G][share_rows]; the full and empty
// mbarriers of each stage. A block owns outputs [rank * chunk, (rank + 1) *
// chunk) of the G * D, chunk = ceil(G * D / C).
struct Layout {
  int stage, chunk, gather, stats, mstat, self, sc, bars, total;
};

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ __forceinline__ Layout layout(int G, int D, int elem, int rows, int stages,
                                                  int share_rows, int cluster) {
  Layout l;
  l.stage = (rows * D * elem + 127) & ~127;  // each tile 128-byte aligned, as TMA wants
  l.chunk = (G * D + cluster - 1) / cluster;
  const int ring = stages * l.stage;
  const int red = 4096 * G;  // 128 / tpr lanes x tpr * 8 columns x 4 bytes, per head
  int off = align16(ring > red ? ring : red);
  l.gather = off;
  off += align16(cluster * l.chunk * 4);
  l.stats = off;
  off += align16(cluster * G * 8);
  l.mstat = off;
  off += align16(G * 8);
  l.self = off;
  off += align16(G * 4);
  l.sc = off;
  off += align16(share_rows * G * 4);
  l.bars = off;
  l.total = off + 16 * stages;
  return l;
}

// Heads of a kv group one cluster takes: the most of 8, 4, 2, 1 that divides
// n_rep (ops/decode_attention.py `heads_per_block`).
inline int heads_per_block(int n_rep) {
  return n_rep % 8 == 0 ? 8 : n_rep % 4 == 0 ? 4 : n_rep % 2 == 0 ? 2 : 1;
}

// Rows a block's scores must hold: the most tiles a share can have.
inline int share_rows_of(int S_max, int rows, int cluster) {
  const int tiles = (S_max + rows - 1) / rows;
  return (tiles + cluster - 1) / cluster * rows;
}

// Tiles [t0, t1) of the ceil(n / rows) tiles of a slot that rank `rank` of a
// cluster of `cluster` blocks takes: consecutive shares, the first
// tiles % cluster one tile longer. (ops/decode_attention.py `share_of` is the
// Python mirror the CPU tests check.)
__device__ __forceinline__ void share_of(int n, int rows, int cluster, int rank, int& t0,
                                         int& t1) {
  const int tiles = (n + rows - 1) / rows;
  const int per = tiles / cluster, extra = tiles % cluster;
  t0 = rank * per + min(rank, extra);
  t1 = t0 + per + (rank < extra ? 1 : 0);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T (round to nearest even), as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Eight consecutive elements (16 or 32 bytes, 16-byte aligned; global or
// shared memory) as floats.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Each of the G heads' q (this thread's eight columns of each, in `qr`)
// dotted with two K rows, whose same eight columns this thread holds in `ka`
// and `kb` (zeros where a row has none): the fp32 sums over each row's `tpr`
// threads (the two shuffle chains interleaved), scaled, stored at
// da[g * stride] and db[g * stride] by the row's first thread when
// `store_a`, `store_b`. Every thread of the warp calls it (the shuffles need
// whole warps).
template <int G>
__device__ __forceinline__ void dot_heads(const float (&qr)[G][8], const float (&ka)[8],
                                          const float (&kb)[8], int tpr, float scale,
                                          bool store_a, bool store_b, float* da, float* db,
                                          int stride) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sa = fmaf(qr[g][e], ka[e], sa);
      sb = fmaf(qr[g][e], kb[e], sb);
    }
    for (int off = tpr / 2; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    if (store_a) da[g * stride] = sa * scale;
    if (store_b) db[g * stride] = sb * scale;
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Block (rank, (b * Hkv + kv head) * groups + group) of a cluster of
// p.cluster blocks along x. Cluster barrier phases: 0, every block has
// started (a relaxed arrive at the start, waited before the first remote
// write); 1, every block's statistics are written in every block; 2, every
// block's partials are written in their owners. No block touches another's
// shared memory after phase 2, so each exits when it has stored its outputs.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G <= 4 ? 4 : 2)
    decode_attention_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(G, p.D, sizeof(T), p.rows, p.stages, p.share_rows, p.cluster);
  float* gather = reinterpret_cast<float*>(smem + L.gather);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* mstat = reinterpret_cast<float*>(smem + L.mstat);
  float* self_sc = reinterpret_cast<float*>(smem + L.self);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  const uint32_t ring = hopper::smem_u32(smem);
  const uint32_t bars = hopper::smem_u32(smem + L.bars);
  const uint32_t tile_bytes = p.rows * p.D * sizeof(T), stage_bytes = L.stage;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (p.stages + s); };

  const int rank = hopper::cluster_rank();
  const int grp = blockIdx.y % p.groups, bk = blockIdx.y / p.groups;
  const int b = bk / p.Hkv, kvh = bk % p.Hkv;
  const int h0 = kvh * p.n_rep + grp * G;
  const long long len = p.lengths[b];
  const int n = static_cast<int>(len < 0 ? 0 : (len > p.S_max ? p.S_max : len));
  int t0, t1;
  share_of(n, p.rows, p.cluster, rank, t0, t1);
  const int nt = t1 - t0, row0 = t0 * p.rows;
  const int share = nt > 0 ? min(t1 * p.rows, n) - row0 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  hopper::cluster_arrive_relaxed();  // phase 0
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: tile i < nt is K tile i, else V tile i - nt, into stage
    // i % stages once that stage's previous tile is consumed. Tiles before
    // nt + stages reuse only stages of K tiles, which the consumers free
    // before phase 1; the rest wait for V tiles, which they free after it.
    const int total = 2 * nt, before = min(total, nt + p.stages);
    auto load_tile = [&](int i) {
      if (lane != 0) return;
      const int s = i % p.stages;
      if (i >= p.stages) hopper::mbar_wait(empty_bar(s), (i / p.stages - 1) & 1);
      hopper::mbar_arrive_expect_tx(full_bar(s), tile_bytes);
      const bool is_k = i < nt;
      const int row = row0 + (is_k ? i : i - nt) * p.rows;
      hopper::tma_load_4d(ring + s * stage_bytes, is_k ? &p.tm_k : &p.tm_v, full_bar(s), 0, kvh,
                          row, b);
    };
    if (lane == 0 && nt > 0) {
      hopper::prefetch_tensormap(&p.tm_k);
      hopper::prefetch_tensormap(&p.tm_v);
    }
    for (int i = 0; i < before; ++i) load_tile(i);
    __syncwarp();
    hopper::cluster_wait();  // phase 0
    hopper::cluster_sync();  // phase 1
    for (int i = before; i < total; ++i) load_tile(i);
    __syncwarp();
    hopper::cluster_sync();  // phase 2
    return;
  }

  const int tpr = p.tpr, lanes = kConsumers / tpr;
  const int rl = threadIdx.x / tpr, d0 = (threadIdx.x % tpr) * 8;
  const bool first = threadIdx.x % tpr == 0, has_cols = d0 < p.D;
  float qr[G][8];
  {
    const T* q = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.H + h0) * p.D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
      if (has_cols) load8(q + g * p.D + d0, qr[g]);
    }
  }
  // the self score, by every block alike (the same bits in each)
  if (p.has_self && warp == 0) {
    float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float none[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const T* kn =
        static_cast<const T*>(p.k_new) + (static_cast<long long>(b) * p.Hkv + kvh) * p.D;
    if (rl == 0 && has_cols) load8(kn + d0, kf);
    dot_heads<G>(qr, kf, none, tpr, p.scale, rl == 0 && first, false, self_sc, self_sc, 1);
  }
  // scores of the share's K rows, two rows per thread at a time
  for (int j = 0; j < nt; ++j) {
    const int s = j % p.stages;
    hopper::mbar_wait(full_bar(s), (j / p.stages) & 1);
    const T* tile = reinterpret_cast<const T*>(smem + s * stage_bytes);
    const int rows = min(p.rows, share - j * p.rows);
    for (int r0 = 0; r0 < rows; r0 += 2 * lanes) {  // the same bound for every thread
      const int ra = r0 + rl, rb = ra + lanes;
      float ka[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float kb[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (has_cols && ra < rows) load8(tile + ra * p.D + d0, ka);
      if (has_cols && rb < rows) load8(tile + rb * p.D + d0, kb);
      float* dst = sc + j * p.rows;
      dot_heads<G>(qr, ka, kb, tpr, p.scale, first && ra < rows, first && rb < rows, dst + ra,
                   dst + rb, p.share_rows);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty_bar(s));
  }
  consumer_sync();
  hopper::cluster_wait();  // phase 0: every block of the cluster has started
  // the share's max and sum of exp per head, a warp per head, written into
  // every block's row `rank` of the statistics
  for (int g = warp; g < G; g += kConsumers / 32) {
    const float* row = sc + g * p.share_rows;
    float m = -INFINITY;
    for (int r = lane; r < share; r += 32) m = fmaxf(m, row[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int r = lane; r < share; r += 32) l += expf(row[r] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane < p.cluster) {
      float* dst = hopper::cluster_map(stats + (rank * G + g) * 2, lane);
      dst[0] = m;
      dst[1] = l;
    }
  }
  hopper::cluster_sync();  // phase 1
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = p.has_self ? self_sc[g] : -INFINITY;
    for (int r = 0; r < p.cluster; ++r) m = fmaxf(m, stats[(r * G + g) * 2]);
    float l = 0.f;
    for (int r = 0; r < p.cluster; ++r) {
      const float lr = stats[(r * G + g) * 2 + 1];
      if (lr != 0.f) l += lr * expf(stats[(r * G + g) * 2] - m);
    }
    if (p.has_self) l += expf(self_sc[g] - m);
    mstat[2 * g] = m;
    mstat[2 * g + 1] = l;
  }
  consumer_sync();
  for (int i = threadIdx.x; i < G * share; i += kConsumers) {
    const int g = i / share, r = i % share;
    float* x = sc + g * p.share_rows + r;
    *x = round_to<T>(expf(*x - mstat[2 * g]) / mstat[2 * g + 1]);
  }
  consumer_sync();
  // p v over the share's valid V rows
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int j = 0; j < nt; ++j) {
    const int i = nt + j, s = i % p.stages;
    hopper::mbar_wait(full_bar(s), (i / p.stages) & 1);
    const T* tile = reinterpret_cast<const T*>(smem + s * stage_bytes);
    const int rows = min(p.rows, share - j * p.rows);
    if (has_cols) {
      for (int r = rl; r < rows; r += lanes) {
        float vf[8];
        load8(tile + r * p.D + d0, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = sc[g * p.share_rows + j * p.rows + r];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty_bar(s));
  }
  consumer_sync();  // every tile consumed: the ring is free
  float* red = reinterpret_cast<float*>(smem);
  const int width = tpr * 8;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(rl * G + g) * width + d0 + e] = acc[g][e];
  consumer_sync();
  // the block's partial of each output, summed over the row lanes in lane
  // order, written into row `rank` of its owner's gather
  for (int i = threadIdx.x; i < G * p.D; i += kConsumers) {
    const int g = i / p.D, d = i % p.D;
    float s = 0.f;
    for (int r = 0; r < lanes; ++r) s += red[(r * G + g) * width + d];
    const int owner = i / L.chunk;
    *hopper::cluster_map(gather + rank * L.chunk + i - owner * L.chunk, owner) = s;
  }
  hopper::cluster_sync();  // phase 2
  // the outputs this block owns: the C partials in rank order, rounded to T,
  // plus the self term rounded as the reference rounds it
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h0) * p.D;
  const T* vn = p.has_self
                    ? static_cast<const T*>(p.v_new) + (static_cast<long long>(b) * p.Hkv + kvh) * p.D
                    : nullptr;
  for (int li = threadIdx.x; li < L.chunk; li += kConsumers) {
    const int i = rank * L.chunk + li;
    if (i >= G * p.D) break;
    const int g = i / p.D, d = i % p.D;
    float s = 0.f;
    for (int r = 0; r < p.cluster; ++r) s += gather[r * L.chunk + li];
    float o = round_to<T>(s);
    if (p.has_self) {
      const float ps = round_to<T>(expf(self_sc[g] - mstat[2 * g]) / mstat[2 * g + 1]);
      o = round_to<T>(o + round_to<T>(ps * to_f(vn[d])));
    }
    out[i] = from_f<T>(o);
  }
}

// A launch's ring: its stages, the block's dynamic shared memory (`layout`)
// and how many of its clusters the card holds at once.
struct Ring {
  int stages, smem, clusters;
};

// Rings already chosen, per kernel, device and shape of launch.
struct Chosen {
  const void* fn;
  int dev, D, rows, share_rows, cluster, max_stages, grid_clusters;
  Ring ring;
};
std::mutex g_mu;
std::vector<Chosen> g_chosen;

// The ring of a launch of `grid_clusters` clusters of `cluster` blocks,
// chosen once per kernel, device and shape: the most stages, from
// `max_stages` down to 2, at which the card holds every cluster of the grid
// at once (CUDA's occupancy query at that shared memory); when no depth
// lets it, the most stages among those that hold the most clusters. Raises
// the kernel's dynamic shared-memory limit and carveout first (once per
// kernel and device). Returns 0, cudaErrorInvalidValue when not even 2
// stages fit a block, cudaErrorLaunchOutOfResources when no cluster fits
// the card, or another CUDA error.
template <typename T, int G>
int choose_ring(int D, int rows, int share_rows, int cluster, int max_stages, int grid_clusters,
                Ring* out) {
  void (*kernel)(Params) = decode_attention_kernel<T, G>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  bool raised = false;
  for (const Chosen& e : g_chosen) {
    if (e.fn != fn || e.dev != dev) continue;
    raised = true;
    if (e.D == D && e.rows == rows && e.share_rows == share_rows && e.cluster == cluster &&
        e.max_stages == max_stages && e.grid_clusters == grid_clusters) {
      *out = e.ring;
      return 0;
    }
  }
  if (!raised) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    // all of the SM's unified memory as shared memory, for as many blocks
    // per SM as the ring leaves room for
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  Ring best = {0, 0, 0};
  bool fits = false;
  for (int stages = max_stages < 2 ? 2 : max_stages; stages >= 2; --stages) {
    const int smem = layout(G, D, sizeof(T), rows, stages, share_rows, cluster).total;
    if (smem > kSmemLimit) continue;
    fits = true;
    int count = 0;
    cfg.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (count > best.clusters) best = {stages, smem, count};
    if (count >= grid_clusters) break;
  }
  if (!fits) return cudaErrorInvalidValue;
  if (best.clusters < 1) return cudaErrorLaunchOutOfResources;
  g_chosen.push_back({fn, dev, D, rows, share_rows, cluster, max_stages, grid_clusters, best});
  *out = best;
  return 0;
}

template <typename T, int G>
int launch(Params& p, int B, cudaStream_t stream) {
  Ring ring;
  const int grid_clusters = B * p.Hkv * p.groups;
  const int rc = choose_ring<T, G>(p.D, p.rows, p.share_rows, p.cluster, p.stages, grid_clusters,
                                   &ring);
  if (rc != 0) return rc;
  p.stages = ring.stages;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, grid_clusters, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ring.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, G>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// f(tag) with the kernel's template arguments for dtype (0 fp32, 1 bf16) and G.
template <typename T, int G>
struct Kernel {
  using type = T;
  static constexpr int heads = G;
};

template <typename F>
int with_kernel(int dtype, int G, F f) {
  if (dtype == 1) {
    switch (G) {
      case 1: return f(Kernel<__nv_bfloat16, 1>{});
      case 2: return f(Kernel<__nv_bfloat16, 2>{});
      case 4: return f(Kernel<__nv_bfloat16, 4>{});
      case 8: return f(Kernel<__nv_bfloat16, 8>{});
    }
  } else if (dtype == 0) {
    switch (G) {
      case 1: return f(Kernel<float, 1>{});
      case 2: return f(Kernel<float, 2>{});
      case 4: return f(Kernel<float, 4>{});
      case 8: return f(Kernel<float, 8>{});
    }
  }
  return cudaErrorInvalidValue;
}

int encode_maps(Params& p, const void* k, const void* v, int dtype, int B, int Hkv, int S_max,
                int D, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                long long v_ss, long long v_sh, int rows) {
  const CUtensorMapDataType type =
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int elem = dtype == 1 ? 2 : 4;
  int rc = hopper::encode_bshd_rows(&p.tm_k, type, elem, k, B, S_max, Hkv, D, k_sb, k_ss, k_sh,
                                    rows);
  if (rc != 0) return rc;
  return hopper::encode_bshd_rows(&p.tm_v, type, elem, v, B, S_max, Hkv, D, v_sb, v_ss, v_sh,
                                  rows);
}

// The launch's parameters but the tensor maps and the pointers; false for
// shapes or a plan the kernel does not take.
bool plan_params(Params& p, int dtype, int B, int H, int Hkv, int S_max, int D, int cluster,
                 int tile_rows, int max_stages) {
  if (!((dtype == 0 || dtype == 1) && B >= 1 && Hkv >= 1 && H % Hkv == 0 && S_max >= 1 &&
        D >= 8 && D <= 256 && D % 8 == 0 && static_cast<long long>(B) * H <= 65535 &&
        (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) && tile_rows >= 1 &&
        tile_rows <= kMaxRows && max_stages >= 2))
    return false;
  p.H = H;
  p.Hkv = Hkv;
  p.S_max = S_max;
  p.D = D;
  p.n_rep = H / Hkv;
  p.groups = p.n_rep / heads_per_block(p.n_rep);
  p.cluster = cluster;
  p.rows = tile_rows;
  p.stages = max_stages;  // until the ring is chosen
  p.share_rows = share_rows_of(S_max, tile_rows, cluster);
  p.tpr = 1;
  while (p.tpr * 8 < D) p.tpr *= 2;
  return true;
}

}  // namespace

// dtype 0 = fp32, 1 = bf16. k_new and v_new both null (no self column) or
// both set. cluster, tile_rows and max_stages are the wrapper's launch plan
// (ops/decode_attention.py launch_plan); the ring's stages, at most
// max_stages, are chosen at the first launch of each shape (`choose_ring`).
// Returns 0, a CUDA error (cudaErrorInvalidValue for shapes or a plan the
// kernel does not take, which the wrapper checks first, or a cache too long
// for a block's shared memory; cudaErrorLaunchOutOfResources when no cluster
// of the plan's shape fits on the card), or an error code of hopper.cuh.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                const void* k_new, const void* v_new, void* out, int dtype, int B,
                                int H, int Hkv, int S_max, int D, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                float scale, int cluster, int tile_rows, int max_stages,
                                void* stream) {
  Params p;
  if (!plan_params(p, dtype, B, H, Hkv, S_max, D, cluster, tile_rows, max_stages) ||
      (k_new == nullptr) != (v_new == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = encode_maps(p, k, v, dtype, B, Hkv, S_max, D, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                       tile_rows);
  if (rc != 0) return rc;
  p.q = q;
  p.lengths = static_cast<const long long*>(lengths);
  p.k_new = k_new;
  p.v_new = v_new;
  p.out = out;
  p.has_self = k_new != nullptr;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kernel(dtype, heads_per_block(p.n_rep), [&](auto kern) {
    using K = decltype(kern);
    return launch<typename K::type, K::heads>(p, B, st);
  });
}

// The ring a launch at these shapes and plan uses (`choose_ring`, chosen now
// if no launch has chosen it yet) into ring[0..2] (ints): its stages, the
// block's dynamic shared memory in bytes, and how many of its clusters the
// card holds at once. Returns 0 or an error as decode_attention does.
extern "C" int decode_attention_ring(int dtype, int B, int H, int Hkv, int S_max, int D,
                                     int cluster, int tile_rows, int max_stages, void* ring) {
  Params p;
  if (!plan_params(p, dtype, B, H, Hkv, S_max, D, cluster, tile_rows, max_stages))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_kernel(dtype, heads_per_block(p.n_rep), [&](auto kern) {
    using K = decltype(kern);
    Ring r;
    const int rc = choose_ring<typename K::type, K::heads>(
        D, tile_rows, p.share_rows, cluster, max_stages, B * Hkv * p.groups, &r);
    if (rc != 0) return rc;
    int* o = static_cast<int*>(ring);
    o[0] = r.stages;
    o[1] = r.smem;
    o[2] = r.clusters;
    return 0;
  });
}
