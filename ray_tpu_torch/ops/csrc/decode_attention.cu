// Decode attention for Hopper (sm_90a), bound to Python with ctypes: one
// query token per sequence against that sequence's rows of a KV cache.
//
// out[b, h] = sum_j p[b, h, j] v[b, j, h / n_rep] (+ p_self v_new[b, h / n_rep])
// over the cache rows j < lengths[b] (clamped to S_max), with
// s_j = fp32(q . k_j) * D^-0.5, the optional "self" score s_self = fp32(q .
// k_new) * D^-0.5, and p the fp32 softmax over those scores rounded to q's
// dtype before the product with v, as the reference rounds it. q is [B, 1, H,
// D], the caches one layer's [B, S_max, Hkv, D] (any batch, row and head
// strides, unit last stride), k_new and v_new [B, 1, Hkv, D], out [B, 1, H,
// D]; bf16 or fp32, D a multiple of 8 up to 256.
//
// Replaces no Pallas kernel: the reference leaves a decode step's cached
// attention to XLA, which fuses it over the bf16 cache as it lies
// (ray_tpu/models/generation.py: _attend_prefix_plus_self :151-180, the
// engine's per-slot step; _attend_cached :61-76 at S = 1, generate's loop).
// The port's plain version upcast the whole [B, S_max, H, D] cache to fp32
// and copied it permuted in every layer and step.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes of each slot's valid K and V
// rows, read once. A serve_7b step at position 160 of 512 (8 slots, 32 heads
// of 128) reads 21 MB per layer (6.3 us), 0.67 GB per step; its products
// are ~1 FLOP per byte, far below the ~295 where the tensor cores would bind.
//
// Design (simple and right first; TMA and wgmma are a later PR's work):
//
// - Normalised p must be rounded before the product with v, so an online
//   softmax, which rounds unnormalised partials, would not round as the
//   reference does. Three kernels instead, each reading what it needs once:
//   1. scores: K's valid rows -> fp32 scores in a [B, H, S_max + 1]
//      workspace (column S_max holds the self score);
//   2. pv: each block takes the max and the sum of exp over its heads' whole
//      score rows (a few KB from L2), forms p for its chunk of rows, rounds
//      it to the dtype and sums p v over the chunk's valid V rows into an
//      fp32 partial [B, H, chunk, D];
//   3. finish: adds a (b, h)'s partials in chunk order, rounds to the dtype,
//      and adds the rounded self term p_self v_new as the reference does.
// - Rows at or past a slot's length are never read (a chunk past it exits),
//   so whatever a stale row holds, NaN included, cannot reach the output.
// - The sequence is split into chunks (`n_chunks` of `chunk_rows`, from the
//   wrapper's launch plan) so that B * Hkv below the card's 132 SMs still
//   gives every SM blocks: bench_400m's 8 x 8 kv heads at 1089 rows run 9
//   chunks of 128 rows.
// - A kv head's rows are read once for all n_rep q heads of its group (GQA
//   without a repeat_kv copy): the scores kernel dots each K row with every
//   head's q, the pv kernel holds up to 4 heads' sums per thread.
// - Rows are read 16 bytes a thread, ceil(D / 8) rounded up to a power of 2
//   threads per row, neighbouring threads on neighbouring bytes; a row's dot
//   is reduced across those threads by xor shuffles.
// - Deterministic: every sum is taken in an order fixed by the shapes and
//   the plan (no atomics), and every block that needs a row's max and sum
//   computes them with the same 128 threads in the same order, so two
//   launches agree bit for bit.
// - Capturable: no host read, no allocation (the wrapper hands a workspace
//   from the caller's stream allocator), and no function attribute set (the
//   dynamic shared memory, n_rep * D floats, stays under the 48 KB default).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // rows whose p the pv kernel stages at once
constexpr int kMaxQFloats = 48 * 1024 / 4;  // q of a kv group, as fp32

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const long long* lengths;
  const void* k_new;  // null: no self column
  const void* v_new;
  void* out;
  float* scores;   // [B, H, S_max + 1]
  float* partial;  // [B, H, n_chunks, D]
  int B, H, Hkv, S_max, D, n_rep, tpr, n_chunks, chunk_rows, has_self;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

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

// Eight consecutive elements (16 or 32 bytes, 16-byte aligned) as floats.
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

__device__ __forceinline__ int valid_rows(const Params& p, int b) {
  const long long n = p.lengths[b];
  return static_cast<int>(n < 0 ? 0 : (n > p.S_max ? p.S_max : n));
}

// The max and the sum of exp(s - max) over a score row: its `n` cache
// scores and, with `has_self`, the self score at `self_at`. Every block
// that needs a row's statistics calls this with all of its 128 threads, so
// each gets the same bits. `scratch` holds kWarps floats.
__device__ void row_stats(const float* row, int n, bool has_self, int self_at, float* scratch,
                          float& m_out, float& l_out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) m = fmaxf(m, row[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) scratch[warp] = m;
  __syncthreads();
  m = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, scratch[w]);
  if (has_self) m = fmaxf(m, row[self_at]);
  __syncthreads();
  float l = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) l += expf(row[j] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) scratch[warp] = l;
  __syncthreads();
  l = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l += scratch[w];
  if (has_self) l += expf(row[self_at] - m);
  __syncthreads();
  m_out = m;
  l_out = l;
}

// Each of the kv group's n_rep heads dotted with one K row, whose eight
// columns d0.. this thread holds in `kf` (zeros where the row has none): the
// fp32 sum over the row's `tpr` threads, scaled, stored by the first of them
// when `store`.
__device__ __forceinline__ void store_scores(const float* q_sh, const float (&kf)[8],
                                             const Params& p, int d0, bool store, float* dst) {
  const long long head_stride = p.S_max + 1;
  for (int g = 0; g < p.n_rep; ++g) {
    float s = 0.f;
    if (d0 < p.D) {
      const float* qg = q_sh + g * p.D + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(qg[e], kf[e], s);
    }
    for (int off = p.tpr / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (store) dst[g * head_stride] = s * p.scale;
  }
}

// Kernel 1: block (chunk c, b * Hkv + kv head) writes the scores of the
// chunk's valid rows for the group's n_rep heads; chunk 0 also the self
// score.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_scores_kernel(const Params p) {
  extern __shared__ float q_sh[];  // [n_rep][D]
  const int c = blockIdx.x;
  const int b = blockIdx.y / p.Hkv, kvh = blockIdx.y % p.Hkv;
  const int n = valid_rows(p, b);
  const int row0 = c * p.chunk_rows;
  const int row1 = min(row0 + p.chunk_rows, n);
  const bool self_here = p.has_self && c == 0;
  if (row0 >= row1 && !self_here) return;
  const int h0 = kvh * p.n_rep;
  const T* q = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.H + h0) * p.D;
  for (int i = threadIdx.x; i < p.n_rep * p.D; i += kThreads) q_sh[i] = to_f(q[i]);
  __syncthreads();
  const int rl = threadIdx.x / p.tpr, lanes = kThreads / p.tpr;
  const int d0 = (threadIdx.x % p.tpr) * 8;
  const bool first = threadIdx.x % p.tpr == 0;
  float* srow = p.scores + (static_cast<long long>(b) * p.H + h0) * (p.S_max + 1);
  const T* krow = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh + d0;
  // the bound is the same for every thread: the shuffles need whole warps
  for (int j0 = row0; j0 < row1; j0 += lanes) {
    const int j = j0 + rl;
    float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < row1 && d0 < p.D) load8(krow + j * p.k_ss, kf);
    store_scores(q_sh, kf, p, d0, first && j < row1, srow + j);
  }
  if (self_here) {
    float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const T* kn = static_cast<const T*>(p.k_new) + (static_cast<long long>(b) * p.Hkv + kvh) * p.D;
    if (rl == 0 && d0 < p.D) load8(kn + d0, kf);
    store_scores(q_sh, kf, p, d0, first && rl == 0, srow + p.S_max);
  }
}

// Kernel 2: block (chunk c, (b * Hkv + kv head) * groups + group) sums
// p v over the chunk's valid rows for G heads of the kv group, into the fp32
// partials.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_pv_kernel(const Params p) {
  __shared__ float p_sh[G][kTile];
  __shared__ float red[kThreads * 8 * G];  // [lanes][G][tpr * 8]
  __shared__ float scratch[kWarps];
  const int groups = p.n_rep / G;
  const int c = blockIdx.x;
  const int bk = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int b = bk / p.Hkv, kvh = bk % p.Hkv;
  const int n = valid_rows(p, b);
  const int row0 = c * p.chunk_rows;
  const int row1 = min(row0 + p.chunk_rows, n);
  if (row0 >= row1) return;
  const int h0 = kvh * p.n_rep + grp * G;
  const long long ss = p.S_max + 1;
  const float* srow = p.scores + (static_cast<long long>(b) * p.H + h0) * ss;
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) row_stats(srow + g * ss, n, p.has_self, p.S_max, scratch, m[g], l[g]);

  const int rl = threadIdx.x / p.tpr, lanes = kThreads / p.tpr;
  const int col = threadIdx.x % p.tpr, d0 = col * 8;
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  const T* vrow = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + d0;
  for (int t0 = row0; t0 < row1; t0 += kTile) {
    const int rows = min(kTile, row1 - t0);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int jj = threadIdx.x;
      p_sh[g][jj] = jj < rows ? round_to<T>(expf(srow[g * ss + t0 + jj] - m[g]) / l[g]) : 0.f;
    }
    __syncthreads();
    if (d0 < p.D) {
      for (int jj = rl; jj < rows; jj += lanes) {
        float vf[8];
        load8(vrow + (t0 + jj) * p.v_ss, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = p_sh[g][jj];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();
  }
  // the row lanes' sums, added in lane order
  const int width = p.tpr * 8;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(rl * G + g) * width + d0 + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < G * width; i += kThreads) {
    const int g = i / width, d = i % width;
    if (d >= p.D) continue;
    float s = 0.f;
    for (int r = 0; r < lanes; ++r) s += red[(r * G + g) * width + d];
    p.partial[((static_cast<long long>(b) * p.H + h0 + g) * p.n_chunks + c) * p.D + d] = s;
  }
}

// Kernel 3: block (b * H + h) adds the partials of the chunks that hold
// valid rows, in chunk order, rounds the sum to T, and adds the self term as
// the reference does: bf16(bf16(p_self) * v_new) added in the dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_finish_kernel(const Params p) {
  __shared__ float scratch[kWarps];
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.n_rep;
  const int n = valid_rows(p, b);
  const float* srow = p.scores + static_cast<long long>(blockIdx.x) * (p.S_max + 1);
  float m = 0.f, l = 1.f;
  if (p.has_self) row_stats(srow, n, true, p.S_max, scratch, m, l);
  const int chunks = (n + p.chunk_rows - 1) / p.chunk_rows;
  const float* part = p.partial + static_cast<long long>(blockIdx.x) * p.n_chunks * p.D;
  T* out = static_cast<T*>(p.out) + static_cast<long long>(blockIdx.x) * p.D;
  for (int d = threadIdx.x; d < p.D; d += kThreads) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[c * p.D + d];
    float o = round_to<T>(s);
    if (p.has_self) {
      const float ps = round_to<T>(expf(srow[p.S_max] - m) / l);
      const T* vn = static_cast<const T*>(p.v_new) + (static_cast<long long>(b) * p.Hkv + kvh) * p.D;
      o = round_to<T>(o + round_to<T>(ps * to_f(vn[d])));
    }
    out[d] = from_f<T>(o);
  }
}

template <typename T, int G>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  const dim3 chunks_by_kv(p.n_chunks, p.B * p.Hkv);
  decode_scores_kernel<T><<<chunks_by_kv, kThreads, p.n_rep * p.D * sizeof(float), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_pv_kernel<T, G><<<dim3(p.n_chunks, p.B * p.Hkv * (p.n_rep / G)), kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_finish_kernel<T><<<p.B * p.H, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_groups(const Params& p, cudaStream_t stream) {
  if (p.n_rep % 4 == 0) return launch_all<T, 4>(p, stream);
  if (p.n_rep % 2 == 0) return launch_all<T, 2>(p, stream);
  return launch_all<T, 1>(p, stream);
}

}  // namespace

// dtype 0 = fp32, 1 = bf16. k_new and v_new both null (no self column) or
// both set. `workspace` holds B * H * (S_max + 1 + n_chunks * D) floats.
// Returns 0 or a CUDA error; cudaErrorInvalidValue (1) for shapes or a plan
// the kernels do not take (the wrapper checks them first).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                const void* k_new, const void* v_new, void* out, void* workspace,
                                int dtype, int B, int H, int Hkv, int S_max, int D, long long k_sb,
                                long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, float scale, int n_chunks, int chunk_rows,
                                void* stream) {
  // grid rows: B * Hkv (scores) and B * Hkv * n_rep / G (pv) at most 65535
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || S_max < 1 || D < 8 || D > 256 || D % 8 != 0 ||
      (H / Hkv) * D > kMaxQFloats || n_chunks < 1 || chunk_rows < 1 ||
      static_cast<long long>(n_chunks) * chunk_rows < S_max ||
      (k_new == nullptr) != (v_new == nullptr) || static_cast<long long>(B) * H > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = static_cast<const long long*>(lengths);
  p.k_new = k_new;
  p.v_new = v_new;
  p.out = out;
  p.scores = static_cast<float*>(workspace);
  p.partial = p.scores + static_cast<long long>(B) * H * (S_max + 1);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S_max = S_max;
  p.D = D;
  p.n_rep = H / Hkv;
  p.tpr = 1;
  while (p.tpr * 8 < D) p.tpr *= 2;
  p.n_chunks = n_chunks;
  p.chunk_rows = chunk_rows;
  p.has_self = k_new != nullptr;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch_groups<__nv_bfloat16>(p, st) : launch_groups<float>(p, st);
  return static_cast<int>(err);
}
