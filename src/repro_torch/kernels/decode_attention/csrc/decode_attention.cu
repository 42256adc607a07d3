// Decode attention: one query token a row against that row's prefix of a
// padded KV cache, with grouped kv heads (GQA):
// out[b, 0, h, :] = softmax_j(q[b, 0, h, :] . k[b, j, kh, :] / sqrt(D))
// v[b, j, kh, :] over the positions j < len[b] - first (at most Smax), with
// kh = h / (H / K); a row with no position gives zeros.  Layouts are the
// model's: q [B, 1, H, D], the caches [B, Smax, K, D] (any batch, position
// and head strides, the head's D values contiguous), out [B, 1, H, D].
//
// Replaces no TPU kernel: the JAX package's decode attention
// (src/repro/models/layers.py::decode_attention) is plain jnp.  It is
// added because on this card the plain form held the serve cells' decode
// step: it widened each layer's whole padded bf16 cache to float32 and ran
// float32 products and a softmax in separate passes over every position,
// live or not.
//
// Bound on the card: 4 * D operations per (q head, position) against the
// 4 * D bytes of that position's bf16 k and v, read once for the G = H / K
// q heads of a kv head: about 2 operations per byte at G = 2, far below the
// H100's ~295, so it is bound by bytes.  The least time is the live prefix's
// k and v (sum over rows of min(len, Smax) * K * D * 2 * itemsize) plus q
// and out, over 3.35 TB/s.
//
// Design: split-KV flash decoding.  A block of 128 threads takes one
// (row b, kv head kh, split of split_len positions) and the GB q heads of
// kh's group that it serves (GB in {1, 2, 4, 8}, the least that holds G;
// a group of more than 8 heads takes several blocks), so each k and v tile
// is read from memory once for the whole group and no repeated cache is
// ever formed.  The grid is sized from Smax and the shapes alone; each
// block reads its row's length from device memory, clamps it to [0, Smax]
// (a free slot's clock runs past the cache) and returns at once when its
// split starts past it, so the host never reads a length and the dead
// positions of a ragged pool cost one early exit a split.  K and v are read
// in the cache's own type with 16-byte cp.async copies into a 3-stage ring
// of 32-position tiles in shared memory (rows padded by 16 bytes, so the
// lanes of a quarter warp read distinct banks); nothing is widened in
// device memory.  Within a tile a group of LG lanes (a power of two that
// covers the row's 16-byte chunks) takes a position: each lane holds its
// chunks of the scaled q heads in registers, and the scores are its partial
// dot products summed over the group by shuffles.  Numerics follow the
// plain chunked attention (models/layers.py::_flash_fwd_scan) tile by tile:
// q scaled by 1/sqrt(D) in the cache's type, float32 scores, the running
// max updated per tile (one warp a head: a lane a position), p = exp(s - m)
// rounded to the cache's type before both the sum l and the product with
// v, the correction exp(m_old - m_new) applied to l and the accumulator.
// A thread accumulates its chunks of p v for the positions of its group;
// at the split's end the groups are summed (shuffles, then the 4 warps in
// shared memory) and the split writes its (m, l, acc) to float32 scratch.
// A second kernel, a block a (b, q head), merges a row's live splits by
// log-sum-exp (weights exp(m_j - max m), fixed order) and writes out =
// acc / l (0 where l is 0) in the output's type, or, for the sharded
// path, the merged (m, l, acc) unnormalised; it also writes the positions
// the row's live splits spanned, the kernel's own count of what it read.
// Two launches a call.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;        // positions a tile: a lane each in the softmax
constexpr int STAGES = 3;       // tiles of the shared-memory ring
constexpr int PAD = 16;         // bytes after each staged row
constexpr int MAX_D = 256;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// Output modes of the merge (mirrored in ops.py).
constexpr int OUT_CACHE_TYPE = 0;   // out in the cache's type
constexpr int OUT_F32 = 1;          // out in float32
constexpr int OUT_PARTIALS = 2;     // merged (m, l) and acc, unnormalised

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;        // [B] lengths (stride len_stride), or null
  float* ws;              // [B, H, nsplit, 2] (m, l), then [B, H, nsplit, D]
  long long q_sb, q_sh;   // q's batch and head strides, in elements
  long long c_sb, c_ss, c_sh;   // the caches' batch, position, head strides
  int B, Smax, H, K, D, G, nhc;
  int len_stride, len_scalar, first;
  int split_len, nsplit;
  float scale;            // 1/sqrt(D), rounded to the cache's type
};

template <typename T> struct Type;
template <> struct Type<float> {
  static constexpr int E = 4;   // elements a 16-byte chunk
  __device__ static float to_float(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static float from(float x) { return x; }
  __device__ static void chunk(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Type<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 from(float x) { return __float2bfloat16(x); }
  __device__ static void chunk(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Type<__half> {
  static constexpr int E = 8;
  __device__ static float to_float(__half x) { return __half2float(x); }
  __device__ static float round(float x) {
    return __half2float(__float2half(x));
  }
  __device__ static __half from(float x) { return __float2half(x); }
  __device__ static void chunk(const uint4& r, float* f) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row's positions in this cache: len[b] - first, clamped to [0, Smax].
__device__ __forceinline__ int row_length(const Params& p, int b) {
  const int n = (p.lens ? p.lens[static_cast<long long>(b) * p.len_stride]
                        : p.len_scalar) - p.first;
  return min(max(n, 0), p.Smax);
}

// Lanes a position: the least power of two that covers the row's chunks,
// at most a warp.
__device__ __forceinline__ int lanes_a_row(int chunks) {
  int lg = 1;
  while (lg < chunks && lg < 32) lg <<= 1;
  return lg;
}

template <typename T>
__host__ __device__ constexpr int row_stride(int D) {
  return D * static_cast<int>(sizeof(T)) + PAD;
}

template <typename T, int GB>
constexpr size_t split_smem(int D) {
  return static_cast<size_t>(STAGES) * 2 * TILE * row_stride<T>(D) +
         (GB * TILE + 3 * GB) * sizeof(float);
}

template <typename T, int GB>
__global__ void __launch_bounds__(THREADS)
decode_attention_split_kernel(const Params p) {
  using Ty = Type<T>;
  constexpr int E = Ty::E;
  constexpr int CPL = (MAX_D / E + 31) / 32;   // chunks a lane, at most
  extern __shared__ __align__(16) unsigned char smem[];

  const int j = blockIdx.x;
  const int kh = blockIdx.y / p.nhc;
  const int g0 = (blockIdx.y % p.nhc) * GB;
  const int b = blockIdx.z;
  const int gn = min(GB, p.G - g0);            // q heads this block serves
  const int len = row_length(p, b);
  const int s0 = j * p.split_len;
  if (s0 >= len) return;                       // a dead split: nothing to do
  const int s1 = min(s0 + p.split_len, len);

  const int LPR = p.D / E;                     // 16-byte chunks a row
  const int LG = lanes_a_row(LPR);
  const int NGRP = THREADS / LG;               // positions a pass
  const int stride = row_stride<T>(p.D);
  const int tile_bytes = TILE * stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = threadIdx.x % LG, grp = threadIdx.x / LG;

  unsigned char* ring = smem;                  // STAGES x (k tile, v tile)
  float* ps = reinterpret_cast<float*>(smem + STAGES * 2 * tile_bytes);
  float* ms = ps + GB * TILE;                  // running max, a head
  float* ls = ms + GB;                         // running sum, a head
  float* cs = ls + GB;                         // this tile's correction

  // this lane's chunks of the block's q heads, scaled in the cache's type
  float qr[GB][CPL][E];
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int chunk = gl + c * LG;
      const bool in = g < gn && chunk < LPR;
      const T* qh = qb + (kh * p.G + g0 + (in ? g : 0)) * p.q_sh;
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[g][c][e] = in ? Ty::round(Ty::to_float(qh[chunk * E + e]) * p.scale)
                         : 0.f;
    }
  float acc[GB][CPL][E];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][c][e] = 0.f;
  if (threadIdx.x < GB) {
    ms[threadIdx.x] = -INFINITY;
    ls[threadIdx.x] = 0.f;
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.c_sb + kh * p.c_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.c_sb + kh * p.c_sh;
  const int ntiles = (s1 - s0 + TILE - 1) / TILE;
  // tile i's k and v rows into stage i % STAGES, one commit group a tile
  // (empty past the last, so the waits count alike)
  auto load = [&](int i) {
    if (i < ntiles) {
      const int t0 = s0 + i * TILE;
      const int n = min(TILE, s1 - t0);
      unsigned char* ks = ring + (i % STAGES) * 2 * tile_bytes;
      unsigned char* vs = ks + tile_bytes;
      for (int x = threadIdx.x; x < n * LPR; x += THREADS) {
        const int t = x / LPR, c = x % LPR;
        const long long off = (t0 + t) * p.c_ss + c * E;
        cp_async16(ks + t * stride + c * 16, kb + off);
        cp_async16(vs + t * stride + c * 16, vb + off);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);

  for (int i = 0; i < ntiles; ++i) {
    load(i + STAGES - 1);          // into the stage that tile i - 1 freed
    cp_async_wait<STAGES - 1>();   // this thread's copies of tile i
    __syncthreads();               // everyone's
    const int n = min(TILE, s1 - (s0 + i * TILE));
    const unsigned char* ks = ring + (i % STAGES) * 2 * tile_bytes;
    const unsigned char* vs = ks + tile_bytes;

    // scores: a group of LG lanes a position, every lane in step
    for (int base = 0; base < n; base += NGRP) {
      const int t = base + grp;
      const bool in = t < n;
      float sc[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int chunk = gl + c * LG;
        if (in && chunk < LPR) {
          float kf[E];
          Ty::chunk(*reinterpret_cast<const uint4*>(ks + t * stride +
                                                    chunk * 16), kf);
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int e = 0; e < E; ++e) sc[g] = fmaf(qr[g][c][e], kf[e], sc[g]);
        }
      }
      for (int off = LG >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          sc[g] += __shfl_xor_sync(FULL, sc[g], off);
      if (in && gl == 0)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (g < gn) ps[g * TILE + t] = sc[g];
    }
    __syncthreads();

    // the tile's softmax step: a warp a head, a lane a position
    for (int g = warp; g < gn; g += WARPS) {
      const float s = lane < n ? ps[g * TILE + lane] : -INFINITY;
      float tmax = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, tmax);   // finite: n >= 1
      const float pr = lane < n ? Ty::round(expf(s - m_new)) : 0.f;
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      ps[g * TILE + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * corr + sum;
        cs[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v over this group's positions
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float corr = g < gn ? cs[g] : 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][c][e] *= corr;
    }
    for (int t = grp; t < n; t += NGRP) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int chunk = gl + c * LG;
        if (chunk < LPR) {
          float vf[E];
          Ty::chunk(*reinterpret_cast<const uint4*>(vs + t * stride +
                                                    chunk * 16), vf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float pg = g < gn ? ps[g * TILE + t] : 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[g][c][e] = fmaf(pg, vf[e], acc[g][c][e]);
          }
        }
      }
    }
    __syncthreads();               // the stage and ps are free again
  }
  cp_async_wait<0>();

  // sum the groups: shuffles within a warp, then the warps through the ring
  for (int off = LG; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][c][e] += __shfl_xor_sync(FULL, acc[g][c][e], off);
  float* red = reinterpret_cast<float*>(ring);   // [WARPS][GB][D]
  if (lane < LG)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int chunk = gl + c * LG;
        if (g < gn && chunk < LPR)
#pragma unroll
          for (int e = 0; e < E; ++e)
            red[(warp * GB + g) * p.D + chunk * E + e] = acc[g][c][e];
      }
  __syncthreads();
  const long long row = static_cast<long long>(b) * p.H + kh * p.G + g0;
  float* ws_ml = p.ws;
  float* ws_acc = p.ws + 2LL * p.B * p.H * p.nsplit;
  for (int x = threadIdx.x; x < gn * p.D; x += THREADS) {
    const int g = x / p.D, d = x % p.D;
    float a = red[g * p.D + d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) a += red[(w * GB + g) * p.D + d];
    ws_acc[((row + g) * p.nsplit + j) * p.D + d] = a;
  }
  if (threadIdx.x < gn) {
    const long long at = ((row + threadIdx.x) * p.nsplit + j) * 2;
    ws_ml[at] = ms[threadIdx.x];
    ws_ml[at + 1] = ls[threadIdx.x];
  }
}

// A block a (q head h, row b): the row's live splits merged; head 0's
// block also writes the positions those splits spanned to reads[b].
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_combine_kernel(const Params p, void* out, float* ml_out,
                                int* reads, int mode) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = static_cast<long long>(b) * p.H + h;
  const int len = row_length(p, b);
  const int live = (len + p.split_len - 1) / p.split_len;
  if (h == 0 && threadIdx.x == 0)
    reads[b] = min(live * p.split_len, p.Smax);
  const float* ml = p.ws + row * p.nsplit * 2;
  const float* part = p.ws + 2LL * p.B * p.H * p.nsplit + row * p.nsplit * p.D;
  float M = -INFINITY;
  for (int j = 0; j < live; ++j) M = fmaxf(M, ml[2 * j]);
  float L = 0.f;
  for (int j = 0; j < live; ++j) L += expf(ml[2 * j] - M) * ml[2 * j + 1];
  for (int d = threadIdx.x; d < p.D; d += THREADS) {
    float A = 0.f;
    for (int j = 0; j < live; ++j)
      A += expf(ml[2 * j] - M) * part[static_cast<long long>(j) * p.D + d];
    const long long at = row * p.D + d;
    if (mode == OUT_PARTIALS) {
      static_cast<float*>(out)[at] = A;
    } else {
      const float o = L == 0.f ? 0.f : A / L;
      if (mode == OUT_F32)
        static_cast<float*>(out)[at] = o;
      else
        static_cast<T*>(out)[at] = Type<T>::from(o);
    }
  }
  if (mode == OUT_PARTIALS && threadIdx.x == 0) {
    ml_out[2 * row] = M;
    ml_out[2 * row + 1] = L;
  }
}

template <typename T, int GB>
int launch_split(const Params& p, cudaStream_t stream) {
  const size_t smem = split_smem<T, GB>(p.D);
  static int opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || opted[dev] < static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(decode_attention_split_kernel<T, GB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) opted[dev] = static_cast<int>(smem);
  }
  const dim3 grid(p.nsplit, p.K * p.nhc, p.B);
  decode_attention_split_kernel<T, GB><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int heads_a_block(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* ws, void* out, void* ml_out, void* reads, long long q_sb,
           long long q_sh, long long c_sb, long long c_ss, long long c_sh,
           int B, int Smax, int H, int K, int D, int len_stride,
           int len_scalar, int first, int split_len, int mode, float scale,
           void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K || D <= 0 || D > MAX_D ||
      D % Type<T>::E || split_len <= 0 || split_len % TILE || Smax < 0 ||
      mode < OUT_CACHE_TYPE || mode > OUT_PARTIALS || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lens = static_cast<const int*>(lens);
  p.ws = static_cast<float*>(ws);
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.c_sb = c_sb;
  p.c_ss = c_ss;
  p.c_sh = c_sh;
  p.B = B;
  p.Smax = Smax;
  p.H = H;
  p.K = K;
  p.D = D;
  p.G = H / K;
  const int gb = heads_a_block(p.G);
  p.nhc = (p.G + gb - 1) / gb;
  p.len_stride = len_stride;
  p.len_scalar = len_scalar;
  p.first = first;
  p.split_len = split_len;
  p.nsplit = (Smax + split_len - 1) / split_len;
  p.scale = scale;
  if (static_cast<long long>(K) * p.nhc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.nsplit > 0) {
    int err = 0;
    switch (gb) {
      case 1: err = launch_split<T, 1>(p, s); break;
      case 2: err = launch_split<T, 2>(p, s); break;
      case 4: err = launch_split<T, 4>(p, s); break;
      default: err = launch_split<T, 8>(p, s); break;
    }
    if (err != 0) return err;
  }
  decode_attention_combine_kernel<T><<<dim3(H, B), THREADS, 0, s>>>(
      p, out, static_cast<float*>(ml_out), static_cast<int*>(reads), mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each entry enqueues the split kernel (when
// Smax > 0) and the merge on the caller's stream, does not synchronize, and
// returns a cudaError_t (cudaErrorInvalidValue for shapes outside the
// kernel: D a multiple of 16 bytes up to 256 elements, H a multiple of K,
// split_len a multiple of 32).  `lens` is null (every row's length is
// len_scalar) or int32 lengths at stride len_stride (0: one for all rows).
// `ws` holds B * H * ceil(Smax / split_len) * (D + 2) float32.  `out` is
// [B, 1, H, D] contiguous in the cache's type (mode 0) or float32 (modes 1,
// 2); mode 2 also writes the merged (m, l) to ml_out, [B, H, 2] float32.
// `reads` gets each row's positions read, int32 [B]: its live splits'
// span, min(ceil(len / split_len) * split_len, Smax).
// The caller guarantees 16-byte aligned k and v and strides of whole
// 16-byte chunks, all on the current device.
extern "C" {

#define DECODE_ENTRY(name, T)                                               \
  int name(const void* q, const void* k, const void* v, const void* lens,   \
           void* ws, void* out, void* ml_out, void* reads, long long q_sb,  \
           long long q_sh, long long c_sb, long long c_ss, long long c_sh,  \
           int B, int Smax, int H, int K, int D, int len_stride,            \
           int len_scalar, int first, int split_len, int mode, float scale, \
           void* stream) {                                                  \
    return launch<T>(q, k, v, lens, ws, out, ml_out, reads, q_sb, q_sh,     \
                     c_sb, c_ss, c_sh, B, Smax, H, K, D, len_stride,        \
                     len_scalar, first, split_len, mode, scale, stream);    \
  }

DECODE_ENTRY(decode_attention_f32, float)
DECODE_ENTRY(decode_attention_bf16, __nv_bfloat16)
DECODE_ENTRY(decode_attention_f16, __half)

#undef DECODE_ENTRY

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
