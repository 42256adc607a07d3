// Flash attention forward, causal or full, with grouped kv heads (GQA):
// out[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, kh, :] / sqrt(D)) v[b, j,
// kh, :] with kh = h / (H / K), the causal mask j <= i (both counted from
// 0), float32 softmax and accumulation, output in the inputs' type.
// Layouts are the model's: q/out [B, Sq, H, D], k/v [B, Sk, K, D],
// contiguous.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas (body
// _flash_kernel), where a (B*H, nq, nk) grid ran nk innermost and carried
// the online-softmax state (m, l, acc) in VMEM scratch across the k steps,
// skipping tiles above the diagonal with pl.when.
//
// Bound on the card: 4 * D operations per (query, key) pair kept by the
// mask against (2 * Sq * H + 2 * Sk * K) * D elements moved, so at the
// sequence lengths of the nn scope and above it is bound by operations:
// 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32 on the
// CUDA cores.  Hopper's blocks run in parallel and in no order, so the
// TPU's sequential k grid becomes a loop inside each block, with m, l and
// the output accumulator in registers across it.  Two variants:
//
// wgmma (bf16): the tensor cores, fed by TMA.  A block of 384 threads owns
// 128 query rows of one (batch, head).  Warpgroup 0 is the producer: one
// thread loads the q tile once and keeps a 2-stage ring of 128-key k and v
// tiles full, each stage with its "full" mbarriers (k, v) and one "empty".
// The TMA maps are 3-D over [B, S, heads * D], so a box that passes the
// end of a sequence fills with zeros instead of reading the next batch;
// each row of D bf16 is one box row, swizzled over its own span (32, 64
// or 128 bytes; D = 128 is two boxes of 64).  The kv head is h / (H / K),
// never repeated in memory.  Warpgroups 1 and 2 are consumers of 64 query
// rows each: S = Q K^T is wgmma.m64n128k16 with both operands in shared
// memory (K-major), accumulated in float32 registers; the online softmax
// runs on the accumulator fragments (a row's values lie in the 4 threads
// of a quad: two shuffles); P is rounded to bf16 in registers, where the
// accumulator's layout is the register A operand's, and O += P V is
// wgmma.m64nDk16 with V from shared memory, MN-major like matmul's B.
// Only a tile that crosses the diagonal or the end of the keys is masked;
// the causal key loop stops at the block's diagonal, and the heaviest
// query blocks are launched first.
//
// simt (float32, and bf16 with no keys): the CUDA cores, float32
// arithmetic.  One block of 256 threads owns 64 query rows of one (batch,
// head).  The q tile stays in shared memory (transposed, float32); per
// step the block stages a 32-key tile of k (transposed) and v.  Thread
// (tx, ty) computes scores for rows ty + 16i and keys tx + 16j; a row's 16
// threads are one half-warp, so the row max and row sum of the online
// softmax are four xor-shuffles.  Probabilities go through shared memory
// to the P.V product.  TF32 tensor cores would miss the reference's 2e-5,
// and this body already beats the library's float32 attention, so float32
// stays here.  A row whose keys are all masked (Sk == 0) has l == 0 and
// gives zeros, the reference's guard.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "_hopper/hopper.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per step
constexpr int THREADS = 256;   // 16 x 16
constexpr int TR = BQ / 16;    // query rows per thread
constexpr int TC = BK / 16;    // keys per thread and step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// reductions over the 16 lanes of a half-warp (one query row)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (D * (BQ + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_simt_kernel(const T* __restrict__ q,
                            const T* __restrict__ k, const T* __restrict__ v,
                            T* __restrict__ out, int Sq, int Sk, int H, int K,
                            int causal, float scale) {
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [D][BQ + 1] q tile, transposed
  float* ks = qs + D * (BQ + 1);      // [D][BK + 1] k tile, transposed
  float* vs = ks + D * (BK + 1);      // [BK][D]     v tile
  float* ps = vs + BK * D;            // [BQ][BK + 1] probabilities

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const size_t q_stride = static_cast<size_t>(H) * D;   // one position
  const size_t kv_stride = static_cast<size_t>(K) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * K + kh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * K + kh) * D;
  T* ob = out + (static_cast<size_t>(b) * Sq * H + h) * D;

  // consecutive threads read consecutive d of one position: coalesced
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[c * (BQ + 1) + r] =
        q0 + r < Sq ? to_float(qb[(q0 + r) * q_stride + c]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the block's last query row are all masked
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous step's tiles are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      const size_t off = (k0 + r) * kv_stride + c;
      ks[c * (BK + 1) + r] = in ? to_float(kb[off]) : 0.f;
      vs[r * D + c] = in ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[TR], bk[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = qs[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) bk[j] = ks[c * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = kp < Sk && (!causal || kp <= qp);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row with no unmasked key yet keeps p = 0 and corr = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_use);
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_use);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float p = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[qp * q_stride + tx + 16 * c] = from_float<T>(acc[i][c] / li);
  }
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int K, int causal, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_simt_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_simt_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, K, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- wgmma

constexpr int W_BQ = 128;        // query rows per block: two consumers of 64
constexpr int W_BKV = 128;       // keys per tile
constexpr int W_THREADS = 384;   // producer + two consumers
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int CH = D > 64 ? 64 : D;   // columns of one box
  static constexpr int NCH = D / CH;           // boxes a row
  static constexpr int RB = CH * 2;            // bytes a box row = swizzle
  static constexpr int Q_BYTES = W_BQ * D * 2;
  static constexpr int KV_BYTES = W_BKV * D * 2;
  // q, 2 stages of k and of v, 7 barriers, alignment slack
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 7 * 8 + 1024;
};

// the n = D product of the P.V step
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 16) hopper::wgmma_m64n16k16_rs<1>(o, a, db, 1);
  else if constexpr (D == 32) hopper::wgmma_m64n32k16_rs<1>(o, a, db, 1);
  else if constexpr (D == 64) hopper::wgmma_m64n64k16_rs<1>(o, a, db, 1);
  else hopper::wgmma_m64n128k16_rs<1>(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             __nv_bfloat16* __restrict__ out, int B, int Sq,
                             int Sk, int H, int K, int causal,
                             float scale_log2) {
  using Tl = Tiles<D>;
  constexpr int RB = Tl::RB;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024 bytes, a whole swizzle atom
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + Tl::Q_BYTES;           // [2][W_BKV x D]
  uint8_t* vs = ks + 2 * Tl::KV_BYTES;      // [2][W_BKV x D]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + 2 * Tl::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 3;
  uint64_t* empty = q_full + 5;

  // heaviest first: under the causal mask the last query blocks see the
  // most keys, so the block index runs over them first
  const int nq = (Sq + W_BQ - 1) / W_BQ;
  const int HB = H * B;
  const int qblk = causal ? nq - 1 - static_cast<int>(blockIdx.x) / HB
                          : static_cast<int>(blockIdx.x) / HB;
  const int h = static_cast<int>(blockIdx.x) % HB % H;
  const int b = static_cast<int>(blockIdx.x) % HB / H;
  const int kh = h / (H / K);
  const int q0 = qblk * W_BQ;
  // causal: keys past the block's last query row are all masked
  const int k_end = causal ? min(Sk, q0 + W_BQ) : Sk;
  const int ntiles = (k_end + W_BKV - 1) / W_BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 256);   // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, Tl::Q_BYTES);
#pragma unroll
      for (int c = 0; c < Tl::NCH; ++c)
        hopper::tma_load_3d(qs + c * W_BQ * RB, &map_q, q_full,
                            h * D + c * Tl::CH, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t & 1;
        if (t >= 2) hopper::mbar_wait(&empty[s], ((t >> 1) - 1) & 1);
        uint8_t* kt = ks + s * Tl::KV_BYTES;
        uint8_t* vt = vs + s * Tl::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&k_full[s], Tl::KV_BYTES);
#pragma unroll
        for (int c = 0; c < Tl::NCH; ++c)
          hopper::tma_load_3d(kt + c * W_BKV * RB, &map_k, &k_full[s],
                              kh * D + c * Tl::CH, t * W_BKV, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], Tl::KV_BYTES);
#pragma unroll
        for (int c = 0; c < Tl::NCH; ++c)
          hopper::tma_load_3d(vt + c * W_BKV * RB, &map_v, &v_full[s],
                              kh * D + c * Tl::CH, t * W_BKV, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;                 // this warpgroup's 64 rows
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, l = tid % 32;
    const int wg_q0 = q0 + cw * 64;
    // this thread's two rows: r[h] = wg_q0 + 16 w + l / 4 + 8 h
    const int row0 = wg_q0 + w * 16 + l / 4;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float lsum[2] = {0.f, 0.f};            // this thread's share of l

    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t & 1;
      const uint32_t parity = (t >> 1) & 1;
      const int k0 = t * W_BKV;
      const uint8_t* kt = ks + s * Tl::KV_BYTES;
      const uint8_t* vt = vs + s * Tl::KV_BYTES;
      hopper::mbar_wait(&k_full[s], parity);
      // a causal tile wholly above this warpgroup's rows adds nothing
      if (!causal || k0 <= wg_q0 + 63) {
        float sc[64];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // K-major q and k: rows of RB bytes, 8-row groups 8 * RB apart;
          // a K step of 16 moves 32 bytes along the row, or to the next box
          const int off = (kk * 16 / Tl::CH) * W_BQ * RB + (kk * 16 % Tl::CH) * 2;
          const int koff = (kk * 16 / Tl::CH) * W_BKV * RB + (kk * 16 % Tl::CH) * 2;
          hopper::wgmma_m64n128k16_ss<0>(
              sc, hopper::make_desc(qs + off + cw * 64 * RB, 16, 8 * RB, RB),
              hopper::make_desc(kt + koff, 16, 8 * RB, RB), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);

        // sc[4 j + 2 hh + e]: row row0 + 8 hh, key k0 + 8 j + 2 (l % 4) + e
        if (k0 + W_BKV > Sk || (causal && k0 + W_BKV - 1 > wg_q0)) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kp = k0 + 8 * j + 2 * (l % 4) + e;
                if (kp >= Sk || (causal && kp > row0 + 8 * hh))
                  sc[4 * j + 2 * hh + e] = -INFINITY;
              }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
          const float m_new = fmaxf(m[hh], quad_max(mx) * scale_log2);
          // a row with no unmasked key yet keeps p = 0 and corr = 0
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float corr = exp2f(m[hh] - m_use);
          m[hh] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  exp2f(fmaf(sc[4 * j + 2 * hh + e], scale_log2, -m_use));
              sc[4 * j + 2 * hh + e] = p;
              sum += p;
            }
          lsum[hh] = lsum[hh] * corr + sum;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j + 2 * hh] *= corr;
            o[4 * j + 2 * hh + 1] *= corr;
          }
        }
        // P in bf16 as the register A operand of 8 k steps of 16 keys: the
        // accumulator's columns 16 kk .. 16 kk + 15 are A's k columns
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        hopper::mbar_wait(&v_full[s], parity);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          // MN-major v: one row of RB bytes per key, 8-key groups 8 * RB
          // apart, a second box of 64 columns W_BKV * RB further on
          pv_step<D>(o, pa[kk],
                     hopper::make_desc(vt + kk * 16 * RB, W_BKV * RB, 8 * RB,
                                       RB));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
      } else {
        hopper::mbar_wait(&v_full[s], parity);   // the stage must be whole
      }
      hopper::mbar_arrive(&empty[s]);
    }

    // o[4 j + 2 hh + e]: row row0 + 8 hh, column 8 j + 2 (l % 4) + e
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qp = row0 + 8 * hh;
      const float li = quad_sum(lsum[hh]);
      const float inv = li == 0.f ? 0.f : 1.f / li;
      if (qp >= Sq) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (l % 4)) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                  o[4 * j + 2 * hh + 1] * inv);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int K, int causal, float scale,
                 cudaStream_t stream) {
  using Tl = Tiles<D>;
  CUtensorMap maps[3];
  const uint64_t dq[3] = {static_cast<uint64_t>(H) * D,
                          static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t sq[2] = {static_cast<uint64_t>(H) * D * 2,
                          static_cast<uint64_t>(Sq) * H * D * 2};
  const uint64_t dkv[3] = {static_cast<uint64_t>(K) * D,
                           static_cast<uint64_t>(Sk), static_cast<uint64_t>(B)};
  const uint64_t skv[2] = {static_cast<uint64_t>(K) * D * 2,
                           static_cast<uint64_t>(Sk) * K * D * 2};
  const uint32_t bq[3] = {Tl::CH, W_BQ, 1};
  const uint32_t bkv[3] = {Tl::CH, W_BKV, 1};
  int err = hopper::encode_bf16_map(&maps[0], q, 3, dq, sq, bq, Tl::RB);
  if (err == 0) err = hopper::encode_bf16_map(&maps[1], k, 3, dkv, skv, bkv, Tl::RB);
  if (err == 0) err = hopper::encode_bf16_map(&maps[2], v, 3, dkv, skv, bkv, Tl::RB);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks =
      static_cast<long long>((Sq + W_BQ - 1) / W_BQ) * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_wgmma_kernel<D><<<static_cast<unsigned>(blocks), W_THREADS,
                                    Tl::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), B, Sq, Sk,
      H, K, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

bool tma_ready(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the bf16 wgmma variant: needs keys and 16-byte aligned q, k and v
int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int H, int K, int D, int causal,
                      float scale, void* stream) {
  if (Sk <= 0 || !tma_ready(q) || !tma_ready(k) || !tma_ready(v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_wgmma<16>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 32: return launch_wgmma<32>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 64: return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_simt_d(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Sk, int H, int K, int D, int causal,
                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_simt<T, 16>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 32: return launch_simt<T, 32>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 64: return launch_simt<T, 64>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 128: return launch_simt<T, 128>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each function enqueues one launch on the
// caller's stream, does not synchronize, and returns a cudaError_t
// (cudaErrorInvalidValue for a head size other than 16, 32, 64 or 128).
// The caller guarantees B, Sq, H, K > 0 with H % K == 0, B and H at most
// 65535, contiguous q/out [B, Sq, H, D] and k/v [B, Sk, K, D] of the named
// type on the current device.  flash_attention_bf16 is the wgmma variant
// and also needs Sk > 0 and 16-byte aligned q, k and v;
// flash_attention_bf16_simt is the CUDA-core body for bf16, which takes
// Sk == 0.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int K, int D,
                        int causal, float scale, void* stream) {
  return launch_simt_d<float>(q, k, v, out, B, Sq, Sk, H, K, D, causal, scale,
                              stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int K,
                         int D, int causal, float scale, void* stream) {
  return launch_bf16_wgmma(q, k, v, out, B, Sq, Sk, H, K, D, causal, scale,
                           stream);
}

int flash_attention_bf16_simt(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Sk, int H, int K,
                              int D, int causal, float scale, void* stream) {
  return launch_simt_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, K, D,
                                      causal, scale, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
