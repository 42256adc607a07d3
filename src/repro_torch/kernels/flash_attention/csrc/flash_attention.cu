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
// 989 TFLOP/s in bf16 on the tensor cores; in float32 67 TFLOP/s on the
// CUDA cores, or three TF32 products per product at 495 TFLOP/s on the
// tensor cores (B2 S1024 H4 D64 causal: 1.07 GFLOP, 0.0160 ms on the CUDA
// cores, 3 x 1.07 GFLOP = 0.0065 ms as 3xTF32).  Hopper's blocks run in
// parallel and in no order, so the TPU's sequential k grid becomes a loop
// inside each block, with m, l and the output accumulator in registers
// across it.  ops.variant routes bf16 to wgmma and float32 to ffma.  A
// call without keys (Sk == 0) has no tile to load: every row's weights
// sum to 0, and either C entry writes the reference's zeros with one
// cudaMemsetAsync instead of a launch.
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
// ffma (float32): the CUDA cores, redesigned against what held the first
// body (11 % of its bound at B2 S1024 H4 D64: 128 blocks of 8 warps for
// 132 SMs, 4 x 2 scores a thread behind 6 shared loads per 8 fmaf, 32-key
// steps through registers):
//  - too few blocks (128 of 64 rows for 132 SMs there): each 64-row query
//    tile is split into up to 4 key ranges (a multiple of 64 keys each),
//    one block each, 320 busy blocks there; a range writes its (O, m, l)
//    to scratch and a second, small kernel merges the ranges of the tiles
//    that had several (a tile with one range writes its output itself);
//  - the causal tail: the heaviest query tiles are launched first;
//  - little arithmetic per shared load: a thread holds 8 queries x 8 keys
//    of S and the same 8 rows x D/8 columns of O, and reads q, k, P^T and
//    v with 16-byte loads: 24 loads per 256 fmaf in Q K^T;
//  - loads not overlapped: cp.async (16 bytes, or 4 where an operand is
//    not on 16 bytes; zeros past the end of the keys) double-buffers k,
//    so tile t+1's k loads during all of tile t, and loads v t+1 into the
//    one v buffer during tile t+1's Q K^T.  One v buffer and P^T over the
//    consumed k stage keep a block at 69.6 KB for D = 64: three blocks of
//    two warps an SM.
// The figures above are the default tile, 64 query rows by 64 keys.  The
// tile is a run-time knob: the C entry takes bq in {64, 128} and bk in
// {32, 64} and dispatches with a switch to that instantiation (per head
// size), refusing any other tile (mirrored in ops.py's TILES).  A thread
// keeps its 8 x 8 scores, so a block has bq * bk / 64 threads, bk / 8 of
// them sharing each row's keys and D * 8 / bk of O's columns; bk = 32
// doubles a thread's share of O.  The wgmma variant's 128 x 128 tile is
// fixed.
// Each score is one fmaf chain over d in order from 0, the order of the
// float32 reference's product: with inputs whose scores reach tens, where
// float32 attention itself lies several times 2e-5 from the float64 one,
// this body still holds 2e-5 against the reference.
//
// Why float32 is not on the tensor cores: one TF32 product keeps 11 bits
// and misses the reference's 2e-5.  A 3xTF32 body was built and measured
// on an H100 (PERF.md): each operand split as a = a_hi + a_lo, both
// rounded by cvt.rna.tf32, a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in
// three mma.sync.m16n8k8.tf32, each key tile's P.V folded into O with
// float32 adds (warp mma, not wgmma: TF32 wgmma takes B only K-major from
// shared memory, and V is MN-major for P.V).  It held 2e-5 at unit-scale
// inputs, but with inputs x4 it lay 4.4 to 12 tolerance units from the
// reference: as close to the float64 attention as float32 is, in another
// rounding.  tests/test_torch_tf32x3.py emulates its arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <stdint.h>

#include "_hopper/hopper.cuh"

namespace {

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

// ------------------------------------------------------------------ ffma

// cp.async; a src_bytes of 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages positions [p0, p0 + rows) of one head of a [S, heads, D] operand
// (`src` at position 0, `stride` floats a position) into a tile of row
// stride `ld`, with zeros at positions >= `limit`.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, size_t stride,
                                           int p0, int rows, int limit,
                                           bool aligned) {
  if (aligned) {
    for (int e = threadIdx.x; e < rows * (D / 4); e += blockDim.x) {
      const int r = e / (D / 4), c = 4 * (e % (D / 4));
      const bool in = p0 + r < limit;
      cp_async16(dst + r * ld + c, in ? src + (p0 + r) * stride + c : src,
                 in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
      const int r = e / D, c = e % D;
      const bool in = p0 + r < limit;
      cp_async4(dst + r * ld + c, in ? src + (p0 + r) * stride + c : src,
                in);
    }
  }
}

constexpr int F_SPLITS = 4;     // key ranges a query tile is split into

// The ffma tile: BQ query rows a block, BK keys a tile (BQ in {64, 128},
// BK in {32, 64}; 64 x 64 by default).  A thread holds 8 x 8 scores, so a
// block has BQ * BK / 64 threads: TX = BK / 8 of them share each row's
// keys and TY = BQ / 8 share the rows.
template <int D, int BQ, int BK>
struct FfTiles {
  static constexpr int THREADS = BQ * BK / 64;
  static constexpr int TX = BK / 8;               // threads along the keys
  // rows of q, k and v: 4 words mod 32, so that the 8 lanes of a
  // quarter-warp reading 16 bytes of 8 consecutive rows hit 32 banks
  static constexpr int LD = D + 4;
  static constexpr int LP = BQ + 4;               // rows of P^T
  static constexpr int OC = D / TX;               // output columns a thread
  static constexpr int V4 = OC >= 4 ? 4 : 2;      // contiguous output columns
  static constexpr int NC = OC / V4;              // column groups a thread
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;
  static constexpr int P_FLOATS = BK * LP;
  // P^T overlays the consumed k tile where it fits (D >= BQ)
  static constexpr bool P_IN_K = KV_FLOATS >= P_FLOATS;
  // q, two stages of k, one of v: 69.6 KB at D = 64 and 64 x 64, three
  // blocks an SM
  static constexpr int SMEM =
      4 * (Q_FLOATS + 3 * KV_FLOATS + (P_IN_K ? 0 : P_FLOATS));
};

// the first key of each of a query tile's key ranges: a multiple of the
// key tile, so that no tile straddles two ranges
inline int split_len(int Sk, int bk) {
  const int per = (Sk + F_SPLITS - 1) / F_SPLITS;
  return (per + bk - 1) / bk * bk;
}

// max and sum over the TX lanes of a row (lane % TX = tx)
template <int TX>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int TX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Thread (ty, tx) = (tid / TX, tid % TX) holds rows 4 ty + (i & 3) + BQ/2
// (i >> 2) and keys tx + TX j of the score tile (i, j < 8), and the same
// rows and columns TX V4 c + V4 tx + e of O.  Each score is one fmaf chain
// over d in order from 0, the float32 reference's own order.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ * BK / 64)
flash_attention_ffma_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, float* __restrict__ part,
                            int B, int Sq, int Sk, int H, int K, int causal,
                            float scale, int L, int aligned) {
  using Tl = FfTiles<D, BQ, BK>;
  constexpr int LD = Tl::LD, LP = Tl::LP, V4 = Tl::V4, NC = Tl::NC;
  constexpr int TX = Tl::TX, OC = Tl::OC, HQ = BQ / 2;
  extern __shared__ float4 smem_ff[];
  float* qs = reinterpret_cast<float*>(smem_ff);   // [BQ][LD]
  float* ks = qs + Tl::Q_FLOATS;                    // [2][BK][LD]
  float* vs = ks + 2 * Tl::KV_FLOATS;               // [BK][LD]
  float* ps_own = vs + Tl::KV_FLOATS;               // [BK][LP] if apart

  // (query tile, batch and head, key range), heaviest query tiles first
  const int nq = (Sq + BQ - 1) / BQ;
  const int HB = H * B;
  const int split = static_cast<int>(blockIdx.x) % F_SPLITS;
  const int rest = static_cast<int>(blockIdx.x) / F_SPLITS;
  const int qt = causal ? nq - 1 - rest / HB : rest / HB;
  const int h = rest % HB % H;
  const int b = rest % HB / H;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int nsplit = (k_end + L - 1) / L;
  if (split >= nsplit) return;
  const int kr0 = split * L;
  const int ntiles = (min(k_end, kr0 + L) - kr0 + BK - 1) / BK;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(K) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * K + kh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * K + kh) * D;

  // cp.async groups in the order they are made: (q, k 0, v 0), k 1, then after each
  // tile t's P.V: v t+1 (into the one v buffer), k t+2 (into t's stage);
  // so k t+1 loads during all of tile t and v t+1 during tile t+1's Q K^T
  stage_rows<D>(qs, LD, qb, q_stride, q0, BQ, Sq, aligned);
  stage_rows<D>(ks, LD, kb, kv_stride, kr0, BK, Sk, aligned);
  stage_rows<D>(vs, LD, vb, kv_stride, kr0, BK, Sk, aligned);
  cp_async_commit();
  if (ntiles > 1) {
    stage_rows<D>(ks + Tl::KV_FLOATS, LD, kb, kv_stride, kr0 + BK, BK, Sk,
                  aligned);
    cp_async_commit();
  }

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  float o[8][OC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  float m[8], lsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
  }

  for (int tt = 0; tt < ntiles; ++tt) {
    // k tt is in; still in flight: v tt and k tt+1 (from tile tt-1), or
    // k 1 (tile 0)
    if (tt == 0) {
      if (ntiles > 1) cp_async_wait<1>();
      else cp_async_wait<0>();
    } else {
      if (tt + 1 < ntiles) cp_async_wait<2>();
      else cp_async_wait<1>();
    }
    __syncthreads();
    const int k0 = kr0 + tt * BK;
    float* kt = ks + (tt & 1) * Tl::KV_FLOATS;
    const float* vt = vs;

    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // rows in two halves: registers
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              qs + (4 * ty + i + HQ * hf) * LD + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kt + (tx + TX * j) * LD + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& acc = s[4 * hf + i][j];
            acc = fmaf(qv[i].x, kv.x, acc);
            acc = fmaf(qv[i].y, kv.y, acc);
            acc = fmaf(qv[i].z, kv.z, acc);
            acc = fmaf(qv[i].w, kv.w, acc);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + 4 * ty + (i & 3) + HQ * (i >> 2);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + TX * j;
        const bool keep = kp < Sk && (!causal || kp <= qp);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max<TX>(mx));
      // a row with no unmasked key yet keeps p = 0 and corr = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
      lsum[i] = lsum[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= corr;
    }

    // P^T [key][row], four rows a 16-byte store
    float* ps = Tl::P_IN_K ? kt : ps_own;
    if (Tl::P_IN_K) __syncthreads();   // every thread is done with k
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float4*>(ps + (tx + TX * j) * LP + HQ * hf +
                                   4 * ty) =
            make_float4(s[4 * hf][j], s[4 * hf + 1][j], s[4 * hf + 2][j],
                        s[4 * hf + 3][j]);
    // v tt is in; k tt+1 may still be in flight
    if (tt + 1 < ntiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();

    // O += P V, key by key in order
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + kk * LP + 4 * ty);
      const float4 pb =
          *reinterpret_cast<const float4*>(ps + kk * LP + HQ + 4 * ty);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[V4];
        const float* vp = vt + kk * LD + TX * V4 * c + V4 * tx;
        if constexpr (V4 == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vp);
          vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vp);
          vv[0] = x.x; vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < V4; ++e)
            o[i][V4 * c + e] = fmaf(p[i], vv[e], o[i][V4 * c + e]);
      }
    }
    __syncthreads();   // v and this k stage (P^T) are consumed
    if (tt + 1 < ntiles) {
      stage_rows<D>(vs, LD, vb, kv_stride, k0 + BK, BK, Sk, aligned);
      cp_async_commit();
    }
    if (tt + 2 < ntiles) {
      stage_rows<D>(kt, LD, kb, kv_stride, k0 + 2 * BK, BK, Sk, aligned);
      cp_async_commit();
    }
  }

  // one key range: the output; several: this range's (m, l, O) for the
  // combine kernel
  const size_t rows = static_cast<size_t>(B) * Sq * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = q0 + 4 * ty + (i & 3) + HQ * (i >> 2);
    const float l = row_sum<TX>(lsum[i]);
    if (qp >= Sq) continue;
    const size_t row = (static_cast<size_t>(b) * Sq + qp) * H + h;
    float* dst = out + row * D;
    float inv = l == 0.f ? 0.f : 1.f / l;
    if (nsplit > 1) {
      dst = part + (split * rows + row) * D;
      inv = 1.f;
      if (tx == 0) {
        float* ml = part + F_SPLITS * rows * D + (split * rows + row) * 2;
        ml[0] = m[i];
        ml[1] = l;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* op = dst + TX * V4 * c + V4 * tx;
      if constexpr (V4 == 4)
        *reinterpret_cast<float4*>(op) =
            make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv,
                        o[i][4 * c + 2] * inv, o[i][4 * c + 3] * inv);
      else
        *reinterpret_cast<float2*>(op) =
            make_float2(o[i][2 * c] * inv, o[i][2 * c + 1] * inv);
    }
  }
}

// Merges the key ranges of the query tiles that had several: one thread
// an output element.  `bq` is the ffma kernel's query tile.
__global__ void __launch_bounds__(256)
flash_attention_ffma_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int B, int Sq,
                                    int Sk, int H, int D, int causal, int L,
                                    int bq) {
  const size_t rows = static_cast<size_t>(B) * Sq * H;
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= rows * D) return;
  const size_t row = idx / D;
  const int qp = static_cast<int>(row / H % Sq);
  const int k_end = causal ? min(Sk, qp / bq * bq + bq) : Sk;
  const int nsplit = (k_end + L - 1) / L;
  if (nsplit <= 1) return;   // written by the tile itself
  const float* ml = part + F_SPLITS * rows * D;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[(s * rows + row) * 2]);
  const float m_use = mx == -INFINITY ? 0.f : mx;
  float num = 0.f, den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(ml[(s * rows + row) * 2] - m_use);
    num = fmaf(w, part[s * rows * D + idx], num);
    den = fmaf(w, ml[(s * rows + row) * 2 + 1], den);
  }
  out[idx] = den == 0.f ? 0.f : num / den;
}

template <int D, int BQ, int BK>
int launch_ffma(const void* q, const void* k, const void* v, void* out,
                void* part, int B, int Sq, int Sk, int H, int K, int causal,
                float scale, cudaStream_t stream) {
  using Tl = FfTiles<D, BQ, BK>;
  if (Tl::SMEM > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_ffma_kernel<D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const long long blocks =
      static_cast<long long>((Sq + BQ - 1) / BQ) * H * B * F_SPLITS;
  const long long elems = static_cast<long long>(B) * Sq * H * D;
  if (blocks > 0x7fffffffLL || (elems + 255) / 256 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = split_len(Sk, BK);
  const int aligned = (reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  flash_attention_ffma_kernel<D, BQ, BK>
      <<<static_cast<unsigned>(blocks), Tl::THREADS, Tl::SMEM, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out),
          static_cast<float*>(part), B, Sq, Sk, H, K, causal, scale, L,
          aligned);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // some query tile has several key ranges only if some sees more than L
  const int widest = causal ? std::min(Sk, (Sq + BQ - 1) / BQ * BQ) : Sk;
  if (widest <= L) return 0;
  flash_attention_ffma_combine_kernel<<<static_cast<unsigned>(
                                            (elems + 255) / 256),
                                        256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, Sq, Sk,
      H, D, causal, L, BQ);
  return static_cast<int>(cudaGetLastError());
}

// one head size's tiles: bq in {64, 128}, bk in {32, 64}
template <int D>
int launch_ffma_tile(const void* q, const void* k, const void* v, void* out,
                     void* part, int B, int Sq, int Sk, int H, int K,
                     int causal, float scale, int bq, int bk,
                     cudaStream_t s) {
  switch (bq * 1000 + bk) {
    case 64064: return launch_ffma<D, 64, 64>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, s);
    case 64032: return launch_ffma<D, 64, 32>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, s);
    case 128064: return launch_ffma<D, 128, 64>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, s);
    case 128032: return launch_ffma<D, 128, 32>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int ffma_smem(int bq, int bk) {
  switch (bq * 1000 + bk) {
    case 64064: return FfTiles<D, 64, 64>::SMEM;
    case 64032: return FfTiles<D, 64, 32>::SMEM;
    case 128064: return FfTiles<D, 128, 64>::SMEM;
    case 128032: return FfTiles<D, 128, 32>::SMEM;
    default: return -1;
  }
}

// A call without keys: the reference's zeros over the whole output.
int zeros(void* out, int B, int Sq, int H, int D, size_t elem,
          cudaStream_t s) {
  return static_cast<int>(cudaMemsetAsync(
      out, 0, static_cast<size_t>(B) * Sq * H * D * elem, s));
}

// the float32 ffma variant: `part` holds F_SPLITS * B * Sq * H * (D + 2)
// floats
int launch_f32_ffma(const void* q, const void* k, const void* v, void* out,
                    void* part, int B, int Sq, int Sk, int H, int K, int D,
                    int causal, float scale, int bq, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffma_smem<64>(bq, bk) < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Sk <= 0) return zeros(out, B, Sq, H, D, sizeof(float), s);
  switch (D) {
    case 16: return launch_ffma_tile<16>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, bq, bk, s);
    case 32: return launch_ffma_tile<32>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, bq, bk, s);
    case 64: return launch_ffma_tile<64>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, bq, bk, s);
    case 128: return launch_ffma_tile<128>(q, k, v, out, part, B, Sq, Sk, H, K, causal, scale, bq, bk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool tma_ready(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the bf16 wgmma variant: with keys, q, k and v start on 16 bytes
int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int H, int K, int D, int causal,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk <= 0) return zeros(out, B, Sq, H, D, sizeof(__nv_bfloat16), s);
  if (!tma_ready(q) || !tma_ready(k) || !tma_ready(v))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_wgmma<16>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 32: return launch_wgmma<32>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 64: return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each function enqueues its launches on
// the caller's stream (with Sk == 0, a cudaMemsetAsync of zeros), does not
// synchronize, and returns a cudaError_t (cudaErrorInvalidValue for a head
// size other than 16, 32, 64 or 128).  The caller guarantees B, Sq, H, K
// > 0 with H % K == 0, B and H at most 65535, contiguous q/out [B, Sq, H,
// D] and k/v [B, Sk, K, D] of the named type on the current device.
// flash_attention_f32_ffma is the float32 variant: it takes `part`,
// scratch of F_SPLITS * B * Sq * H * (D + 2) floats, and the tile (bq, bk),
// refusing one outside its set with cudaErrorInvalidValue.
// flash_attention_bf16 is the wgmma variant (its 128 x 128 tile is fixed)
// and, with Sk > 0, needs 16-byte aligned q, k and v.
extern "C" {

int flash_attention_f32_ffma(const void* q, const void* k, const void* v,
                             void* out, void* part, int B, int Sq, int Sk,
                             int H, int K, int D, int causal, float scale,
                             int bq, int bk, void* stream) {
  return launch_f32_ffma(q, k, v, out, part, B, Sq, Sk, H, K, D, causal,
                         scale, bq, bk, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int K,
                         int D, int causal, float scale, void* stream) {
  return launch_bf16_wgmma(q, k, v, out, B, Sq, Sk, H, K, D, causal, scale,
                           stream);
}

// Dynamic shared memory a block of the ffma tile takes at head size D, or
// -1 for a tile or head size outside the set.
int flash_attention_smem_bytes(int D, int bq, int bk) {
  switch (D) {
    case 16: return ffma_smem<16>(bq, bk);
    case 32: return ffma_smem<32>(bq, bk);
    case 64: return ffma_smem<64>(bq, bk);
    case 128: return ffma_smem<128>(bq, bk);
    default: return -1;
  }
}

// The largest shared memory a block may opt in to on `device`.
int shared_memory_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
