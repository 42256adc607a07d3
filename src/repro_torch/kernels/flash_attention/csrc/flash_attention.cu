// Flash attention, causal or full, with grouped kv heads (GQA): the
// forward, and (bf16 only) its backward, further down:
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
// query blocks are launched first.  P is rounded to bf16 before the row
// sum as before the product, as models/layers.py::_flash_fwd_scan rounds
// it; on request each row's log-sum-exp is written for the backward.
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
constexpr float kLn2 = 0.6931471805599453f;

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
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int B, int Sq, int Sk,
                             int H, int K, int causal, float scale_log2) {
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
        uint32_t pa[8][4];
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
          // P in bf16 as the register A operand of 8 k steps of 16 keys
          // (the accumulator's columns 16 kk .. 16 kk + 15 are A's k
          // columns: sc[4 j + 2 hh + e] goes to pa[j / 2][2 (j % 2) + hh]),
          // and the row sum over the rounded values, as the scans take it
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t packed = pack_bf16(
                exp2f(fmaf(sc[4 * j + 2 * hh], scale_log2, -m_use)),
                exp2f(fmaf(sc[4 * j + 2 * hh + 1], scale_log2, -m_use)));
            pa[j / 2][2 * (j % 2) + hh] = packed;
            sum += __uint_as_float(packed << 16) +
                   __uint_as_float(packed & 0xffff0000u);
          }
          lsum[hh] = lsum[hh] * corr + sum;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j + 2 * hh] *= corr;
            o[4 * j + 2 * hh + 1] *= corr;
          }
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
      // the row's log-sum-exp of the scaled scores, natural log; a row
      // with no key +inf (the scans' contract)
      if (lse != nullptr && l % 4 == 0)
        lse[(static_cast<size_t>(b) * H + h) * Sq + qp] =
            li == 0.f ? INFINITY : (m[hh] + log2f(li)) * kLn2;
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
                 float* lse, int B, int Sq, int Sk, int H, int K, int causal,
                 float scale, cudaStream_t stream) {
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
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), lse, B, Sq,
      Sk, H, K, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

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
// One arrival on `bar` once every cp.async this thread has started has
// landed (the arrival is counted in the barrier's init count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// ------------------------------------------------------------ backward

// The backward of the bf16 variant, GQA-native and deterministic: three
// launches, no floating-point atomic, each output element written once
// by one block.  It replaces no TPU kernel: the Pallas kernel is forward
// only and the JAX models train through the XLA formulation, so this is
// the port's own, held to models/layers.py::_flash_bwd_scan.
//  (a) delta: one warp a (batch, query, head) row writes
//      delta = rowsum(dO o out) in float32, [B, H, Sq] like lse.
//  (b) dK/dV: a block of two warpgroups a (batch, kv head, 128 keys),
//      with no producer warpgroup (a third would cut a thread's
//      registers to 168, and dK and dV alone take 128 at D = 128).  Its
//      warp 0 loads the block's k and v tiles once, then keeps a ring of
//      BW_STAGES (q, dO) tiles of 64 query rows full by TMA (lane 0),
//      with each tile's lse and delta rows by cp.async, refilling a
//      stage once both warpgroups have released it.  The loop runs over
//      the G query heads of the kv head and, under the causal mask, the
//      query tiles at or after the block's keys.  Each warpgroup owns 64
//      keys and computes, per tile, the transposed products (keys the
//      wgmma M):
//      S^T = K Q^T and P^T = exp2(S^T scale log2 e - lse log2 e), rounded
//      to bf16 in registers; dV += P^T dO; dP^T = V dO^T; dS^T = P^T o
//      (dP^T - delta) scale, rounded to bf16; dK += dS^T Q.  dK and dV sum
//      in float32 registers over the whole group, so no fold follows.
//  (c) dQ: a block of 384 threads a (batch, query head, 128 query rows),
//      shaped as the forward: q and dO loaded once, a ring of 64-key k and
//      v tiles, the causal loop stopping at the block's diagonal; per tile
//      S, P, dP = dO V^T, dS as above, and dQ += dS K.
// Seven products in all, two more than a backward that adds dQ with
// atomics, so that a rerun reads the same bits.  The rounding is the
// scans' (models/layers.py::_flash_bwd_scan): P rounded to bf16 before
// dV's product, dS before dQ's and dK's, scores and sums in float32.
// It differs where the scans fold the scale into q and dO in bf16: here
// the float32 scores and dS are scaled (exact at D = 64, whose scale is
// a power of two).  Bound: 7 products of 2 D flops per kept (query, key)
// pair; at internlm2's layer (B1 S4096 H16 K8 D128 causal) 0.243 ms at
// 989 TFLOP/s.
constexpr int BW_BK = 128;      // dK/dV: keys a block, two consumers of 64
constexpr int BW_BQ = 64;       // dK/dV: query rows a tile of the ring
constexpr int BQ_BQ = 128;      // dQ: query rows a block, two consumers
constexpr int BQ_BK = 64;       // dQ: keys a tile of the ring
constexpr int BW_STAGES = 3;    // both rings
// dK/dV: two warpgroups and no producer warpgroup, so that a thread may
// hold 255 registers (dK and dV take 128 at D = 128; with a third
// warpgroup ptxas allots 168 and spills); warp 0 also loads
constexpr int KV_THREADS = 256;

template <int D>
struct BwdTiles {
  static constexpr int CH = D > 64 ? 64 : D;
  static constexpr int NCH = D / CH;
  static constexpr int RB = CH * 2;
  // dK/dV: k and v of the block, a ring of q and dO, then lse and delta
  // rows of each stage and 1 + 3 * BW_STAGES barriers
  static constexpr int KB_BYTES = BW_BK * D * 2;
  static constexpr int QT_BYTES = BW_BQ * D * 2;
  static constexpr int KV_SMEM = 2 * KB_BYTES + BW_STAGES * 2 * QT_BYTES +
                                 BW_STAGES * 2 * BW_BQ * 4 +
                                 (1 + 3 * BW_STAGES) * 8 + 1024;
  // dQ: q and dO of the block, a ring of k and v, 1 + 3 * BW_STAGES
  // barriers
  static constexpr int QB_BYTES = BQ_BQ * D * 2;
  static constexpr int KT_BYTES = BQ_BK * D * 2;
  static constexpr int Q_SMEM = 2 * QB_BYTES + BW_STAGES * 2 * KT_BYTES +
                                (1 + 3 * BW_STAGES) * 8 + 1024;
};

// D[64 x 64] = A[64 x D] . B[64 x D]^T, both K-major in shared memory:
// A at `a` (rows of a tile of `a_rows`, this warpgroup's first row
// already added), B a tile of 64 rows at `b`
template <int D>
__device__ __forceinline__ void product_abt(float (&d)[32], const uint8_t* a,
                                            int a_rows, const uint8_t* b) {
  using Tl = BwdTiles<D>;
  constexpr int RB = Tl::RB;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk * 16 % Tl::CH) * 2;
    const int box = kk * 16 / Tl::CH;
    hopper::wgmma_m64n64k16_ss<0>(
        d, hopper::make_desc(a + box * a_rows * RB + col, 16, 8 * RB, RB),
        hopper::make_desc(b + box * 64 * RB + col, 16, 8 * RB, RB), kk > 0);
  }
}

// acc[64 x D] += A[64 x 64] . B[64 x D]: A the bf16 fragments of a 64 x 64
// accumulator (four k steps of 16), B a tile of 64 rows in shared memory,
// MN-major
template <int D>
__device__ __forceinline__ void product_ab(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
  constexpr int RB = BwdTiles<D>::RB;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    pv_step<D>(acc, a[kk], hopper::make_desc(b + kk * 16 * RB, 64 * RB,
                                             8 * RB, RB));
}

// a 64 x 64 float accumulator as bf16 A fragments of four k steps
__device__ __forceinline__ void to_operand(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t stride,
                                           const float (&acc)[D / 2], int row0,
                                           int rows, int l) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= rows) continue;
    __nv_bfloat16* p = dst + static_cast<size_t>(r) * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + 2 * (l % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                 const __nv_bfloat16* __restrict__ dout,
                                 float* __restrict__ delta, int B, int Sq,
                                 int H) {
  const size_t row = static_cast<size_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<size_t>(B) * Sq * H) return;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat162* o =
      reinterpret_cast<const __nv_bfloat162*>(out + row * D) + lane * (D / 64);
  const __nv_bfloat162* g =
      reinterpret_cast<const __nv_bfloat162*>(dout + row * D) + lane * (D / 64);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const float2 a = __bfloat1622float2(o[i]), c = __bfloat1622float2(g[i]);
    acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const size_t bq = row / H;   // b * Sq + q
    delta[(bq / Sq * H + h) * Sq + bq % Sq] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int B, int Sq,
                                int Sk, int H, int K, int causal, float scale,
                                float scale_log2) {
  using Tl = BwdTiles<D>;
  constexpr int RB = Tl::RB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* vs = ks + Tl::KB_BYTES;
  uint8_t* qs = vs + Tl::KB_BYTES;                    // [STAGES][64 x D]
  uint8_t* dos = qs + BW_STAGES * Tl::QT_BYTES;       // [STAGES][64 x D]
  float* rows_lse = reinterpret_cast<float*>(dos + BW_STAGES * Tl::QT_BYTES);
  float* rows_delta = rows_lse + BW_STAGES * BW_BQ;
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(rows_delta + BW_STAGES * BW_BQ);
  uint64_t* q_full = kv_full + 1;                    // q, lse and delta
  uint64_t* do_full = q_full + BW_STAGES;
  uint64_t* empty = do_full + BW_STAGES;

  // heaviest first: under the causal mask the first key tiles meet the
  // most query tiles
  const int BK_ = B * K;
  const int kblk = static_cast<int>(blockIdx.x) / BK_;
  const int kh = static_cast<int>(blockIdx.x) % BK_ % K;
  const int b = static_cast<int>(blockIdx.x) % BK_ / K;
  const int G = H / K;
  const int k0 = kblk * BW_BK;
  const int nq = (Sq + BW_BQ - 1) / BW_BQ;
  // causal: query tiles before the block's first key are all masked
  const int qt0 = causal ? min(k0 / BW_BQ, nq) : 0;
  const int per_head = nq - qt0;
  const int iters = G * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      hopper::mbar_init(&q_full[s], 1 + 32);   // TMA lane + warp 0's copies
      hopper::mbar_init(&do_full[s], 1);
      hopper::mbar_init(&empty[s], KV_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;        // this warpgroup's 64 keys
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, l = tid % 32;
  // warp 0 also loads: tile t's q and dO by TMA (lane 0) into stage
  // t % BW_STAGES, and its lse and delta rows by cp.async (zeros past the
  // queries), all completing q_full / do_full
  const bool loader = threadIdx.x < 32;
  auto load_tile = [&](int t) {
    const int s = t % BW_STAGES;
    const int h = kh * G + t / per_head;
    const int q0 = (qt0 + t % per_head) * BW_BQ;
    if (l == 0) {
      hopper::mbar_arrive_expect_tx(&q_full[s], Tl::QT_BYTES);
#pragma unroll
      for (int c = 0; c < Tl::NCH; ++c)
        hopper::tma_load_3d(qs + s * Tl::QT_BYTES + c * BW_BQ * RB, &map_q,
                            &q_full[s], h * D + c * Tl::CH, q0, b);
      hopper::mbar_arrive_expect_tx(&do_full[s], Tl::QT_BYTES);
#pragma unroll
      for (int c = 0; c < Tl::NCH; ++c)
        hopper::tma_load_3d(dos + s * Tl::QT_BYTES + c * BW_BQ * RB, &map_do,
                            &do_full[s], h * D + c * Tl::CH, q0, b);
    }
    const size_t base = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
    for (int r = l; r < BW_BQ; r += 32) {
      const bool in = q0 + r < Sq;
      cp_async4(rows_lse + s * BW_BQ + r, lse + base + (in ? q0 + r : 0), in);
      cp_async4(rows_delta + s * BW_BQ + r, delta + base + (in ? q0 + r : 0),
                in);
    }
    cp_async_arrive(&q_full[s]);
  };
  if (loader) {
    if (l == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * Tl::KB_BYTES);
#pragma unroll
      for (int c = 0; c < Tl::NCH; ++c) {
        hopper::tma_load_3d(ks + c * BW_BK * RB, &map_k, kv_full,
                            kh * D + c * Tl::CH, k0, b);
        hopper::tma_load_3d(vs + c * BW_BK * RB, &map_v, kv_full,
                            kh * D + c * Tl::CH, k0, b);
      }
    }
    for (int t = 0; t < min(BW_STAGES, iters); ++t) load_tile(t);
  }
  {
    const int kw0 = k0 + cw * 64;
    // this thread's two keys: kw0 + 16 w + l / 4 + 8 hh
    const int key0 = kw0 + w * 16 + l / 4;
    const uint8_t* ka = ks + cw * 64 * RB;
    const uint8_t* va = vs + cw * 64 * RB;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int t = 0; t < iters; ++t) {
      // refill the stage tile t - 1 held once both warpgroups are done
      if (loader && t >= 1 && t - 1 + BW_STAGES < iters) {
        hopper::mbar_wait(&empty[(t - 1) % BW_STAGES],
                          ((t - 1) / BW_STAGES) & 1);
        load_tile(t - 1 + BW_STAGES);
      }
      const int s = t % BW_STAGES;
      const uint32_t parity = (t / BW_STAGES) & 1;
      const int q0 = (qt0 + t % per_head) * BW_BQ;
      const uint8_t* qt = qs + s * Tl::QT_BYTES;
      const uint8_t* dot = dos + s * Tl::QT_BYTES;
      hopper::mbar_wait(&q_full[s], parity);
      // a causal tile wholly before this warpgroup's keys adds nothing
      if (!causal || kw0 <= q0 + BW_BQ - 1) {
        float st[32];   // S^T, then P^T: st[4 j + 2 hh + e] is key
                        // key0 + 8 hh, query q0 + 8 j + 2 (l % 4) + e
        hopper::wgmma_fence();
        product_abt<D>(st, ka, BW_BK, qt);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        const float* ls = rows_lse + s * BW_BQ + 2 * (l % 4);
        // masked: keys after the query (causal), queries past the end
        const bool edge = (causal && kw0 + 63 > q0) || q0 + BW_BQ > Sq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = st[4 * j + 2 * hh + e];
              const int qp = q0 + 8 * j + 2 * (l % 4) + e;
              x = exp2f(fmaf(x, scale_log2, -(e ? lj.y : lj.x) * kLog2e));
              if (edge && (qp >= Sq || (causal && key0 + 8 * hh > qp)))
                x = 0.f;
            }
        }
        uint32_t pa[4][4];
        to_operand(st, pa);
        hopper::mbar_wait(&do_full[s], parity);
        float dpt[32];   // dP^T, laid out as st
        hopper::fence_regs(dv_acc);
        hopper::wgmma_fence();
        product_ab<D>(dv_acc, pa, dot);
        product_abt<D>(dpt, va, BW_BK, dot);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dpt);
        hopper::fence_regs(dv_acc);
        const float* dl = rows_delta + s * BW_BQ + 2 * (l % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dj = *reinterpret_cast<const float2*>(dl + 8 * j);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              dpt[i] = st[i] * (dpt[i] - (e ? dj.y : dj.x)) * scale;
            }
        }
        uint32_t da[4][4];
        to_operand(dpt, da);
        hopper::fence_regs(dk_acc);
        hopper::wgmma_fence();
        product_ab<D>(dk_acc, da, qt);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dk_acc);
      } else {
        hopper::mbar_wait(&do_full[s], parity);   // the stage must be whole
      }
      hopper::mbar_arrive(&empty[s]);
    }
    const size_t stride = static_cast<size_t>(K) * D;
    const size_t first = static_cast<size_t>(b) * Sk * K * D + kh * D;
    store_rows<D>(dk + first, stride, dk_acc, key0, Sk, l);
    store_rows<D>(dv + first, stride, dv_acc, key0, Sk, l);
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_do,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int B, int Sq,
                              int Sk, int H, int K, int causal, float scale,
                              float scale_log2) {
  using Tl = BwdTiles<D>;
  constexpr int RB = Tl::RB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* dos = qs + Tl::QB_BYTES;
  uint8_t* ks = dos + Tl::QB_BYTES;                  // [STAGES][64 x D]
  uint8_t* vs = ks + BW_STAGES * Tl::KT_BYTES;       // [STAGES][64 x D]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + BW_STAGES * Tl::KT_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + BW_STAGES;
  uint64_t* empty = v_full + BW_STAGES;

  // heaviest first, as the forward
  const int nq = (Sq + BQ_BQ - 1) / BQ_BQ;
  const int HB = H * B;
  const int qblk = causal ? nq - 1 - static_cast<int>(blockIdx.x) / HB
                          : static_cast<int>(blockIdx.x) / HB;
  const int h = static_cast<int>(blockIdx.x) % HB % H;
  const int b = static_cast<int>(blockIdx.x) % HB / H;
  const int kh = h / (H / K);
  const int q0 = qblk * BQ_BQ;
  const int k_end = causal ? min(Sk, q0 + BQ_BQ) : Sk;
  const int ntiles = (k_end + BQ_BK - 1) / BQ_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * Tl::QB_BYTES);
#pragma unroll
      for (int c = 0; c < Tl::NCH; ++c) {
        hopper::tma_load_3d(qs + c * BQ_BQ * RB, &map_q, q_full,
                            h * D + c * Tl::CH, q0, b);
        hopper::tma_load_3d(dos + c * BQ_BQ * RB, &map_do, q_full,
                            h * D + c * Tl::CH, q0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % BW_STAGES;
        if (t >= BW_STAGES)
          hopper::mbar_wait(&empty[s], (t / BW_STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(&k_full[s], Tl::KT_BYTES);
#pragma unroll
        for (int c = 0; c < Tl::NCH; ++c)
          hopper::tma_load_3d(ks + s * Tl::KT_BYTES + c * BQ_BK * RB, &map_k,
                              &k_full[s], kh * D + c * Tl::CH, t * BQ_BK, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], Tl::KT_BYTES);
#pragma unroll
        for (int c = 0; c < Tl::NCH; ++c)
          hopper::tma_load_3d(vs + s * Tl::KT_BYTES + c * BQ_BK * RB, &map_v,
                              &v_full[s], kh * D + c * Tl::CH, t * BQ_BK, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;                 // this warpgroup's 64 rows
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, l = tid % 32;
    const int wg_q0 = q0 + cw * 64;
    // this thread's two rows: row0 + 8 hh
    const int row0 = wg_q0 + w * 16 + l / 4;
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      const size_t at = (static_cast<size_t>(b) * H + h) * Sq + r;
      lse2[hh] = r < Sq ? lse[at] * kLog2e : INFINITY;
      dl[hh] = r < Sq ? delta[at] : 0.f;
    }
    const uint8_t* qa = qs + cw * 64 * RB;
    const uint8_t* da_ = dos + cw * 64 * RB;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % BW_STAGES;
      const uint32_t parity = (t / BW_STAGES) & 1;
      const int k0 = t * BQ_BK;
      const uint8_t* kt = ks + s * Tl::KT_BYTES;
      const uint8_t* vt = vs + s * Tl::KT_BYTES;
      hopper::mbar_wait(&k_full[s], parity);
      if (!causal || k0 <= wg_q0 + 63) {
        float sc[32];   // S, then P: sc[4 j + 2 hh + e] is row row0 + 8 hh,
                        // key k0 + 8 j + 2 (l % 4) + e
        hopper::wgmma_fence();
        product_abt<D>(sc, qa, BQ_BQ, kt);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        const bool edge = k0 + BQ_BK > Sk || (causal && k0 + BQ_BK - 1 > wg_q0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[4 * j + 2 * hh + e];
              x = exp2f(fmaf(x, scale_log2, -lse2[hh]));
              const int kp = k0 + 8 * j + 2 * (l % 4) + e;
              if (edge && (kp >= Sk || (causal && kp > row0 + 8 * hh)))
                x = 0.f;
            }
        hopper::mbar_wait(&v_full[s], parity);
        float dp[32];
        hopper::wgmma_fence();
        product_abt<D>(dp, da_, BQ_BQ, vt);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              dp[i] = sc[i] * (dp[i] - dl[hh]) * scale;
            }
        uint32_t dsa[4][4];
        to_operand(dp, dsa);
        hopper::fence_regs(dq_acc);
        hopper::wgmma_fence();
        product_ab<D>(dq_acc, dsa, kt);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq_acc);
      } else {
        hopper::mbar_wait(&v_full[s], parity);   // the stage must be whole
      }
      hopper::mbar_arrive(&empty[s]);
    }
    store_rows<D>(dq + (static_cast<size_t>(b) * Sq * H + h) * D,
                  static_cast<size_t>(H) * D, dq_acc, row0, Sq, l);
  }
}

// a map of a [B, S, heads * D] bf16 tensor whose box is `rows` positions
// of one column chunk
template <int D>
int rows_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(heads) * D,
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(heads) * D * 2,
                               static_cast<uint64_t>(S) * heads * D * 2};
  const uint32_t box[3] = {BwdTiles<D>::CH, static_cast<uint32_t>(rows), 1};
  return hopper::encode_bf16_map(map, base, 3, dims, strides, box,
                                 BwdTiles<D>::RB);
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int K,
               int causal, float scale, cudaStream_t stream) {
  using Tl = BwdTiles<D>;
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long kv_blocks =
      static_cast<long long>((Sk + BW_BK - 1) / BW_BK) * K * B;
  const long long q_blocks =
      static_cast<long long>((Sq + BQ_BQ - 1) / BQ_BQ) * H * B;
  if ((rows + 7) / 8 > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[8];   // k, v, q, dO for dK/dV; q, dO, k, v for dQ
  int err = rows_map<D>(&m[0], k, B, Sk, K, BW_BK);
  if (err == 0) err = rows_map<D>(&m[1], v, B, Sk, K, BW_BK);
  if (err == 0) err = rows_map<D>(&m[2], q, B, Sq, H, BW_BQ);
  if (err == 0) err = rows_map<D>(&m[3], dout, B, Sq, H, BW_BQ);
  if (err == 0) err = rows_map<D>(&m[4], q, B, Sq, H, BQ_BQ);
  if (err == 0) err = rows_map<D>(&m[5], dout, B, Sq, H, BQ_BQ);
  if (err == 0) err = rows_map<D>(&m[6], k, B, Sk, K, BQ_BK);
  if (err == 0) err = rows_map<D>(&m[7], v, B, Sk, K, BQ_BK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bwd_dkdv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::KV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tl::Q_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * kLog2e;
  flash_attention_bwd_delta_kernel<D>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(out),
          static_cast<const __nv_bfloat16*>(dout), delta, B, Sq, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dkdv_kernel<D>
      <<<static_cast<unsigned>(kv_blocks), KV_THREADS, Tl::KV_SMEM, stream>>>(
          m[0], m[1], m[2], m[3], lse, delta,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
          Sq, Sk, H, K, causal, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dq_kernel<D>
      <<<static_cast<unsigned>(q_blocks), W_THREADS, Tl::Q_SMEM, stream>>>(
          m[4], m[5], m[6], m[7], lse, delta,
          static_cast<__nv_bfloat16*>(dq), B, Sq, Sk, H, K, causal, scale,
          scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ ffma

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
                      float* lse, int B, int Sq, int Sk, int H, int K, int D,
                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk <= 0) return zeros(out, B, Sq, H, D, sizeof(__nv_bfloat16), s);
  if (!tma_ready(q) || !tma_ready(k) || !tma_ready(v))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_wgmma<16>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, s);
    case 32: return launch_wgmma<32>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, s);
    case 64: return launch_wgmma<64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the bf16 backward: D 64 or 128, Sq and Sk > 0, q, k, v and dO on 16
// bytes
int launch_bf16_bwd(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                    int Sk, int H, int K, int D, int causal, float scale,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0 || !tma_ready(q) || !tma_ready(k) ||
      !tma_ready(v) || !tma_ready(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (D) {
    case 64: return launch_bwd<64>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Sk, H, K, causal, scale, s);
    case 128: return launch_bwd<128>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Sk, H, K, causal, scale, s);
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
// and, with Sk > 0, needs 16-byte aligned q, k and v; a non-null `lse`
// (float32 [B, H, Sq]) also takes each row's log-sum-exp of the scaled
// scores (not written when Sk == 0).  flash_attention_bf16_bwd is its
// backward (three launches): from q, k, v, out, dout (bf16, dout [B, Sq,
// H, D]) and lse it writes delta (float32 [B, H, Sq], scratch) and bf16
// dq, dk and dv shaped as q, k and v; head sizes 64 and 128, Sq and Sk >
// 0, q, k, v and dout on 16 bytes.
extern "C" {

int flash_attention_f32_ffma(const void* q, const void* k, const void* v,
                             void* out, void* part, int B, int Sq, int Sk,
                             int H, int K, int D, int causal, float scale,
                             int bq, int bk, void* stream) {
  return launch_f32_ffma(q, k, v, out, part, B, Sq, Sk, H, K, D, causal,
                         scale, bq, bk, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int H,
                         int K, int D, int causal, float scale,
                         void* stream) {
  return launch_bf16_wgmma(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk,
                           H, K, D, causal, scale, stream);
}

int flash_attention_bf16_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int B, int Sq, int Sk, int H, int K,
                             int D, int causal, float scale, void* stream) {
  return launch_bf16_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq,
                         Sk, H, K, D, causal, scale, stream);
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
