// Mamba2 SSD chunk kernel, float32: per (batch, chunk of Q tokens, head),
//   cs_q   = sum_{k<=q} dt_k A                       (inclusive cumsum)
//   y_q    = sum_{k<=q} exp(cs_q - cs_k) (C_q . B_k) dt_k x_k   [Q, P]
//   state  = sum_k exp(cs_{Q-1} - cs_k) dt_k x_k (x) B_k        [P, N]
//   ecs_q  = exp(cs_q)
// with x [b, l, h, P], dt [b, l, h], A [h], B/C [b, l, N] (one group), and
// outputs y [b, l, h, P], states [b, l/Q, h, P, N], ecs [b, l, h].  The
// inter-chunk recurrence, the C . h_in . exp(cs) term and the D skip stay
// in torch (ops.py), as they stayed in XLA.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_chunk_pallas (body _ssd_chunk_kernel), one (batch, head, chunk) per
// step of a (b, h, nc) grid with the whole chunk in VMEM.
//
// Bound on the card: per (batch, chunk) C.B^T takes Q^2 N / 2 multiply-adds,
// shared by the heads, and per head y and the state take Q^2 P / 2 and
// Q P N, against (Q P + N) floats read and (Q P + P N) written a head: at
// Q = 128, P = 64, N = 128 and 48 heads about 30 operations a byte, above
// the float32 CUDA cores' ridge of about 20 (67 TFLOP/s over 3.35 TB/s).
// So it is bound by operations, and the design is about keeping the CUDA
// cores fed (float32 fmaf throughout: the reference's rounding, which a
// TF32 tensor-core body would not keep).
//
// Design: one body, templated on the largest state size NM (64 or 128),
// that masks a ragged chunk Q <= 128, head size P <= 64 and state size
// N <= NM.  A block of 256 threads takes one (batch, chunk) and a group of
// G heads: grid (l/Q, ceil(h/G), b), G from ops.head_group so that the grid
// still gives each SM two blocks.  What held the first, untiled body back,
// and what this body does about each:
//  1. One block of 8 warps an SM, nothing hiding shared-memory latency.
//     Still one block an SM (214 KiB at N = 128 and G = 8; 168 registers),
//     but every thread now carries 32 independent accumulators.
//  2. Every multiply-add waited on shared loads (2-3 a fmaf).  Register
//     tiles with float4 loads, at least 8 fmaf a load:
//     - C.B^T: thread (qt, kt) holds rows qt + 16i and columns kt + 16j,
//       and computes only j <= i (36 of 64): the square's upper half is
//       skipped while every thread does the same work;
//     - W.x: thread (r, pt) holds rows 4r..4r+3 and 124-4r..127-4r and
//       columns 4pt..4pt+3, and stops at its rows' diagonal: half the work
//       of the square, 2112 fmaf for every thread (rows interleaved over
//       threads would balance too, but skip nothing);
//     - the state: thread (pt, nt) holds p 4pt..4pt+3 and n 4nt + 64s,
//       x scaled by exp(cs_{Q-1} - cs_k) dt_k as it is read.
//  3. C.B^T was formed again for every head.  It is formed once a block
//     and kept in registers for the group's heads; W^T[k][q] =
//     C.B[q][k] exp(cs_q - cs_k) dt_k is written from it a head, the
//     exponent taken only for k <= q (above the diagonal it is positive
//     and overflows).  A ragged last group stops at the last head.
//  4. A serial, unoverlapped prologue with a division per element.  x, B,
//     C and dt arrive by cp.async (16 bytes, or 4 where a width or pointer
//     does not allow it), zero-filled outside the operand, split by shifts;
//     the next head's x is copied during this head's products (two
//     buffers).  The cumsum of dt A stays sequential in float32, one thread
//     a head of the group, as torch.cumsum adds along a non-innermost axis
//     on the card: the exponents then equal the plain version's.  A warp
//     scan adds in another order, and with in-chunk cumsums of hundreds
//     that moves y by up to three times the 3e-5 tolerance
//     (tests/test_torch_ssd_tiles.py emulates both orders).
// Layouts: B and C rows padded to NM + 4 floats, so rows 16 apart land in
// distinct bank groups for C.B^T's float4 loads; B is read by rows in both
// C.B^T and the state, so one copy serves both.  W^T rows are padded to
// Q + 16, so its scalar stores do not conflict; C's space becomes W^T's
// once C.B^T is in registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QM = 128;         // largest chunk
constexpr int PM = 64;          // largest head size
constexpr int WS = QM + 16;     // row stride of W^T
constexpr int MAX_GROUP = 8;    // heads a block, one cumsum warp each

template <int NM>
struct Layout {
  static constexpr int BS = NM + 4;                       // B, C row stride
  static constexpr int W = QM * WS;                       // W^T
  static constexpr int CW = QM * BS > W ? QM * BS : W;    // C, then W^T
  static constexpr int B = QM * BS;
  static constexpr int X = QM * PM;                       // one x buffer
  static size_t floats(int G) {
    return static_cast<size_t>(CW) + B + 2 * X + 3 * static_cast<size_t>(G) * QM;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async; a src size of 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
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

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copies rows [0, QM) and columns [0, 4 C4) of a global tile (row r at
// src + r * stride) into shared rows of stride ld, zeros outside
// rows x cols.  C4 is a power of two, so the split is shifts.
template <int C4>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t stride, int rows, int cols,
                                      bool vec) {
#pragma unroll 4
  for (int i = threadIdx.x; i < QM * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    float* d = dst + r * ld + c;
    const float* s = src + r * stride + c;
    if (vec) {
      const bool in = r < rows && c < cols;
      cp_async16(d, in ? s : src, in);
    } else {
      for (int e = 0; e < 4; ++e) {
        const bool in = r < rows && c + e < cols;
        cp_async4(d + e, in ? s + e : src, in);
      }
    }
  }
}

template <int NM>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_tiled_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ states, float* __restrict__ ecs,
                       int l, int h, int P, int N, int Q, int G, bool vec) {
  using L = Layout<NM>;
  constexpr int BS = L::BS;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;               // [QM][WS]  W^T of one head
  float* cs = smem;               // [QM][BS]  C, until C.B^T is formed
  float* bs = smem + L::CW;       // [QM][BS]  B
  float* xs = bs + L::B;          // 2 x [QM][PM]  x of a head
  float* dts = xs + 2 * L::X;     // [G][QM]   dt
  float* acs = dts + G * QM;      // [G][QM]   inclusive cumsum of dt A
  float* eds = acs + G * QM;      // [G][QM]   exp(cs_{Q-1} - cs_k) dt_k

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int hi0 = blockIdx.y * G;
  const int bi = blockIdx.z;
  const int nc = gridDim.x;
  const int heads = min(G, h - hi0);
  // first token of the chunk, counted over (batch, position)
  const size_t t0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * Q;
  const size_t xstride = static_cast<size_t>(h) * P;

  // dt of the group's heads (one group of copies), then C, B and the
  // first head's x (a second)
  for (int i = tid; i < G * QM; i += THREADS) {
    const int j = i / QM, r = i % QM;
    const bool in = r < Q && j < heads;
    cp_async4(dts + i, in ? dt + (t0 + r) * h + hi0 + j : dt, in);
  }
  cp_async_commit();
  stage<NM / 4>(cs, BS, Cm + t0 * N, N, Q, N, vec);
  stage<NM / 4>(bs, BS, Bm + t0 * N, N, Q, N, vec);
  stage<PM / 4>(xs, PM, x + t0 * xstride + static_cast<size_t>(hi0) * P,
                xstride, Q, P, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if ((tid & 31) == 0 && (tid >> 5) < heads) {   // lane 0 of warp j: head j
    const int j = tid >> 5;
    const float a = A[hi0 + j];
    float run = 0.f;
    for (int r = 0; r < Q; ++r) {
      run = __fadd_rn(run, __fmul_rn(dts[j * QM + r], a));
      acs[j * QM + r] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * QM; i += THREADS) {
    const int j = i / QM, r = i % QM;
    float e = 0.f;
    if (r < Q && j < heads) {
      const float cr = acs[i];
      e = __fmul_rn(expf(__fsub_rn(acs[j * QM + Q - 1], cr)), dts[i]);
      ecs[(t0 + r) * h + hi0 + j] = expf(cr);
    }
    eds[i] = e;
  }
  cp_async_wait<0>();
  __syncthreads();

  // C.B^T, rows qt + 16i, columns kt + 16j, j <= i, at cb[i (i+1) / 2 + j]
  const int qt = tid & 15, kt = tid >> 4;
  float cb[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) cb[i] = 0.f;
  const int n4 = (N + 3) & ~3;
#pragma unroll 2
  for (int n = 0; n < n4; n += 4) {
    float4 cv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = lds4(cs + (qt + 16 * i) * BS + n);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = lds4(bs + (kt + 16 * j) * BS + n);
#pragma unroll
      for (int i = j; i < 8; ++i) {
        float& s = cb[i * (i + 1) / 2 + j];
        s = fmaf(cv[i].x, bv.x, s);
        s = fmaf(cv[i].y, bv.y, s);
        s = fmaf(cv[i].z, bv.z, s);
        s = fmaf(cv[i].w, bv.w, s);
      }
    }
  }
  __syncthreads();   // C is read: its space becomes W^T
  // entries of the tile above its diagonal (j > i) stay 0 for every head
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = i + 1; j < 8; ++j)
      ws[(kt + 16 * j) * WS + qt + 16 * i] = 0.f;

  for (int j = 0; j < heads; ++j) {
    const int hi = hi0 + j;
    const float* xh = xs + (j & 1) * L::X;
    if (j + 1 < heads) {   // the next head's x, during this head's products
      stage<PM / 4>(xs + ((j + 1) & 1) * L::X, PM,
                    x + t0 * xstride + static_cast<size_t>(hi + 1) * P,
                    xstride, Q, P, vec);
      cp_async_commit();
    }
    const float* csj = acs + j * QM;
    const float* dtj = dts + j * QM;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = qt + 16 * i;
      const float csq = csj[q];
#pragma unroll
      for (int jj = 0; jj <= i; ++jj) {
        const int k = kt + 16 * jj;
        float w = 0.f;
        if (k <= q && q < Q)
          w = __fmul_rn(__fmul_rn(cb[i * (i + 1) / 2 + jj],
                                  expf(__fsub_rn(csq, csj[k]))),
                        dtj[k]);
        ws[k * WS + q] = w;
      }
    }
    __syncthreads();

    {  // y = W.x: rows top..top+3 and bot..bot+3, columns 4pt..4pt+3
      const int r = tid >> 4, pt = tid & 15;
      const int top = 4 * r, bot = QM - 4 - 4 * r;
      float at[4][4], ab[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) at[a][b] = ab[a][b] = 0.f;
      const int k1 = min(top + 4, Q), k2 = min(bot + 4, Q);
      int k = 0;
#pragma unroll 2
      for (; k < k1; ++k) {
        const float4 wt = lds4(ws + k * WS + top);
        const float4 wb = lds4(ws + k * WS + bot);
        const float4 xv = lds4(xh + k * PM + 4 * pt);
        const float wtv[4] = {wt.x, wt.y, wt.z, wt.w};
        const float wbv[4] = {wb.x, wb.y, wb.z, wb.w};
        const float xvv[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            at[a][b] = fmaf(wtv[a], xvv[b], at[a][b]);
            ab[a][b] = fmaf(wbv[a], xvv[b], ab[a][b]);
          }
      }
#pragma unroll 4
      for (; k < k2; ++k) {
        const float4 wb = lds4(ws + k * WS + bot);
        const float4 xv = lds4(xh + k * PM + 4 * pt);
        const float wbv[4] = {wb.x, wb.y, wb.z, wb.w};
        const float xvv[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            ab[a][b] = fmaf(wbv[a], xvv[b], ab[a][b]);
      }
      const int p = 4 * pt;
      const auto put = [&](int q, const float (&v)[4]) {
        if (q >= Q || p >= P) return;
        float* dst = y + ((t0 + q) * h + hi) * P + p;
        if (vec)
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        else
          for (int b = 0; b < 4 && p + b < P; ++b) dst[b] = v[b];
      };
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        put(top + a, at[a]);
        put(bot + a, ab[a]);
      }
    }

    {  // the chunk state: p 4pt..4pt+3, n 64s + 4nt..+3
      constexpr int S = NM / 64;
      const int pt = tid >> 4, nt = tid & 15;
      const float* edj = eds + j * QM;
      float acc[4][4 * S];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4 * S; ++b) acc[a][b] = 0.f;
#pragma unroll 2
      for (int k = 0; k < Q; ++k) {
        const float4 xv = lds4(xh + k * PM + 4 * pt);
        const float e = edj[k];
        const float xe[4] = {__fmul_rn(xv.x, e), __fmul_rn(xv.y, e),
                             __fmul_rn(xv.z, e), __fmul_rn(xv.w, e)};
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 bv = lds4(bs + k * BS + 64 * s + 4 * nt);
          const float bvv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][4 * s + b] = fmaf(xe[a], bvv[b], acc[a][4 * s + b]);
        }
      }
      float* st = states + ((static_cast<size_t>(bi) * nc + c) * h + hi) *
                               static_cast<size_t>(P) * N;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int p = 4 * pt + a;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int n = 64 * s + 4 * nt;
          if (p >= P || n >= N) continue;
          float* dst = st + static_cast<size_t>(p) * N + n;
          const float v0 = acc[a][4 * s], v1 = acc[a][4 * s + 1],
                      v2 = acc[a][4 * s + 2], v3 = acc[a][4 * s + 3];
          if (vec) {
            *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
          } else {
            const float v[4] = {v0, v1, v2, v3};
            for (int b = 0; b < 4 && n + b < N; ++b) dst[b] = v[b];
          }
        }
      }
    }
    cp_async_wait<0>();   // the next head's x has landed
    __syncthreads();      // and W^T and this x are read
  }
}

template <int NM>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* states, void* ecs, int b, int l,
           int h, int P, int N, int Q, int G, void* stream) {
  const size_t smem = Layout<NM>::floats(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tiled_kernel<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // 16-byte copies and stores where every row starts on 16 bytes
  const bool vec = P % 4 == 0 && N % 4 == 0 && aligned(x) && aligned(B) &&
                   aligned(C) && aligned(y) && aligned(states);
  const dim3 grid(l / Q, (h + G - 1) / G, b);
  ssd_chunk_tiled_kernel<NM>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const float*>(B),
          static_cast<const float*>(C), static_cast<float*>(y),
          static_cast<float*>(states), static_cast<float*>(ecs), l, h, P, N,
          Q, G, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.
extern "C" {

// Shared memory one block of the variant with largest state size n_max
// (64 or 128) and G heads needs, in bytes; -1 for another n_max or G.
int ssd_chunk_smem_bytes(int n_max, int G) {
  if (G < 1 || G > MAX_GROUP) return -1;
  if (n_max == 64) return static_cast<int>(Layout<64>::floats(G) * sizeof(float));
  if (n_max == 128) return static_cast<int>(Layout<128>::floats(G) * sizeof(float));
  return -1;
}

// The largest dynamic shared memory a block may opt in to on `device`.
int shared_memory_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Each enqueues one launch on the caller's stream, does not synchronize,
// and returns a cudaError_t.  The caller guarantees b, h, Q > 0 with
// l % Q == 0 and l > 0, Q <= 128, P <= 64, N <= 64 (n64) or 128 (n128),
// 1 <= G <= 8, b and h at most 65535, contiguous float32 operands of the
// shapes above on the current device, and a shared-memory request within
// the device's opt-in limit.
int ssd_chunk_f32_n64(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, void* y, void* states,
                      void* ecs, int b, int l, int h, int P, int N, int Q,
                      int G, void* stream) {
  return launch<64>(x, dt, A, B, C, y, states, ecs, b, l, h, P, N, Q, G,
                    stream);
}
int ssd_chunk_f32_n128(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* states,
                       void* ecs, int b, int l, int h, int P, int N, int Q,
                       int G, void* stream) {
  return launch<128>(x, dt, A, B, C, y, states, ecs, b, l, h, P, N, Q, G,
                     stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
