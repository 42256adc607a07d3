// Flash attention forward, causal or full, with grouped kv heads (GQA):
// out[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, kh, :] / sqrt(D)) v[b, j,
// kh, :] with kh = h / (H / K), the causal mask j <= i (both counted from
// 0), float32 arithmetic from float32 or bfloat16 loads, output in the
// inputs' type.  Layouts are the model's: q/out [B, Sq, H, D], k/v
// [B, Sk, K, D], contiguous.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas (body
// _flash_kernel), where a (B*H, nq, nk) grid ran nk innermost and carried
// the online-softmax state (m, l, acc) in VMEM scratch across the k steps,
// skipping tiles above the diagonal with pl.when.
//
// Bound on the card: 4 * D operations per (query, key) pair kept by the
// mask against (2 * Sq * H + 2 * Sk * K) * D elements moved, so at the
// sequence lengths of the nn scope and above it is bound by operations.
// This first version computes on the CUDA cores in float32 for both types
// (67 TFLOP/s peak); bfloat16 through the tensor cores (mma.sync, then
// wgmma with TMA) is later work.
//
// Design: Hopper's blocks run in parallel and in no order, so the TPU's
// sequential k grid becomes a loop inside the block.  One block of 256
// threads owns 64 query rows of one (batch, head); the kv head is indexed
// as h / (H / K), never repeated in memory.  The q tile stays in shared
// memory (transposed, float32); per step the block stages a 32-key tile of
// k (transposed) and v.  Thread (tx, ty) computes scores for rows ty + 16i
// and keys tx + 16j; a row's 16 threads are one half-warp, so the row max
// and row sum of the online softmax are four xor-shuffles.  Probabilities
// go through shared memory to the P.V product, where the same thread owns
// output columns tx + 16c of its four rows.  m, l and acc stay in
// registers across the loop, which ends at the diagonal (causal) or at Sk;
// ragged Sq and Sk edges load zeros, mask their scores and skip their
// stores.  A row whose keys are all masked (Sk == 0) has l == 0 and gives
// zeros, the reference's guard.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int K, int causal, float scale) {
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
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int K, int causal, float scale,
             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, K, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int K, int D, int causal, float scale,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 32: return launch_d<T, 32>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 64: return launch_d<T, 64>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    case 128: return launch_d<T, 128>(q, k, v, out, B, Sq, Sk, H, K, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each function enqueues one launch on the
// caller's stream, does not synchronize, and returns a cudaError_t
// (cudaErrorInvalidValue for a head size other than 16, 32, 64 or 128).
// The caller guarantees B, Sq, H, K > 0 with H % K == 0, B and H at most
// 65535, contiguous q/out [B, Sq, H, D] and k/v [B, Sk, K, D] of the named
// type on the current device.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int K, int D,
                        int causal, float scale, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Sk, H, K, D, causal, scale,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int K,
                         int D, int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, K, D, causal,
                               scale, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
