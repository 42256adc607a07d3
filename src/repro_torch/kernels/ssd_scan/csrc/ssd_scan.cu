// Mamba2 SSD chunk kernel, float32: per (batch, head, chunk of Q tokens),
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
// Bound on the card: per (batch, chunk) the C.B products take Q^2 N / 2
// multiply-adds (shared by the heads), and per head the y and state sums
// take Q^2 P / 2 and Q P N, against (Q P + N) floats read and (Q P + P N)
// written per head: at Q = 128, P = 64, N = 128 and 48 heads that is
// about 30 operations per byte, above the float32 CUDA cores' ridge of
// about 20 (67 TFLOP/s over 3.35 TB/s), so it is bound by operations.
// Tensor cores (TF32 or split bf16 mma) would make it bound by bytes; they
// are later work.
//
// Design: one block of 256 threads per (batch, head, chunk); blocks run in
// parallel, so every chunk computes its own state and the scan over chunks
// follows in torch.  The block stages x, B and C of its chunk in shared
// memory (B and C rows padded to N + 1 floats, so threads walking keys hit
// distinct banks), then builds the decayed score matrix W one tile of 32
// query rows at a time: W[q][k] = (C_q . B_k) exp(cs_q - cs_k) dt_k for
// k <= q, 0 above the diagonal.  The exponent is computed only for k <= q:
// above the diagonal cs_q - cs_k is positive and overflows for long chunks
// (the Pallas body exponentiated the whole square and masked afterwards).
// Each W tile then multiplies x into y rows.  At Q = 128, P = 64, N = 128
// the block needs about 180 KiB of shared memory, above the 48 KiB default:
// the launcher raises the block's limit to what it needs and refuses a
// request above the device's opt-in limit (227 KiB on an H100).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int QT = 32;   // query rows of one W tile

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(Q) * P + 2 * static_cast<size_t>(Q) * (N + 1) +
         static_cast<size_t>(QT) * Q + 3 * static_cast<size_t>(Q);
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ ecs, int l,
                 int h, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* xs = smem;               // [Q][P]
  float* bs = xs + Q * P;         // [Q][N + 1]
  float* cs = bs + Q * NP;        // [Q][N + 1]
  float* ws = cs + Q * NP;        // [QT][Q]  one tile of W
  float* dts = ws + QT * Q;       // [Q]      dt
  float* acs = dts + Q;           // [Q]      inclusive cumsum of dt * A
  float* eds = acs + Q;           // [Q]      exp(cs_{Q-1} - cs_k) dt_k

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.x;
  // first token of the chunk, counted over (batch, position)
  const size_t t0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * Q;

  for (int e = tid; e < Q * P; e += THREADS) {
    const int r = e / P, p = e % P;
    xs[e] = x[((t0 + r) * h + hi) * P + p];
  }
  for (int e = tid; e < Q * N; e += THREADS) {
    const int r = e / N, n = e % N;
    bs[r * NP + n] = Bm[(t0 + r) * N + n];
    cs[r * NP + n] = Cm[(t0 + r) * N + n];
  }
  for (int r = tid; r < Q; r += THREADS) dts[r] = dt[(t0 + r) * h + hi];
  __syncthreads();
  if (tid == 0) {   // Q sequential adds
    const float a = A[hi];
    float run = 0.f;
    for (int r = 0; r < Q; ++r) {
      run += dts[r] * a;
      acs[r] = run;
    }
  }
  __syncthreads();
  const float a_tot = acs[Q - 1];
  for (int r = tid; r < Q; r += THREADS) {
    eds[r] = expf(a_tot - acs[r]) * dts[r];
    ecs[(t0 + r) * h + hi] = expf(acs[r]);
  }

  for (int q0 = 0; q0 < Q; q0 += QT) {
    __syncthreads();   // eds visible; the previous W tile is consumed
    for (int e = tid; e < QT * Q; e += THREADS) {
      const int qi = e / Q, k = e % Q, q = q0 + qi;
      float w = 0.f;
      if (q < Q && k <= q) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot = fmaf(cs[q * NP + n], bs[k * NP + n], dot);
        w = dot * expf(acs[q] - acs[k]) * dts[k];
      }
      ws[e] = w;
    }
    __syncthreads();
    for (int e = tid; e < QT * P; e += THREADS) {
      const int qi = e / P, p = e % P, q = q0 + qi;
      if (q >= Q) continue;
      float acc = 0.f;
      for (int k = 0; k <= q; ++k) acc = fmaf(ws[qi * Q + k], xs[k * P + p], acc);
      y[((t0 + q) * h + hi) * P + p] = acc;
    }
  }

  float* st = states + ((static_cast<size_t>(bi) * nc + c) * h + hi) *
                           static_cast<size_t>(P) * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    float acc = 0.f;
    for (int k = 0; k < Q; ++k)
      acc = fmaf(xs[k * P + p] * eds[k], bs[k * NP + n], acc);
    st[e] = acc;
  }
}

}  // namespace

// Plain C interface for ctypes.
extern "C" {

// Shared memory one block needs for chunk length Q, head size P and state
// size N, in bytes (INT_MAX where that does not fit an int).
int ssd_chunk_smem_bytes(int Q, int P, int N) {
  const size_t bytes = smem_floats(Q, P, N) * sizeof(float);
  return bytes > 2147483647u ? 2147483647 : static_cast<int>(bytes);
}

// The largest dynamic shared memory a block may opt in to on `device`.
int shared_memory_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Enqueues one launch on the caller's stream, does not synchronize, and
// returns a cudaError_t.  The caller guarantees b, h, P, N > 0, Q > 0 with
// l % Q == 0 and l > 0, b and h at most 65535, contiguous float32 operands
// of the shapes above on the current device, and a shared-memory request
// within the device's opt-in limit.
int ssd_chunk_f32(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, void* y, void* states,
                  void* ecs, int b, int l, int h, int P, int N, int Q,
                  void* stream) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(l / Q, h, b);
  ssd_chunk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(ecs), l, h, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
