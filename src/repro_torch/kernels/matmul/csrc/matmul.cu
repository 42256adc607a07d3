// Tiled matrix product out[M,N] = x[M,K] @ y[K,N], row-major, float32
// accumulation, output in the inputs' type (float32 or bfloat16).
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (body _matmul_kernel), where a sequential (M/bm, N/bn, K/bk) grid carried
// a float32 VMEM accumulator across the K steps of each output tile.
//
// Bound on the card: at the mxu scope's sizes (n = 256..1024) and above the
// product does 2*M*N*K operations on (MK + KN + MN) elements, far above the
// H100's ~295 operations per byte, so it is bound by operations.  This
// first version computes on the CUDA cores (float32 FMA, 67 TFLOP/s peak)
// for both types; bfloat16 through the tensor cores (mma.sync / wgmma)
// is later work.
//
// Design: Hopper's blocks run in parallel and in no order, so the TPU's
// sequential K grid becomes a loop inside the block.  Each block owns one
// 64x64 output tile; per K step of 16 it stages a 64x16 slice of x and a
// 16x64 slice of y in shared memory (converted to float32 on the way in)
// and each of its 256 threads accumulates a 4x4 sub-tile in registers.
// Thread (tx, ty) owns rows ty + 16*i and columns tx + 16*j, so a warp
// reads consecutive shared-memory words of y (no bank conflicts), the
// x operand is a broadcast, and the final stores are coalesced.  Ragged
// M, N and K edges load zeros and skip their stores, where the reference
// asserted divisibility.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;   // 16 x 16
constexpr int TM = BM / 16;    // rows per thread
constexpr int TN = BN / 16;    // columns per thread

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, int M, int N, int K) {
  // x slice, transposed (xs[k][row]); the pad spreads the transposing
  // stores of one warp over the banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN];   // y slice: ys[k][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 64x16 slice of x: consecutive threads read consecutive k of a row
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < M && gc < K)
                     ? to_float(x[static_cast<size_t>(gr) * K + gc]) : 0.f;
    }
    // 16x64 slice of y: consecutive threads read consecutive columns
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      ys[r][c] = (gr < K && gc < N)
                     ? to_float(y[static_cast<size_t>(gr) * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) out[static_cast<size_t>(r) * N + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each function enqueues one launch on the
// caller's stream, does not synchronize, and returns cudaGetLastError().
// The caller guarantees M, N > 0, contiguous row-major operands of the
// named type on the current device, and an output of M*N elements.
extern "C" {

int matmul_f32(const void* x, const void* y, void* out, int M, int N, int K,
               void* stream) {
  return launch<float>(x, y, out, M, N, K, stream);
}

int matmul_bf16(const void* x, const void* y, void* out, int M, int N, int K,
                void* stream) {
  return launch<__nv_bfloat16>(x, y, out, M, N, K, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
