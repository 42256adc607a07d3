// RMSNorm over the last axis: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2)
// + eps) * scale, float32 arithmetic, output in the input's type (float32
// or bfloat16); scale is float32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
// (body _rmsnorm_kernel), where each step of a (rows/br,) grid loaded a
// [br, d] tile into VMEM, reduced its squares and wrote the normalised tile
// in one HBM round trip.
//
// Bound on the card: a handful of operations per element against 2 or 4
// bytes read and written, far below the H100's ~295 operations per byte,
// so it is bound by bytes: the least time is (2 * rows * d * itemsize + 4d)
// over 3.35 TB/s.
//
// Design: the TPU's row block br was a VMEM tiling knob; on Hopper one
// block of 256 threads owns one row, and the 132 SMs keep many rows in
// flight.  Each thread sums the squares of a strided slice of the row in
// float32 (neighbouring threads read neighbouring elements, so every warp
// load is coalesced); warp shuffles reduce the sums within each warp and
// one warp reduces the eight partial sums.  The second pass reads the row
// again (from L1/L2: a row is at most 32 KiB) and writes the output.
// Wider loads (16 bytes a thread) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float partial[WARPS];
  __shared__ float inv_rms;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* orow = out + base;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = to_float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < WARPS ? partial[lane] : 0.f;
    v = warp_sum(v);
    // mean, then a correctly rounded square root and division
    if (lane == 0) inv_rms = 1.0f / sqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += THREADS)
    orow[i] = from_float<T>(to_float(xr[i]) * r * scale[i]);
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, void* stream) {
  rmsnorm_kernel<T><<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each function enqueues one launch on the
// caller's stream, does not synchronize, and returns cudaGetLastError().
// The caller guarantees rows, d > 0, a contiguous row-major x of rows*d
// elements of the named type, a contiguous float32 scale of d elements and
// an output like x, all on the current device.
extern "C" {

int rmsnorm_f32(const void* x, const void* scale, void* out, int rows, int d,
                float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, stream);
}

int rmsnorm_bf16(const void* x, const void* scale, void* out, int rows,
                 int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
