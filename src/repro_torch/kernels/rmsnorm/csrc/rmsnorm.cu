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
// Design: the TPU's row block br was a VMEM tiling knob; on Hopper it is
// the rows a block of 256 threads takes, br in {1, 2, 4, 8} (1 by
// default), 256 / br threads a row, and the 132 SMs keep many blocks in
// flight.  The C entry takes br and dispatches with a switch to that
// instantiation, refusing any other (mirrored in ops.py's TILES).  Each
// thread sums the squares of a strided slice of its row in float32
// (neighbouring threads read neighbouring elements, so every warp load is
// coalesced); warp shuffles reduce the sums within each warp and the
// row's first warp reduces its warps' partial sums.  The second pass
// reads the row again (from L1/L2: a row is at most 32 KiB) and writes
// the output.  Wider loads (16 bytes a thread) are later work.
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

template <typename T, int BR>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int TPR = THREADS / BR;          // threads a row
  constexpr int WPR = TPR / 32;              // warps a row
  __shared__ float partial[WARPS];
  __shared__ float inv_rms[BR];
  const int r = threadIdx.x / TPR;           // this thread's row of the block
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * BR + r;
  const bool live = row < rows;              // every thread reaches the syncs
  const size_t base = static_cast<size_t>(live ? row : 0) * d;
  const T* xr = x + base;
  T* orow = out + base;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float ss = 0.f;
  if (live)
    for (int i = t; i < d; i += TPR) {
      const float v = to_float(xr[i]);
      ss = fmaf(v, v, ss);
    }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp % WPR == 0) {                     // the row's first warp
    float v = lane < WPR ? partial[warp + lane] : 0.f;
    v = warp_sum(v);
    // mean, then a correctly rounded square root and division
    if (lane == 0) inv_rms[r] = 1.0f / sqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  if (!live) return;
  const float ir = inv_rms[r];
  for (int i = t; i < d; i += TPR)
    orow[i] = from_float<T>(to_float(xr[i]) * ir * scale[i]);
}

template <typename T, int BR>
int launch_rows(const void* x, const void* scale, void* out, int rows, int d,
                float eps, void* stream) {
  rmsnorm_kernel<T, BR><<<(rows + BR - 1) / BR, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, int br, void* stream) {
  switch (br) {
    case 1: return launch_rows<T, 1>(x, scale, out, rows, d, eps, stream);
    case 2: return launch_rows<T, 2>(x, scale, out, rows, d, eps, stream);
    case 4: return launch_rows<T, 4>(x, scale, out, rows, d, eps, stream);
    case 8: return launch_rows<T, 8>(x, scale, out, rows, d, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each launch function enqueues one launch
// on the caller's stream, does not synchronize, and returns a cudaError_t
// (cudaErrorInvalidValue for rows a block, br, outside {1, 2, 4, 8}).  The
// caller guarantees rows, d > 0, a contiguous row-major x of rows*d
// elements of the named type, a contiguous float32 scale of d elements and
// an output like x, all on the current device.
extern "C" {

int rmsnorm_f32(const void* x, const void* scale, void* out, int rows, int d,
                float eps, int br, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, br, stream);
}

int rmsnorm_bf16(const void* x, const void* scale, void* out, int rows,
                 int d, float eps, int br, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, br, stream);
}

// Shared memory a block with br rows takes (static), or -1 for a br
// outside the set.
int rmsnorm_smem_bytes(int br) {
  if (br != 1 && br != 2 && br != 4 && br != 8) return -1;
  return static_cast<int>((WARPS + br) * sizeof(float));
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
