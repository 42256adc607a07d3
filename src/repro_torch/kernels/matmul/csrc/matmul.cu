// Matrix product out[M,N] = x[M,K] @ y[K,N], row-major, float32
// accumulation, output in the inputs' type (float32 or bfloat16).
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (body _matmul_kernel), where a sequential (M/bm, N/bn, K/bk) grid carried
// a float32 VMEM accumulator across the K steps of each output tile.
//
// Bound on the card: at the mxu scope's sizes (n = 256..1024) and above the
// product does 2*M*N*K operations on (MK + KN + MN) elements, far above the
// H100's ~295 operations per byte, so it is bound by operations: 989
// TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32 on the CUDA
// cores.  Hopper's blocks run in parallel and in no order, so the TPU's
// sequential K grid becomes a loop inside each block.  Two variants:
//
// wgmma (bf16, K and N multiples of 8, 16-byte aligned operands): the
// tensor cores, fed by TMA.  A block owns a bm x bn output tile (bm, bn
// in {64, 128}; 128 x 128 by default) and has one producer warpgroup and
// bm / 64 consumers: 384 threads at bm = 128, 256 at bm = 64.  The
// producer's one thread keeps a ring of 4 stages full, each a bm x 64
// slice of x and a 64 x bn slice of y (bn / 64 boxes of 64 columns)
// copied by TMA with the 128-byte swizzle; one mbarrier a stage says
// "full" (its expected bytes follow the tile), one "empty" (one arrival
// a consumer thread).  Each consumer computes its 64 rows of the tile
// with wgmma.m64n{bn}k16, four a stage, into a float32 register
// accumulator, releases the stage and adds the stage's product to its
// running sum with float32 adds (the tensor cores' own sum over all of K
// drifts past the 2-ulp check at K = 4096); two consumers' products and
// folds interleave, and the copies of the next stages overlap both.
// With two consumers setmaxnreg moves registers from the producer to
// them; one consumer has the registers of a 256-thread block already.  x is K-major (A operand);
// y is [K,N] row-major, so B is MN-major (the transpose bit of the bf16
// wgmma, and a descriptor whose leading offset steps between 64-column
// chunks and whose stride offset steps between groups of 8 K rows).  TMA
// fills boxes that leave the operands with zeros, so ragged M, N and K
// need no masks on the load side; the epilogue rounds to bf16 once and
// masks its stores.
//
// simt (float32, and bf16 shapes the tensor-memory path cannot take): the
// CUDA cores.  A block of 256 threads owns a bm x bn tile (bm, bn in {64,
// 128}; the wrapper's default is 128 x 128, or 128 x 64 when the 128 x
// 128 grid would be under one wave of the card) and each thread a bm/16 x
// bn/16 register tile, read from shared memory as float4.
// K slices of 16 are double-buffered: the next slice's loads are in flight
// (cp.async for float32, registers for bf16, converted to float32 on the
// way in) while this one is multiplied.  Ragged M, N and K load zeros and
// skip their stores.  TF32 tensor cores would miss the reference's 1e-4,
// so float32 stays on the CUDA cores.
//
// Tiles: each C entry takes bm, bn and bk and dispatches with a switch to
// the template instantiated for that tile; a tile outside the set is
// refused with cudaErrorInvalidValue, never replaced.  The sets (mirrored
// in ops.py's TILES): wgmma bm, bn in {64, 128}, bk = 64; simt bm, bn in
// {64, 128}, bk = 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "_hopper/hopper.cuh"

namespace {

// ------------------------------------------------------------------ simt

constexpr int S_BK = 16;
constexpr int S_THREADS = 256;   // 16 x 16
constexpr int S_PAD = 4;         // keeps float4 rows aligned, spreads banks

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

// 4-byte asynchronous copy; src_size 0 writes a zero and reads nothing
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

// the simt tile's shared memory: x transposed with padding, y as it is,
// both double-buffered
template <int BM, int BN>
constexpr int simt_smem() {
  return 2 * S_BK * (BM + S_PAD) * 4 + 2 * S_BK * BN * 4;
}

// two blocks an SM where a register tile of up to 32 values leaves room
// for them; the 8 x 8 tile takes more than half an SM's registers
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(S_THREADS, BM * BN <= 8192 ? 2 : 1)
matmul_simt_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, int M, int N, int K) {
  constexpr int TM = BM / 16;                       // rows per thread
  constexpr int TN = BN / 16;                       // columns per thread
  constexpr int XL = BM * S_BK / S_THREADS;         // x loads per thread
  constexpr int YL = S_BK * BN / S_THREADS;         // y loads per thread
  constexpr bool kAsync = sizeof(T) == 4;           // float32: cp.async
  // x slice transposed (xs[k][row]), y slice as it is (ys[k][col])
  __shared__ __align__(16) float xs[2][S_BK][BM + S_PAD];
  __shared__ __align__(16) float ys[2][S_BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + S_BK - 1) / S_BK;

  float xr[XL], yr[YL];   // bf16: the next slice, staged in registers
  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * S_THREADS;
      const int r = e / S_BK, c = e % S_BK;
      const bool in = m0 + r < M && k0 + c < K;
      const size_t off = in ? static_cast<size_t>(m0 + r) * K + k0 + c : 0;
      if constexpr (kAsync)
        cp_async4(&xs[buf][c][r], reinterpret_cast<const float*>(x) + off, in);
      else
        xr[i] = in ? to_float(x[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < YL; ++i) {
      const int e = tid + i * S_THREADS;
      const int r = e / BN, c = e % BN;
      const bool in = k0 + r < K && n0 + c < N;
      const size_t off = in ? static_cast<size_t>(k0 + r) * N + n0 + c : 0;
      if constexpr (kAsync)
        cp_async4(&ys[buf][r][c], reinterpret_cast<const float*>(y) + off, in);
      else
        yr[i] = in ? to_float(y[off]) : 0.f;
    }
    if constexpr (kAsync) cp_async_commit();
  };
  auto store = [&](int buf) {   // bf16 only: registers to shared memory
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * S_THREADS;
      xs[buf][e % S_BK][e / S_BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < YL; ++i) {
      const int e = tid + i * S_THREADS;
      ys[buf][e / BN][e % BN] = yr[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (ktiles > 0) {
    load(0, 0);
    if constexpr (!kAsync) store(0);
  }
  for (int t = 0; t < ktiles; ++t) {
    const int buf = t & 1;
    const bool next = t + 1 < ktiles;
    __syncthreads();   // every thread is done with the other buffer
    if (next) load(buf ^ 1, (t + 1) * S_BK);
    if constexpr (kAsync) {
      if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    __syncthreads();   // this slice is in shared memory
#pragma unroll
    for (int k = 0; k < S_BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 aq =
            *reinterpret_cast<const float4*>(&xs[buf][k][64 * q + ty * 4]);
        a[4 * q] = aq.x; a[4 * q + 1] = aq.y;
        a[4 * q + 2] = aq.z; a[4 * q + 3] = aq.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 bq =
            *reinterpret_cast<const float4*>(&ys[buf][k][64 * q + tx * 4]);
        b[4 * q] = bq.x; b[4 * q + 1] = bq.y;
        b[4 * q + 2] = bq.z; b[4 * q + 3] = bq.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if constexpr (!kAsync) {
      if (next) store(buf ^ 1);
    }
  }

  // thread (tx, ty) owns rows 4 ty + i (and 64 + 4 ty + i when BM =
  // 128), columns 4 tx + j (and 64 + 4 tx + j when BN = 128)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + 64 * (i / 4) + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + 64 * (j / 4) + tx * 4 + j % 4;
      if (c < N) out[static_cast<size_t>(r) * N + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
int launch_simt_tile(const void* x, const void* y, void* out, int M, int N,
                     int K, cudaStream_t stream) {
  matmul_simt_kernel<T, BM, BN>
      <<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), S_THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* x, const void* y, void* out, int M, int N, int K,
                int bm, int bn, int bk, cudaStream_t stream) {
  if (bk != S_BK) return static_cast<int>(cudaErrorInvalidValue);
  switch (bm * 1000 + bn) {
    case 128128: return launch_simt_tile<T, 128, 128>(x, y, out, M, N, K, stream);
    case 128064: return launch_simt_tile<T, 128, 64>(x, y, out, M, N, K, stream);
    case 64128: return launch_simt_tile<T, 64, 128>(x, y, out, M, N, K, stream);
    case 64064: return launch_simt_tile<T, 64, 64>(x, y, out, M, N, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ----------------------------------------------------------------- wgmma

constexpr int W_BK = 64;          // one 128-byte swizzle row of bf16
constexpr int W_STAGES = 4;
constexpr int W_CHUNK_BYTES = W_BK * 64 * 2;      // y box of 64 columns

template <int BM, int BN>
struct WTile {
  static constexpr int CONSUMERS = BM / 64;       // warpgroups of 64 rows
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int X_BYTES = BM * W_BK * 2;   // x slice
  static constexpr int Y_BYTES = BN / 64 * W_CHUNK_BYTES;   // y slice
  static constexpr int SMEM = W_STAGES * (X_BYTES + Y_BYTES)
                              + 2 * W_STAGES * 8 + 1024;   // barriers, alignment
};

// 128 + 2 BM threads: the producer warpgroup and BM / 64 consumers
template <int BM, int BN>
__global__ void __launch_bounds__(128 + 2 * BM, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_y,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using Tl = WTile<BM, BN>;
  constexpr int W_X_BYTES = Tl::X_BYTES, W_Y_BYTES = Tl::Y_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024 bytes, a whole swizzle atom
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;
  uint8_t* ys = smem + W_STAGES * W_X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + W_STAGES * W_Y_BYTES);
  uint64_t* empty = full + W_STAGES;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + W_BK - 1) / W_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * Tl::CONSUMERS);   // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (Tl::CONSUMERS == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % W_STAGES;
        if (t >= W_STAGES) hopper::mbar_wait(&empty[s], (t / W_STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], W_X_BYTES + W_Y_BYTES);
        hopper::tma_load_2d(xs + s * W_X_BYTES, &map_x, &full[s], t * W_BK,
                            m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(ys + s * W_Y_BYTES + j * W_CHUNK_BYTES, &map_y,
                              &full[s], n0 + 64 * j, t * W_BK);
      }
    }
  } else {
    if constexpr (Tl::CONSUMERS == 2) hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;   // this warpgroup's 64 rows of the tile
    // The tensor cores' own float32 sum over a long K drifts (at K = 4096
    // past the 2-ulp bound of a sum rounded once), so each stage's
    // 64-deep product goes to a fresh accumulator, part, which ordinary
    // float32 adds fold into acc.  While this warpgroup folds, the other
    // consumer's products keep the tensor cores busy.
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

    for (int t = 0; t < ktiles; ++t) {
      const int s = t % W_STAGES;
      hopper::mbar_wait(&full[s], (t / W_STAGES) & 1);
      const uint8_t* a = xs + s * W_X_BYTES + c * 64 * 128;
      const uint8_t* b = ys + s * W_Y_BYTES;
      hopper::fence_regs(part);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk) {
        // A: K-major, 128-byte rows, 8-row groups 1024 bytes apart; a K
        // step of 16 moves 32 bytes along the row.  B: MN-major, one
        // 128-byte row per K index, 64-column chunks W_CHUNK_BYTES apart,
        // 8-row groups 1024 bytes apart; a K step moves 16 rows.
        const uint64_t da = hopper::make_desc(a + kk * 32, 16, 1024, 128);
        const uint64_t db =
            hopper::make_desc(b + kk * 16 * 128, W_CHUNK_BYTES, 1024, 128);
        if constexpr (BN == 128)
          hopper::wgmma_m64n128k16_ss<1>(part, da, db, kk > 0);
        else
          hopper::wgmma_m64n64k16_ss<1>(part, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      hopper::mbar_arrive(&empty[s]);   // the stage's products are done
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    // acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4)
    // + e of this warpgroup's 64 x BN fragment; N % 8 == 0 keeps a pair
    // in range together
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, l = tid % 32;
    const int row = m0 + c * 64 + w * 16 + l / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (l % 4);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(r) * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int BM, int BN>
int launch_wgmma_tile(const void* x, const void* y, void* out, int M, int N,
                      int K, cudaStream_t stream) {
  using Tl = WTile<BM, BN>;
  CUtensorMap map_x, map_y;
  const uint64_t dx[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t sx[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t bx[2] = {W_BK, BM};
  const uint64_t dy[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t sy[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t by[2] = {64, W_BK};
  int err = hopper::encode_bf16_map(&map_x, x, 2, dx, sx, bx, 128);
  if (err == 0) err = hopper::encode_bf16_map(&map_y, y, 2, dy, sy, by, 128);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_wgmma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_wgmma_kernel<BM, BN><<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      map_x, map_y, static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const void* x, const void* y, void* out, int M, int N, int K,
                 int bm, int bn, int bk, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (K <= 0 || K % 8 || N % 8 || !aligned || bk != W_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bm * 1000 + bn) {
    case 128128: return launch_wgmma_tile<128, 128>(x, y, out, M, N, K, stream);
    case 128064: return launch_wgmma_tile<128, 64>(x, y, out, M, N, K, stream);
    case 64128: return launch_wgmma_tile<64, 128>(x, y, out, M, N, K, stream);
    case 64064: return launch_wgmma_tile<64, 64>(x, y, out, M, N, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each launch function enqueues one launch
// on the caller's stream, does not synchronize, and returns a cudaError_t:
// cudaErrorInvalidValue for a tile (bm, bn, bk) outside the variant's set.
// The caller guarantees M, N > 0, contiguous row-major operands of the
// named type on the current device, and an output of M*N elements.
// matmul_bf16_wgmma also needs K > 0, K and N multiples of 8 and 16-byte
// aligned x and y (it returns cudaErrorInvalidValue otherwise);
// matmul_bf16 is the simt variant, which takes any shape.
extern "C" {

int matmul_f32(const void* x, const void* y, void* out, int M, int N, int K,
               int bm, int bn, int bk, void* stream) {
  return launch_simt<float>(x, y, out, M, N, K, bm, bn, bk,
                            static_cast<cudaStream_t>(stream));
}

int matmul_bf16(const void* x, const void* y, void* out, int M, int N, int K,
                int bm, int bn, int bk, void* stream) {
  return launch_simt<__nv_bfloat16>(x, y, out, M, N, K, bm, bn, bk,
                                    static_cast<cudaStream_t>(stream));
}

int matmul_bf16_wgmma(const void* x, const void* y, void* out, int M, int N,
                      int K, int bm, int bn, int bk, void* stream) {
  return launch_wgmma(x, y, out, M, N, K, bm, bn, bk,
                      static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the tile takes (wgmma: dynamic, simt: static),
// or -1 for a tile outside the variant's set.
int matmul_smem_bytes(int wgmma, int bm, int bn, int bk) {
  if (wgmma) {
    if (bk != W_BK) return -1;
    switch (bm * 1000 + bn) {
      case 128128: return WTile<128, 128>::SMEM;
      case 128064: return WTile<128, 64>::SMEM;
      case 64128: return WTile<64, 128>::SMEM;
      case 64064: return WTile<64, 64>::SMEM;
      default: return -1;
    }
  }
  if (bk != S_BK) return -1;
  switch (bm * 1000 + bn) {
    case 128128: return simt_smem<128, 128>();
    case 128064: return simt_smem<128, 64>();
    case 64128: return simt_smem<64, 128>();
    case 64064: return simt_smem<64, 64>();
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
