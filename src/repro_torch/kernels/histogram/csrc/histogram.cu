// Histogram of int32 values into nbins int32 counts; values outside
// [0, nbins) are dropped.
//
// Replaces the TPU kernel src/repro/kernels/histogram/kernel.py::
// histogram_pallas (body _hist_kernel).  The TPU has no atomics, so it
// summed a one-hot compare of each chunk into an output block that its
// sequential grid revisited.  On the card this is the formulation the
// paper's Histo|Scope measured on NVIDIA GPUs, privatised shared-memory
// atomics, brought to Hopper's thread-block clusters.
//
// Bound on the card: it reads each input value once (4 bytes) and does
// one increment per value, so it is bound by memory bytes: n*4 + nbins*4
// bytes at 3.35 TB/s on an H100 SXM.  Contention on a hot bin serialises
// the shared-memory atomics, which is what the privatisation keeps off
// the global counts.
//
// Design: each block keeps its own bins in dynamic shared memory (4096
// bins are 16 KiB), zeroes them, walks the input with a grid-stride loop
// and adds with a shared atomicAdd.  The input is read as 16-byte int4
// loads on its 16-byte-aligned body, BATCH of them in flight a thread
// before their atomics; the head before the first 16-byte boundary and
// the tail after the last (at most 3 values each) are read as scalars by
// block 0, so a view at any offset and any n stay exact.  Blocks run in
// clusters of C (cudaLaunchKernelEx with a cluster dimension): after a
// cluster barrier, block rank r sums bins [r*nbins/C, (r+1)*nbins/C) over
// the C blocks' shared memories (distributed shared memory) and merges
// each non-zero sum with one global atomicAdd, so the global merges fall
// by a factor of C against one merge per block.  C = 4 was the fastest of
// 1, 2, 4, 8 and 16 at 2^20 values into 4096 bins on an H100 (PERF.md).
// A second cluster barrier keeps every block's bins alive until its
// cluster has read them.  The C entry zeroes the output on the caller's
// stream (cudaMemsetAsync) before the launch; the caller sizes the grid in
// whole clusters, from the occupancy that histogram_max_clusters reports.
// Blocks run in any order because addition commutes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CLUSTER = 4;   // blocks a cluster (ops.CLUSTER)
constexpr int BATCH = 4;   // int4 loads in flight a thread

__device__ __forceinline__ void count(int* bins, int v, int nbins) {
  // one unsigned compare drops both negative and too-large values
  if (static_cast<unsigned>(v) < static_cast<unsigned>(nbins))
    atomicAdd(&bins[v], 1);
}

__device__ __forceinline__ void count4(int* bins, int4 v, int nbins) {
  count(bins, v.x, nbins);
  count(bins, v.y, nbins);
  count(bins, v.z, nbins);
  count(bins, v.w, nbins);
}

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int* __restrict__ x, long long n,
                 int* __restrict__ out, int nbins) {
  extern __shared__ int bins[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int b = threadIdx.x; b < nbins; b += THREADS) bins[b] = 0;
  __syncthreads();

  // x = head (scalars) + nvec int4 + tail (scalars)
  const long long head = min(
      n, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(x) & 15))
                                & 15) / 4);
  const long long nvec = (n - head) / 4;
  const int tail = static_cast<int>(n - head - 4 * nvec);
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) count(bins, x[threadIdx.x], nbins);
    if (threadIdx.x >= 32 && threadIdx.x < 32 + tail)
      count(bins, x[head + 4 * nvec + threadIdx.x - 32], nbins);
  }
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (; j + (BATCH - 1) * stride < nvec; j += BATCH * stride) {
    int4 vals[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) vals[u] = __ldg(xv + j + u * stride);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) count4(bins, vals[u], nbins);
  }
  for (; j < nvec; j += stride) count4(bins, __ldg(xv + j), nbins);

  cluster.sync();   // every block of the cluster has counted
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int per = (nbins + C - 1) / C;
  const int hi = min(nbins, (r + 1) * per);
  for (int b = r * per + threadIdx.x; b < hi; b += THREADS) {
    int sum = 0;
#pragma unroll 4
    for (int c = 0; c < C; ++c) sum += cluster.map_shared_rank(bins, c)[b];
    if (sum != 0) atomicAdd(&out[b], sum);
  }
  cluster.sync();   // no block leaves while its cluster reads its bins
}

int set_attributes(int nbins) {
  const size_t smem = static_cast<size_t>(nbins) * sizeof(int);
  if (smem <= 48 * 1024) return 0;
  // above 48 KiB a block gets dynamic shared memory only on request
  return static_cast<int>(cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
               int blocks, int nbins, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = static_cast<size_t>(nbins) * sizeof(int);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// Plain C interface for ctypes, on the current device.  The caller
// guarantees 0 < nbins <= the device's per-block shared-memory limit / 4.
extern "C" {

// How many clusters of CLUSTER blocks with `nbins` bins can be resident
// at once (cudaOccupancyMaxActiveClusters), into *clusters; 0 when none
// fits.  Returns a cudaError_t.
int histogram_max_clusters(int nbins, int* clusters) {
  int err = set_attributes(nbins);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, CLUSTER, nbins, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, histogram_kernel, &cfg));
}

// Zeroes the nbins int32 counts at `out` and enqueues one launch of
// `blocks` blocks (a multiple of CLUSTER) over the n > 0 contiguous
// int32 values at `x` (4-byte aligned, any offset), on the caller's
// stream; does not synchronize.  Returns the CUDA error of the two calls
// (0 when both were accepted).
int histogram_i32(const void* x, long long n, void* out, int nbins,
                  int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = set_attributes(nbins);
  if (err != 0) return err;
  const cudaError_t zero = cudaMemsetAsync(
      out, 0, static_cast<size_t>(nbins) * sizeof(int), s);
  if (zero != cudaSuccess) return static_cast<int>(zero);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, blocks, nbins, s);
  const cudaError_t launch = cudaLaunchKernelEx(
      &cfg, histogram_kernel, static_cast<const int*>(x), n,
      static_cast<int*>(out), nbins);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
