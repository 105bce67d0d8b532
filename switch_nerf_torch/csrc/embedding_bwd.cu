// The appearance embedding's backward with a fixed summation order, for
// Hopper (sm_90a). Replaces no TPU kernel: the JAX package's OneHotEmbed
// (switch_nerf_tpu/models/common.py) takes its gradient as a one-hot
// matmul, which XLA sums in one fixed order on every run, so a resumed JAX
// run repeats the uninterrupted one bit for bit. The port's gather
// (F.embedding) needs a scatter-sum backward; this one gives the same bits
// on every run, so a resumed run on the card repeats an uninterrupted one.
//
// dW[n, f] = sum of g[r, f] over the rows r with idx[r] == n, in ascending
// r, in fp32 from 0: the order of the plain version (a CPU index_add_). The
// caller sorts the indices stably (sorted [S], perm [S]: rows of one index
// stay in ascending order). One CTA per table row n finds its segment of
// the sorted list by binary search, stages 64-row tiles of its gradient
// rows in shared memory (all threads load, in parallel), and thread f adds
// the tile's rows of feature f one after another. No atomics.
//
// Bound: bytes. It reads g once (S x F x 4 B, 6.3 MB for a 32,768-row
// chunk at F = 48) and the indices, and writes dW (N x F x 4 B); one add a
// gradient entry. Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/embedding.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFloats = 8192;  // staged gradient entries (32 KB)

__device__ __forceinline__ long long lower_bound(const long long* sorted,
                                                 long long S, long long key) {
  long long lo = 0, hi = S;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (sorted[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
embedding_bwd_kernel(const float* __restrict__ g,
                     const long long* __restrict__ sorted,
                     const long long* __restrict__ perm,
                     float* __restrict__ dw, long long S, int F,
                     int tile_rows) {
  extern __shared__ float smem[];  // tile [tile_rows][F], then acc [F]
  float* tile = smem;
  float* acc = smem + tile_rows * F;
  __shared__ long long seg[2];
  const long long n = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) seg[0] = lower_bound(sorted, S, n);
  if (tid == 1) seg[1] = lower_bound(sorted, S, n + 1);
  for (int f = tid; f < F; f += kThreads) acc[f] = 0.0f;
  __syncthreads();
  const long long begin = seg[0], end = seg[1];
  for (long long j0 = begin; j0 < end; j0 += tile_rows) {
    const int rows = (int)min((long long)tile_rows, end - j0);
    for (int i = tid; i < rows * F; i += kThreads) {
      const int r = i / F, f = i % F;
      tile[i] = g[perm[j0 + r] * F + f];
    }
    __syncthreads();
    for (int f = tid; f < F; f += kThreads) {
      float a = acc[f];
      for (int r = 0; r < rows; ++r) a += tile[r * F + f];
      acc[f] = a;
    }
    __syncthreads();
  }
  for (int f = tid; f < F; f += kThreads) dw[n * F + f] = acc[f];
}

}  // namespace

// g [S, F] fp32, sorted and perm [S] int64 (torch.sort(idx, stable=True)),
// dw [N, F] fp32, every row written. Returns a cudaError_t code (0 =
// launched).
extern "C" int embedding_bwd(int device, const void* g, const void* sorted,
                             const void* perm, void* dw, long long S, int N,
                             int F, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || F <= 0 || F > kTileFloats) return (int)cudaErrorInvalidValue;
  const int tile_rows = kTileFloats / F < 64 ? kTileFloats / F : 64;
  const size_t smem = ((size_t)tile_rows * F + F) * sizeof(float);
  embedding_bwd_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const float*>(g), static_cast<const long long*>(sorted),
      static_cast<const long long*>(perm), static_cast<float*>(dw), S, F,
      tile_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* embedding_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
