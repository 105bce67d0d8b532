// Per-expert L-layer MLP chain, forward, for Hopper (sm_90a).
//
// Shared by expert_chain.cu (rows read in place: x [E, C, M]) and
// fused_dispatch.cu (rows gathered through a slot->token map), and by the
// backward (chain_bwd.cuh), which reruns the forward to recompute the
// activation stack. One CTA owns
// one (expert, row block). The block's activations and its skip input `xin`
// stay in shared memory across all L layers, so activations touch device
// memory once in and once out; W_l is streamed through shared memory in
// tiles of kKTile rows.
//
// Per layer, in exactly the order of the TPU kernel
// (switch_nerf_tpu/ops/expert_kernel.py:_fwd_kernel):
//   z = h @ W_l            accumulated in fp32
//   z = cast(z) + b_l      cast to the input dtype BEFORE the bias
//   skip layer:  z += xin; ReLU unless last; xin = z
//   other layer: ReLU unless last
// In bf16 every step rounds to bf16, as the TPU kernel and torch do.
//
// bf16 runs on the tensor cores through WMMA (mma.sync, fp32 accumulators).
// fp32 runs on the CUDA cores with fp32 FMAs: TF32 tensor cores would keep
// only ~3 decimal digits and miss the fp32 tolerance.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKTile = 32;     // rows of W_l per shared-memory tile

// ---------------------------------------------------------------- bf16 ----
constexpr int kRowsBf16 = 64;  // rows per CTA: warps tile it 2 (rows) x 4 (cols)
constexpr int kPadBf16 = 8;    // row padding in elements; keeps every 16-row
                               // fragment 32-byte aligned and spreads banks

template <int M>
struct Bf16Layout {
  static constexpr int LD = M + kPadBf16;
  static constexpr int h_elems = kRowsBf16 * LD;
  static constexpr int w_elems = kKTile * LD;
  static constexpr size_t bytes =
      (2 * h_elems + w_elems) * sizeof(__nv_bfloat16) +
      kWarps * 16 * 16 * sizeof(float);
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Row index of tile row r in the source: in place, or through the map.
template <bool GATHER>
__device__ __forceinline__ long long source_row(const int* __restrict__ idx,
                                                int e, int C, int r,
                                                int n_src) {
  const long long slot = (long long)e * C + r;
  if (!GATHER) return slot;
  const int t = idx[slot];
  if (t < 0 || t >= n_src) __trap();  // device-side assert: map out of range
  return t;
}

// The forward of one (expert, row block) in shared memory: loads the block's
// rows (zeros past the ragged C edge) into h and xin and runs the L layers in
// place; h ends as the block's output. With `saved` set, each layer's input
// H_l is also written to saved [L, E, C, M] (rows inside C only) before the
// layer runs: the backward's recompute (chain_bwd.cuh).
template <int M, bool GATHER>
__device__ __forceinline__ void chain_bf16_forward(
    const __nv_bfloat16* __restrict__ src, const int* __restrict__ idx,
    int n_src, const __nv_bfloat16* __restrict__ ws,
    const __nv_bfloat16* __restrict__ bs, int E, int C, int L,
    unsigned skip_mask, __nv_bfloat16* h, __nv_bfloat16* xin,
    __nv_bfloat16* wt, float* scratch, __nv_bfloat16* __restrict__ saved) {
  constexpr int LD = Bf16Layout<M>::LD;
  constexpr int RV = M / 8;      // 16-byte vectors per row
  constexpr int WN = M / 4;      // columns per warp
  constexpr int FN = WN / 16;    // 16-wide fragments per warp along N

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsBf16;
  const int rows = min(kRowsBf16, C - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / 4, wc = warp % 4;
  float* wscratch = scratch + warp * 256;

  // prologue: the block's rows (zeros past the ragged C edge) -> h and xin
  for (int i = tid; i < kRowsBf16 * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const long long row = source_row<GATHER>(idx, e, C, r0 + r, n_src);
      val = reinterpret_cast<const uint4*>(src + row * M)[v];
    }
    reinterpret_cast<uint4*>(h + r * LD)[v] = val;
    reinterpret_cast<uint4*>(xin + r * LD)[v] = val;
  }

  for (int l = 0; l < L; ++l) {
    if (saved != nullptr) {
      __syncthreads();  // h holds layer l's input
      __nv_bfloat16* dst = saved + (((size_t)l * E + e) * C + r0) * M;
      for (int i = tid; i < rows * RV; i += kThreads) {
        const int r = i / RV, v = i % RV;
        reinterpret_cast<uint4*>(dst + (size_t)r * M)[v] =
            reinterpret_cast<const uint4*>(h + r * LD)[v];
      }
    }
    const __nv_bfloat16* w = ws + ((size_t)l * E + e) * M * M;
    const __nv_bfloat16* b = bs + ((size_t)l * E + e) * M;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < M; k0 += kKTile) {
      __syncthreads();  // h written, previous W tile consumed
      for (int i = tid; i < kKTile * RV; i += kThreads) {
        const int r = i / RV, v = i % RV;
        reinterpret_cast<uint4*>(wt + r * LD)[v] =
            reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * M)[v];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], h + (wr * 32 + i * 16) * LD + k0 + kk,
                                 LD);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, wt + kk * LD + wc * WN + j * 16, LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
        }
      }
    }
    __syncthreads();  // every warp is done reading h for this layer

    const bool last = l == L - 1;
    const bool skip = (skip_mask >> l) & 1u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(wscratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int fr = lane >> 1, fc = (lane & 1) * 8;
        const int rr = wr * 32 + i * 16 + fr;
        const int cc = wc * WN + j * 16 + fc;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float z = round_bf16(wscratch[fr * 16 + fc + q]);
          z = round_bf16(z + __bfloat162float(b[cc + q]));
          if (skip) {
            z = round_bf16(z + __bfloat162float(xin[rr * LD + cc + q]));
            if (!last) z = fmaxf(z, 0.0f);
            xin[rr * LD + cc + q] = __float2bfloat16(z);
          } else if (!last) {
            z = fmaxf(z, 0.0f);
          }
          h[rr * LD + cc + q] = __float2bfloat16(z);
        }
        __syncwarp();
      }
    }
  }
}

template <int M, bool GATHER>
__global__ void __launch_bounds__(kThreads)
chain_bf16_kernel(const __nv_bfloat16* __restrict__ src,
                  const int* __restrict__ idx, int n_src,
                  const __nv_bfloat16* __restrict__ ws,
                  const __nv_bfloat16* __restrict__ bs,
                  __nv_bfloat16* __restrict__ out, int E, int C, int L,
                  unsigned skip_mask) {
  using Lay = Bf16Layout<M>;
  constexpr int LD = Lay::LD;
  constexpr int RV = M / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xin = h + Lay::h_elems;
  __nv_bfloat16* wt = xin + Lay::h_elems;
  float* scratch = reinterpret_cast<float*>(wt + Lay::w_elems);

  chain_bf16_forward<M, GATHER>(src, idx, n_src, ws, bs, E, C, L, skip_mask,
                                h, xin, wt, scratch, nullptr);
  __syncthreads();

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsBf16;
  const int rows = min(kRowsBf16, C - r0);
  for (int i = threadIdx.x; i < rows * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    reinterpret_cast<uint4*>(out + ((size_t)e * C + r0 + r) * M)[v] =
        reinterpret_cast<const uint4*>(h + r * LD)[v];
  }
}

// ---------------------------------------------------------------- fp32 ----
constexpr int kRowsF32 = 32;   // rows per CTA: 8 warps x 4 rows
constexpr int kPadF32 = 4;

template <int M>
struct F32Layout {
  static constexpr int LD = M + kPadF32;
  static constexpr int h_elems = kRowsF32 * LD;
  static constexpr int w_elems = kKTile * LD;
  static constexpr size_t bytes = (2 * h_elems + w_elems) * sizeof(float);
};

// The fp32 counterpart of chain_bf16_forward: thread (ty, tx) owns rows
// 4ty..4ty+3 and columns tx + 32j.
template <int M, bool GATHER>
__device__ __forceinline__ void chain_f32_forward(
    const float* __restrict__ src, const int* __restrict__ idx, int n_src,
    const float* __restrict__ ws, const float* __restrict__ bs, int E, int C,
    int L, unsigned skip_mask, float* h, float* xin, float* wt,
    float* __restrict__ saved) {
  constexpr int LD = F32Layout<M>::LD;
  constexpr int RV = M / 4;      // 16-byte vectors per row
  constexpr int CN = M / 32;     // columns per thread (strided by 32)

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsF32;
  const int rows = min(kRowsF32, C - r0);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;

  for (int i = tid; i < kRowsF32 * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const long long row = source_row<GATHER>(idx, e, C, r0 + r, n_src);
      val = reinterpret_cast<const float4*>(src + row * M)[v];
    }
    reinterpret_cast<float4*>(h + r * LD)[v] = val;
    reinterpret_cast<float4*>(xin + r * LD)[v] = val;
  }

  for (int l = 0; l < L; ++l) {
    if (saved != nullptr) {
      __syncthreads();  // h holds layer l's input
      float* dst = saved + (((size_t)l * E + e) * C + r0) * M;
      for (int i = tid; i < rows * RV; i += kThreads) {
        const int r = i / RV, v = i % RV;
        reinterpret_cast<float4*>(dst + (size_t)r * M)[v] =
            reinterpret_cast<const float4*>(h + r * LD)[v];
      }
    }
    const float* w = ws + ((size_t)l * E + e) * M * M;
    const float* b = bs + ((size_t)l * E + e) * M;
    float acc[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < M; k0 += kKTile) {
      __syncthreads();
      for (int i = tid; i < kKTile * RV; i += kThreads) {
        const int r = i / RV, v = i % RV;
        reinterpret_cast<float4*>(wt + r * LD)[v] =
            reinterpret_cast<const float4*>(w + (size_t)(k0 + r) * M)[v];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKTile; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = h[(ty * 4 + i) * LD + k0 + kk];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float wv = wt[kk * LD + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
        }
      }
    }
    __syncthreads();

    const bool last = l == L - 1;
    const bool skip = (skip_mask >> l) & 1u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 32 * j;
        float z = acc[i][j] + b[c];
        if (skip) {
          z += xin[r * LD + c];
          if (!last) z = fmaxf(z, 0.0f);
          xin[r * LD + c] = z;
        } else if (!last) {
          z = fmaxf(z, 0.0f);
        }
        h[r * LD + c] = z;
      }
    }
  }
}

template <int M, bool GATHER>
__global__ void __launch_bounds__(kThreads)
chain_f32_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                 int n_src, const float* __restrict__ ws,
                 const float* __restrict__ bs, float* __restrict__ out, int E,
                 int C, int L, unsigned skip_mask) {
  using Lay = F32Layout<M>;
  constexpr int LD = Lay::LD;
  constexpr int RV = M / 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);
  float* xin = h + Lay::h_elems;
  float* wt = xin + Lay::h_elems;

  chain_f32_forward<M, GATHER>(src, idx, n_src, ws, bs, E, C, L, skip_mask,
                               h, xin, wt, nullptr);
  __syncthreads();

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsF32;
  const int rows = min(kRowsF32, C - r0);
  for (int i = threadIdx.x; i < rows * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    reinterpret_cast<float4*>(out + ((size_t)e * C + r0 + r) * M)[v] =
        reinterpret_cast<const float4*>(h + r * LD)[v];
  }
}

// -------------------------------------------------------------- launch ----
template <int M, bool GATHER>
int launch_width(const void* src, const int* idx, int n_src, const void* ws,
                 const void* bs, void* out, int E, int C, int L,
                 unsigned skip_mask, int is_bf16, cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    auto kern = chain_bf16_kernel<M, GATHER>;
    const size_t smem = Bf16Layout<M>::bytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((C + kRowsBf16 - 1) / kRowsBf16, E);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(src), idx, n_src,
        static_cast<const __nv_bfloat16*>(ws),
        static_cast<const __nv_bfloat16*>(bs),
        static_cast<__nv_bfloat16*>(out), E, C, L, skip_mask);
  } else {
    auto kern = chain_f32_kernel<M, GATHER>;
    const size_t smem = F32Layout<M>::bytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((C + kRowsF32 - 1) / kRowsF32, E);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(src), idx, n_src,
        static_cast<const float*>(ws), static_cast<const float*>(bs),
        static_cast<float*>(out), E, C, L, skip_mask);
  }
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched). Widths other than 64/128/256
// are refused with cudaErrorInvalidValue; the Python wrappers check first.
template <bool GATHER>
int launch_chain(int device, const void* src, const int* idx, int n_src,
                 const void* ws, const void* bs, void* out, int E, int C,
                 int M, int L, unsigned skip_mask, int is_bf16,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 64:
      return launch_width<64, GATHER>(src, idx, n_src, ws, bs, out, E, C, L,
                                      skip_mask, is_bf16, s);
    case 128:
      return launch_width<128, GATHER>(src, idx, n_src, ws, bs, out, E, C, L,
                                       skip_mask, is_bf16, s);
    case 256:
      return launch_width<256, GATHER>(src, idx, n_src, ws, bs, out, E, C, L,
                                       skip_mask, is_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
