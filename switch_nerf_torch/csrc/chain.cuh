// Per-expert L-layer MLP chain, fp32 forward, for Hopper (sm_90a).
//
// Shared by expert_chain.cu (rows read in place: x [E, C, M]) and
// fused_dispatch.cu (rows gathered through a slot->token map; rows.cuh).
// bf16 runs the wgmma design of chain_sm90.cuh instead; the ragged K1R's
// fp32 and every fp32 backward (K2, K4, K2R) run chain_tf32.cuh. One
// CTA owns one (expert, row block). The block's activations and its skip input `xin` stay in shared memory
// across all L layers, so activations touch device memory once in and
// once out; W_l is streamed through shared memory in tiles of kKTile rows.
//
// Per layer, in exactly the order of the TPU kernel
// (switch_nerf_tpu/ops/expert_kernel.py:_fwd_kernel):
//   z = h @ W_l            accumulated in fp32
//   z = z + b_l
//   skip layer:  z += xin; ReLU unless last; xin = z
//   other layer: ReLU unless last
//
// fp32 runs on the CUDA cores with fp32 FMAs: a single TF32 product keeps
// only ~3 decimal digits and misses the fp32 tolerance. The split-precision
// product of chain_tf32.cuh (3xTF32: hi*hi + hi*lo + lo*hi) keeps error
// near fp32's; K1R and the backwards use it, K1/K3's fp32 stays here.
//
// Widths 64-512, one design: a CTA's 32 rows, their skip input and one
// 32-row W tile take (2 * 32 + 32) * (M + 4) * 4 bytes of shared memory,
// 198,144 B at M = 512 (Mission Bay's trunk under --no_amp), under the
// H100's 232,448 B a block; each thread keeps 4 rows x M/32 columns of
// accumulators, 64 at M = 512.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kKTile = 32;     // rows of W_l per shared-memory tile

// Source row of expert row r (< er.count): in place the row itself,
// gathered through the map.
template <int SRC>
__device__ __forceinline__ long long source_row(const int* __restrict__ idx,
                                                const ExpertRows& er, int r,
                                                int n_src) {
  const long long slot = er.base + r;
  if (SRC != kGather) return slot;
  const int t = idx[slot];
  if (t < 0 || t >= n_src) __trap();  // device-side assert: map out of range
  return t;
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

// The forward of one (expert, row block) in shared memory: loads the block's
// rows (zeros past the expert's last row) into h and xin and runs the L
// layers in place; h ends as the block's output. The caller has checked
// r0 < er.count. Thread (ty, tx) owns rows 4ty..4ty+3 and columns tx + 32j.
template <int M, int SRC>
__device__ __forceinline__ void chain_f32_forward(
    const float* __restrict__ src, const int* __restrict__ idx, int n_src,
    const float* __restrict__ ws, const float* __restrict__ bs, int E,
    const ExpertRows& er, int L, unsigned skip_mask, float* h, float* xin,
    float* wt) {
  constexpr int LD = F32Layout<M>::LD;
  constexpr int RV = M / 4;      // 16-byte vectors per row
  constexpr int CN = M / 32;     // columns per thread (strided by 32)

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsF32;
  const int rows = min(kRowsF32, er.count - r0);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;

  for (int i = tid; i < kRowsF32 * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const long long row = source_row<SRC>(idx, er, r0 + r, n_src);
      val = reinterpret_cast<const float4*>(src + row * M)[v];
    }
    reinterpret_cast<float4*>(h + r * LD)[v] = val;
    reinterpret_cast<float4*>(xin + r * LD)[v] = val;
  }

  for (int l = 0; l < L; ++l) {
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

template <int M, int SRC>
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

  const ExpertRows er = expert_rows<SRC>(idx, blockIdx.y, C);
  const int r0 = blockIdx.x * kRowsF32;
  chain_f32_forward<M, SRC>(src, idx, n_src, ws, bs, E, er, L, skip_mask, h,
                            xin, wt);
  __syncthreads();

  const int rows = min(kRowsF32, er.count - r0);
  for (int i = threadIdx.x; i < rows * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    reinterpret_cast<float4*>(out + (er.base + r0 + r) * M)[v] =
        reinterpret_cast<const float4*>(h + r * LD)[v];
  }
}

// -------------------------------------------------------------- launch ----
template <int M, int SRC>
int launch_width(const float* src, const int* idx, int n_src, const float* ws,
                 const float* bs, float* out, int E, int C, int L,
                 unsigned skip_mask, cudaStream_t stream) {
  auto kern = chain_f32_kernel<M, SRC>;
  const size_t smem = F32Layout<M>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kRowsF32 - 1) / kRowsF32, E);
  kern<<<grid, kThreads, smem, stream>>>(src, idx, n_src, ws, bs, out, E, C,
                                         L, skip_mask);
  return (int)cudaGetLastError();
}

// fp32 only. Returns a cudaError_t code (0 = launched). src is x [E, C, M],
// with kGather the token rows [n_src, M] that idx [E * C] names. Widths
// other than 64/128/256/512 are refused with cudaErrorInvalidValue; the
// Python wrappers check first.
template <int SRC>
int launch_chain(int device, const void* src, const int* idx, int n_src,
                 const void* ws, const void* bs, void* out, int E, int C,
                 int M, int L, unsigned skip_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(src);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bs);
  float* y = static_cast<float*>(out);
  switch (M) {
    case 64:
      return launch_width<64, SRC>(x, idx, n_src, w, b, y, E, C, L,
                                   skip_mask, s);
    case 128:
      return launch_width<128, SRC>(x, idx, n_src, w, b, y, E, C, L,
                                    skip_mask, s);
    case 256:
      return launch_width<256, SRC>(x, idx, n_src, w, b, y, E, C, L,
                                    skip_mask, s);
    case 512:
      return launch_width<512, SRC>(x, idx, n_src, w, b, y, E, C, L,
                                    skip_mask, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
