// Per-expert L-layer MLP chain, fp32 backward, for Hopper (sm_90a).
//
// Shared by expert_chain_bwd.cu (K2, rows read in place) and
// fused_dispatch_bwd.cu (K4, rows gathered through the slot->token map);
// bf16 runs the wgmma design of chain_bwd_sm90.cuh instead, and the ragged
// K2R's fp32 the split-precision tensor-core design of chain_tf32.cuh.
// Replaces the Pallas _bwd_kernel of switch_nerf_tpu/ops/expert_kernel.py
// and ops/fused_dispatch.py, which recompute the activation stack in VMEM,
// run the reverse sweep, and add each C block's dW/db into an output block
// that the TPU's in-order grid revisits. The card runs blocks in parallel
// and in no order, and a 256x256 fp32 dW tile (256 KB) exceeds a block's
// 227 KB of shared memory, so the work is split in two deterministic
// passes (no atomics):
//
//   pass 1, one CTA per (expert, 32-row block), as K1's fp32 path:
//     recompute the chain (chain_f32_forward), writing each layer's input
//     H_l to the workspace hsave [L, E*C, M]; then the reverse sweep in
//     shared memory,
//       g   = gh (+ gxin at a skip layer); ReLU mask from H_{l+1} > 0 unless
//             last; gxin = g at a skip layer
//       G_l = g  -> gsave [L, E*C, M]
//       gh  = g @ W_l^T
//     and dx = gh + gxin.
//   pass 2, one CTA per (layer, expert, output tile):
//     dW[l, e] = H_l^T G_l with fp32 accumulators over the expert's rows
//     inside the CTA, and db[l, e] = the fp32 column sums of G_l (tiles of
//     the first tile row only). Sums run over the rows in ascending order.
//
// H_l and G_l are the operands the TPU kernel's dot_general contracts. fp32
// runs on the CUDA cores: a single TF32 product misses the fp32 tolerance
// (chain_tf32.cuh's 3xTF32 product, which K1R/K2R use, does not).
//
// Widths 64-512: pass 1's shared memory is (2 * 32 * (M + 4) + M * 33) * 4
// bytes, 199,680 B at M = 512; pass 2 has (M / 64)^2 tiles a (layer,
// expert), 64 at M = 512, each summing its rows in ascending order. The
// workspaces are in device memory, so the depth is the wrapper's limit
// (32 layers) at every width.
#pragma once

#include "chain.cuh"

namespace {

// ------------------------------------------------------ pass 1, fp32 ----
constexpr int kTLdF32 = kKTile + 1;  // W^T tile row; odd stride: no conflicts

template <int M>
struct F32BwdLayout {
  static constexpr int LD = F32Layout<M>::LD;
  static constexpr int h_elems = kRowsF32 * LD;
  static constexpr int w_elems =
      kKTile * LD > M * kTLdF32 ? kKTile * LD : M * kTLdF32;
  static constexpr size_t bytes = (2 * h_elems + w_elems) * sizeof(float);
};

template <int M, int SRC>
__global__ void __launch_bounds__(kThreads)
chain_bwd_f32_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, int n_src,
                     const float* __restrict__ ws,
                     const float* __restrict__ bs,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* hsave,  // written, then read back
                     float* __restrict__ gsave,
                     int E, int C, long long ws_rows, int L,
                     unsigned skip_mask) {
  using Lay = F32BwdLayout<M>;
  constexpr int LD = Lay::LD;
  constexpr int RV = M / 4;
  constexpr int CN = M / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);
  float* xin = h + Lay::h_elems;
  float* wt = xin + Lay::h_elems;

  const ExpertRows er = expert_rows<SRC>(idx, blockIdx.y, C);
  const int r0 = blockIdx.x * kRowsF32;
  chain_f32_forward<M, SRC>(src, idx, n_src, ws, bs, E, er, L, skip_mask, h,
                            xin, wt, hsave, ws_rows);
  __syncthreads();

  const int rows = min(kRowsF32, er.count - r0);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  float* gh = h;
  float* gxin = xin;

  for (int i = tid; i < kRowsF32 * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      val = reinterpret_cast<const float4*>(g + (er.base + r0 + r) * M)[v];
    reinterpret_cast<float4*>(gh + r * LD)[v] = val;
    reinterpret_cast<float4*>(gxin + r * LD)[v] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int l = L - 1; l >= 0; --l) {
    const bool last = l == L - 1;
    const bool skip = (skip_mask >> l) & 1u;
    __syncthreads();
    const float* hnext =
        last ? nullptr : hsave + ((size_t)(l + 1) * ws_rows + er.ws + r0) * M;
    float* gl = gsave + ((size_t)l * ws_rows + er.ws + r0) * M;
    for (int i = tid; i < rows * M; i += kThreads) {
      const int r = i / M, c = i % M;
      float gv = gh[r * LD + c];
      if (skip) gv += gxin[r * LD + c];
      if (!last) gv *= hnext[(size_t)r * M + c] > 0.0f ? 1.0f : 0.0f;
      if (skip) gxin[r * LD + c] = gv;
      gh[r * LD + c] = gv;
      gl[(size_t)r * M + c] = gv;
    }

    const float* w = ws + ((size_t)l * E + blockIdx.y) * M * M;
    float acc[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
    for (int n0 = 0; n0 < M; n0 += kKTile) {
      __syncthreads();
      for (int i = tid; i < M * kKTile; i += kThreads) {
        const int k = i / kKTile, nn = i % kKTile;
        wt[k * kTLdF32 + nn] = w[(size_t)k * M + n0 + nn];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKTile; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = gh[(ty * 4 + i) * LD + n0 + kk];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float wv = wt[(tx + 32 * j) * kTLdF32 + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) gh[(ty * 4 + i) * LD + tx + 32 * j] = acc[i][j];
  }
  __syncthreads();

  for (int i = tid; i < rows * M; i += kThreads) {
    const int r = i / M, c = i % M;
    dx[(er.base + r0 + r) * M + c] = gh[r * LD + c] + gxin[r * LD + c];
  }
}

// --------------------------------------------------- pass 2: dW and db ----
constexpr int kCChunk = 32;  // rows of H_l / G_l staged per step

// fp32: an output tile 64 x 64 (M >= 64); thread (ty, tx) owns rows
// ty + 16i and columns tx + 16j.
template <int M>
__global__ void __launch_bounds__(kThreads)
chain_dw_f32_kernel(const float* __restrict__ hsave,
                    const float* __restrict__ gsave, float* __restrict__ dw,
                    float* __restrict__ db, int E, int C, long long ws_rows) {
  constexpr int T = 64;
  constexpr int TILES = M / T;
  constexpr int TV = T / 4;
  __shared__ __align__(16) float hs[kCChunk * T];
  __shared__ __align__(16) float gs[kCChunk * T];

  const int mt = blockIdx.x / TILES, nt = blockIdx.x % TILES;
  const int e = blockIdx.y, l = blockIdx.z;
  const int m0 = mt * T, n0 = nt * T;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int rows = C;
  const size_t base = ((size_t)l * ws_rows + (size_t)e * C) * M;
  const bool do_db = mt == 0 && tid < T;
  float db_acc = 0.0f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < rows; c0 += kCChunk) {
    __syncthreads();
    for (int i = tid; i < kCChunk * TV; i += kThreads) {
      const int c = i / TV, v = i % TV;
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), gv = hv;
      if (c0 + c < rows) {
        const size_t row = base + (size_t)(c0 + c) * M;
        hv = reinterpret_cast<const float4*>(hsave + row + m0)[v];
        gv = reinterpret_cast<const float4*>(gsave + row + n0)[v];
      }
      reinterpret_cast<float4*>(hs + c * T)[v] = hv;
      reinterpret_cast<float4*>(gs + c * T)[v] = gv;
    }
    __syncthreads();
    if (do_db) {
#pragma unroll 8
      for (int c = 0; c < kCChunk; ++c) db_acc += gs[c * T + tid];
    }
#pragma unroll 4
    for (int c = 0; c < kCChunk; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[c * T + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs[c * T + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = dw + ((size_t)l * E + e) * M * M;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(m0 + ty + 16 * i) * M + n0 + tx + 16 * j] = acc[i][j];
  if (do_db) db[((size_t)l * E + e) * M + n0 + tid] = db_acc;
}

// -------------------------------------------------------------- launch ----
template <int M, int SRC>
int launch_bwd_width(const float* src, const int* idx, int n_src,
                     const float* ws, const float* bs, const float* g,
                     float* dx, float* hsave, float* gsave, float* dw,
                     float* db, int E, int C, int L, unsigned skip_mask,
                     cudaStream_t stream) {
  const long long ws_rows = (long long)E * C;
  auto kern = chain_bwd_f32_kernel<M, SRC>;
  const size_t smem = F32BwdLayout<M>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kRowsF32 - 1) / kRowsF32, E);
  kern<<<grid, kThreads, smem, stream>>>(src, idx, n_src, ws, bs, g, dx,
                                         hsave, gsave, E, C, ws_rows, L,
                                         skip_mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((M / 64) * (M / 64), E, L);
  chain_dw_f32_kernel<M><<<grid2, kThreads, 0, stream>>>(hsave, gsave, dw,
                                                         db, E, C, ws_rows);
  return (int)cudaGetLastError();
}

// fp32 only. Returns a cudaError_t code (0 = launched). src as
// launch_chain's. hsave and gsave are fp32 workspaces [L, E, C, M]; dw
// [L, E, M, M] and db [L, E, 1, M].
template <int SRC>
int launch_chain_bwd(int device, const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, const void* g, void* dx,
                     void* hsave, void* gsave, float* dw, float* db, int E,
                     int C, int M, int L, unsigned skip_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(src);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bs);
  const float* gy = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  float* hs = static_cast<float*>(hsave);
  float* gs = static_cast<float*>(gsave);
  switch (M) {
    case 64:
      return launch_bwd_width<64, SRC>(x, idx, n_src, w, b, gy, dxf, hs, gs,
                                       dw, db, E, C, L, skip_mask, s);
    case 128:
      return launch_bwd_width<128, SRC>(x, idx, n_src, w, b, gy, dxf, hs, gs,
                                        dw, db, E, C, L, skip_mask, s);
    case 256:
      return launch_bwd_width<256, SRC>(x, idx, n_src, w, b, gy, dxf, hs, gs,
                                        dw, db, E, C, L, skip_mask, s);
    case 512:
      return launch_bwd_width<512, SRC>(x, idx, n_src, w, b, gy, dxf, hs, gs,
                                        dw, db, E, C, L, skip_mask, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
