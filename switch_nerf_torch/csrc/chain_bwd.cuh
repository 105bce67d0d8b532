// Per-expert L-layer MLP chain, backward, for Hopper (sm_90a).
//
// Shared by expert_chain_bwd.cu (K2, rows read in place) and
// fused_dispatch_bwd.cu (K4, rows gathered through the slot->token map).
// Replaces the Pallas _bwd_kernel of switch_nerf_tpu/ops/expert_kernel.py
// and ops/fused_dispatch.py, which recompute the activation stack in VMEM,
// run the reverse sweep, and add each C block's dW/db into an output block
// that the TPU's in-order grid revisits. The card runs blocks in parallel
// and in no order, a 256x256 fp32 dW tile (256 KB) and the 8-deep stack of
// 64-row activations (256 KB bf16) both exceed a block's 227 KB of shared
// memory, so the work is split in two deterministic passes (no atomics):
//
//   pass 1, one CTA per (expert, 64-row block; 32 in fp32), as K1:
//     recompute the chain (chain_bf16_forward), writing each layer's input
//     H_l to hsave [L, E, C, M]; then the reverse sweep in shared memory,
//       g   = gh (+ gxin at a skip layer); ReLU mask from H_{l+1} > 0 unless
//             last; gxin = g at a skip layer
//       G_l = g  -> gsave [L, E, C, M]
//       gh  = cast(g @ W_l^T)          (fp32 accumulation)
//     and dx = gh + gxin, every step rounded to the input dtype as the TPU
//     kernel does.
//   pass 2, one CTA per (layer, expert, output tile):
//     dW[l, e] = H_l^T G_l with fp32 accumulators over all C inside the
//     CTA, and db[l, e] = the fp32 column sums of G_l (tiles of the first
//     tile row only). Sums run over C in ascending order.
//
// H_l and G_l are the operands the TPU kernel's dot_general contracts, in
// the same dtype. bf16 uses WMMA (mma.sync, fp32 accumulators); fp32 runs
// on the CUDA cores (TF32 would miss the fp32 tolerance).
#pragma once

#include "chain.cuh"

namespace {

// ------------------------------------------------------ pass 1, bf16 ----
constexpr int kTLdBf16 = kKTile + kPadBf16;  // row of a W^T tile (40)

template <int M>
struct Bf16BwdLayout {
  static constexpr int LD = Bf16Layout<M>::LD;
  static constexpr int h_elems = kRowsBf16 * LD;
  // the forward streams kKTile x M tiles of W, the sweep M x kKTile ones
  static constexpr int w_elems =
      kKTile * LD > M * kTLdBf16 ? kKTile * LD : M * kTLdBf16;
  static constexpr size_t bytes =
      (2 * h_elems + w_elems) * sizeof(__nv_bfloat16) +
      kWarps * 16 * 16 * sizeof(float);
};

template <int M, bool GATHER>
__global__ void __launch_bounds__(kThreads)
chain_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ src,
                      const int* __restrict__ idx, int n_src,
                      const __nv_bfloat16* __restrict__ ws,
                      const __nv_bfloat16* __restrict__ bs,
                      const __nv_bfloat16* __restrict__ g,
                      __nv_bfloat16* __restrict__ dx,
                      __nv_bfloat16* hsave,  // written, then read back
                      __nv_bfloat16* __restrict__ gsave, int E, int C, int L,
                      unsigned skip_mask) {
  using Lay = Bf16BwdLayout<M>;
  constexpr int LD = Lay::LD;
  constexpr int RV = M / 8;
  constexpr int WN = M / 4;
  constexpr int FN = WN / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xin = h + Lay::h_elems;
  __nv_bfloat16* wt = xin + Lay::h_elems;
  float* scratch = reinterpret_cast<float*>(wt + Lay::w_elems);

  chain_bf16_forward<M, GATHER>(src, idx, n_src, ws, bs, E, C, L, skip_mask,
                                h, xin, wt, scratch, hsave);
  __syncthreads();

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsBf16;
  const int rows = min(kRowsBf16, C - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / 4, wc = warp % 4;
  float* wscratch = scratch + warp * 256;
  __nv_bfloat16* gh = h;       // gradient w.r.t. the current layer output
  __nv_bfloat16* gxin = xin;   // gradient w.r.t. the current skip input

  for (int i = tid; i < kRowsBf16 * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = reinterpret_cast<const uint4*>(g + ((size_t)e * C + r0 + r) * M)[v];
    reinterpret_cast<uint4*>(gh + r * LD)[v] = val;
    reinterpret_cast<uint4*>(gxin + r * LD)[v] = make_uint4(0u, 0u, 0u, 0u);
  }

  for (int l = L - 1; l >= 0; --l) {
    const bool last = l == L - 1;
    const bool skip = (skip_mask >> l) & 1u;
    __syncthreads();  // gh holds d(layer l output); hsave rows are visible
    // elementwise: g for layer l, in place in gh (rows past C stay zero)
    const __nv_bfloat16* hnext =
        last ? nullptr : hsave + (((size_t)(l + 1) * E + e) * C + r0) * M;
    __nv_bfloat16* gl = gsave + (((size_t)l * E + e) * C + r0) * M;
    for (int i = tid; i < rows * RV; i += kThreads) {
      const int r = i / RV, v = i % RV;
      uint4 gv = reinterpret_cast<const uint4*>(gh + r * LD)[v];
      __nv_bfloat16* gp = reinterpret_cast<__nv_bfloat16*>(&gv);
      if (skip) {
        const uint4 xv = reinterpret_cast<const uint4*>(gxin + r * LD)[v];
        const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          gp[q] = __float2bfloat16(__bfloat162float(gp[q]) +
                                   __bfloat162float(xp[q]));
      }
      if (!last) {
        const uint4 hv =
            reinterpret_cast<const uint4*>(hnext + (size_t)r * M)[v];
        const __nv_bfloat16* hp = reinterpret_cast<const __nv_bfloat16*>(&hv);
#pragma unroll
        for (int q = 0; q < 8; ++q)  // g * (H > 0), as the TPU kernel
          gp[q] = __float2bfloat16(__bfloat162float(gp[q]) *
                                   (__bfloat162float(hp[q]) > 0.0f ? 1.0f
                                                                   : 0.0f));
      }
      if (skip) reinterpret_cast<uint4*>(gxin + r * LD)[v] = gv;
      reinterpret_cast<uint4*>(gh + r * LD)[v] = gv;
      reinterpret_cast<uint4*>(gl + (size_t)r * M)[v] = gv;
    }

    // gh = g @ W_l^T: W_l [M_in, M_out] streamed as M x kKTile column tiles,
    // read by WMMA as a col-major B (B[n][k] = W[k][n])
    const __nv_bfloat16* w = ws + ((size_t)l * E + e) * M * M;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int n0 = 0; n0 < M; n0 += kKTile) {
      __syncthreads();  // g written, previous W tile consumed
      for (int i = tid; i < M * (kKTile / 8); i += kThreads) {
        const int k = i / (kKTile / 8), v = i % (kKTile / 8);
        reinterpret_cast<uint4*>(wt + k * kTLdBf16)[v] =
            reinterpret_cast<const uint4*>(w + (size_t)k * M + n0)[v];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], gh + (wr * 32 + i * 16) * LD + n0 + kk,
                                 LD);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(bf, wt + (wc * WN + j * 16) * kTLdBf16 + kk,
                                 kTLdBf16);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
        }
      }
    }
    __syncthreads();  // every warp is done reading gh for this layer

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
        for (int q = 0; q < 8; ++q)
          gh[rr * LD + cc + q] = __float2bfloat16(wscratch[fr * 16 + fc + q]);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // dx = gh + gxin (gxin is zero when the chain has no skip)
  for (int i = tid; i < rows * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    uint4 gv = reinterpret_cast<const uint4*>(gh + r * LD)[v];
    const uint4 xv = reinterpret_cast<const uint4*>(gxin + r * LD)[v];
    __nv_bfloat16* gp = reinterpret_cast<__nv_bfloat16*>(&gv);
    const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      gp[q] = __float2bfloat16(__bfloat162float(gp[q]) +
                               __bfloat162float(xp[q]));
    reinterpret_cast<uint4*>(dx + ((size_t)e * C + r0 + r) * M)[v] = gv;
  }
}

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

template <int M, bool GATHER>
__global__ void __launch_bounds__(kThreads)
chain_bwd_f32_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, int n_src,
                     const float* __restrict__ ws,
                     const float* __restrict__ bs,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* hsave,  // written, then read back
                     float* __restrict__ gsave,
                     int E, int C, int L, unsigned skip_mask) {
  using Lay = F32BwdLayout<M>;
  constexpr int LD = Lay::LD;
  constexpr int RV = M / 4;
  constexpr int CN = M / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);
  float* xin = h + Lay::h_elems;
  float* wt = xin + Lay::h_elems;

  chain_f32_forward<M, GATHER>(src, idx, n_src, ws, bs, E, C, L, skip_mask,
                               h, xin, wt, hsave);
  __syncthreads();

  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRowsF32;
  const int rows = min(kRowsF32, C - r0);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  float* gh = h;
  float* gxin = xin;

  for (int i = tid; i < kRowsF32 * RV; i += kThreads) {
    const int r = i / RV, v = i % RV;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      val = reinterpret_cast<const float4*>(g + ((size_t)e * C + r0 + r) * M)[v];
    reinterpret_cast<float4*>(gh + r * LD)[v] = val;
    reinterpret_cast<float4*>(gxin + r * LD)[v] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int l = L - 1; l >= 0; --l) {
    const bool last = l == L - 1;
    const bool skip = (skip_mask >> l) & 1u;
    __syncthreads();
    const float* hnext =
        last ? nullptr : hsave + (((size_t)(l + 1) * E + e) * C + r0) * M;
    float* gl = gsave + (((size_t)l * E + e) * C + r0) * M;
    for (int i = tid; i < rows * M; i += kThreads) {
      const int r = i / M, c = i % M;
      float gv = gh[r * LD + c];
      if (skip) gv += gxin[r * LD + c];
      if (!last) gv *= hnext[(size_t)r * M + c] > 0.0f ? 1.0f : 0.0f;
      if (skip) gxin[r * LD + c] = gv;
      gh[r * LD + c] = gv;
      gl[(size_t)r * M + c] = gv;
    }

    const float* w = ws + ((size_t)l * E + e) * M * M;
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
    dx[((size_t)e * C + r0 + r) * M + c] = gh[r * LD + c] + gxin[r * LD + c];
  }
}

// --------------------------------------------------- pass 2: dW and db ----
constexpr int kCChunk = 32;  // rows of H_l / G_l staged per step

// bf16: an output tile T x T (T = min(M, 128)); 8 warps as 4 (rows) x 2
// (cols). A = H_l^T is read col-major straight from the staged H rows.
template <int M>
__global__ void __launch_bounds__(kThreads)
chain_dw_bf16_kernel(const __nv_bfloat16* __restrict__ hsave,
                     const __nv_bfloat16* __restrict__ gsave,
                     float* __restrict__ dw, float* __restrict__ db, int E,
                     int C) {
  constexpr int T = M < 128 ? M : 128;
  constexpr int TILES = M / T;
  constexpr int LDS = T + kPadBf16;
  constexpr int WM = T / 4, WN = T / 2;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int TV = T / 8;  // 16-byte vectors per staged row
  __shared__ __align__(128) __nv_bfloat16 hs[kCChunk * LDS];
  __shared__ __align__(128) __nv_bfloat16 gs[kCChunk * LDS];

  const int mt = blockIdx.x / TILES, nt = blockIdx.x % TILES;
  const int e = blockIdx.y, l = blockIdx.z;
  const int m0 = mt * T, n0 = nt * T;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const size_t base = ((size_t)l * E + e) * C * M;
  const bool do_db = mt == 0 && tid < T;
  float db_acc = 0.0f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < C; c0 += kCChunk) {
    __syncthreads();  // previous chunk consumed
    for (int i = tid; i < kCChunk * TV; i += kThreads) {
      const int c = i / TV, v = i % TV;
      uint4 hv = make_uint4(0u, 0u, 0u, 0u), gv = hv;
      if (c0 + c < C) {
        const size_t row = base + (size_t)(c0 + c) * M;
        hv = reinterpret_cast<const uint4*>(hsave + row + m0)[v];
        gv = reinterpret_cast<const uint4*>(gsave + row + n0)[v];
      }
      reinterpret_cast<uint4*>(hs + c * LDS)[v] = hv;
      reinterpret_cast<uint4*>(gs + c * LDS)[v] = gv;
    }
    __syncthreads();
    if (do_db) {
#pragma unroll 8
      for (int c = 0; c < kCChunk; ++c) db_acc += __bfloat162float(gs[c * LDS + tid]);
    }
#pragma unroll
    for (int kc = 0; kc < kCChunk; kc += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], hs + kc * LDS + wm * WM + i * 16, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, gs + kc * LDS + wn * WN + j * 16, LDS);
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
      }
    }
  }

  float* out = dw + ((size_t)l * E + e) * M * M;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm * WM + i * 16) * M + n0 + wn * WN + j * 16,
          acc[i][j], M, wmma::mem_row_major);
  if (do_db) db[((size_t)l * E + e) * M + n0 + tid] = db_acc;
}

// fp32: an output tile 64 x 64 (M >= 64); thread (ty, tx) owns rows
// ty + 16i and columns tx + 16j.
template <int M>
__global__ void __launch_bounds__(kThreads)
chain_dw_f32_kernel(const float* __restrict__ hsave,
                    const float* __restrict__ gsave, float* __restrict__ dw,
                    float* __restrict__ db, int E, int C) {
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
  const size_t base = ((size_t)l * E + e) * C * M;
  const bool do_db = mt == 0 && tid < T;
  float db_acc = 0.0f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCChunk) {
    __syncthreads();
    for (int i = tid; i < kCChunk * TV; i += kThreads) {
      const int c = i / TV, v = i % TV;
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), gv = hv;
      if (c0 + c < C) {
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
template <int M, bool GATHER>
int launch_bwd_width(const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, const void* g, void* dx,
                     void* hsave, void* gsave, float* dw, float* db, int E,
                     int C, int L, unsigned skip_mask, int is_bf16,
                     cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    using bf = __nv_bfloat16;
    auto kern = chain_bwd_bf16_kernel<M, GATHER>;
    const size_t smem = Bf16BwdLayout<M>::bytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((C + kRowsBf16 - 1) / kRowsBf16, E);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf*>(src), idx, n_src, static_cast<const bf*>(ws),
        static_cast<const bf*>(bs), static_cast<const bf*>(g),
        static_cast<bf*>(dx), static_cast<bf*>(hsave), static_cast<bf*>(gsave),
        E, C, L, skip_mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr int T = M < 128 ? M : 128;
    const dim3 grid2((M / T) * (M / T), E, L);
    chain_dw_bf16_kernel<M><<<grid2, kThreads, 0, stream>>>(
        static_cast<const bf*>(hsave), static_cast<const bf*>(gsave), dw, db,
        E, C);
  } else {
    auto kern = chain_bwd_f32_kernel<M, GATHER>;
    const size_t smem = F32BwdLayout<M>::bytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((C + kRowsF32 - 1) / kRowsF32, E);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(src), idx, n_src,
        static_cast<const float*>(ws), static_cast<const float*>(bs),
        static_cast<const float*>(g), static_cast<float*>(dx),
        static_cast<float*>(hsave), static_cast<float*>(gsave), E, C, L,
        skip_mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid2((M / 64) * (M / 64), E, L);
    chain_dw_f32_kernel<M><<<grid2, kThreads, 0, stream>>>(
        static_cast<const float*>(hsave), static_cast<const float*>(gsave), dw,
        db, E, C);
  }
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched). hsave and gsave are [L, E, C, M]
// workspaces in the input dtype; dw [L, E, M, M] and db [L, E, 1, M] fp32.
template <bool GATHER>
int launch_chain_bwd(int device, const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, const void* g, void* dx,
                     void* hsave, void* gsave, float* dw, float* db, int E,
                     int C, int M, int L, unsigned skip_mask, int is_bf16,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 64:
      return launch_bwd_width<64, GATHER>(src, idx, n_src, ws, bs, g, dx,
                                          hsave, gsave, dw, db, E, C, L,
                                          skip_mask, is_bf16, s);
    case 128:
      return launch_bwd_width<128, GATHER>(src, idx, n_src, ws, bs, g, dx,
                                           hsave, gsave, dw, db, E, C, L,
                                           skip_mask, is_bf16, s);
    case 256:
      return launch_bwd_width<256, GATHER>(src, idx, n_src, ws, bs, g, dx,
                                           hsave, gsave, dw, db, E, C, L,
                                           skip_mask, is_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
