// Per-expert L-layer MLP chain, bf16 backward, for Hopper (sm_90a): K2
// (expert_chain_bwd.cu), with kGather K4 (fused_dispatch_bwd.cu) and with
// kRagged K2R (ragged_chain_bwd.cu; rows.cuh).
//
// Replaces the bf16 case of switch_nerf_tpu/ops/expert_kernel.py:_bwd_call
// (Pallas _bwd_kernel) and of switch_nerf_tpu/ops/fused_dispatch.py:
// _bwd_call, whose kernel gathers its rows again through the slot->token
// map: here pass 1 takes chain_sm90.cuh's cp.async row gather in place of
// the TMA load of x, and everything after the input tile is K2's (H_0, the
// gathered rows, goes to hsave like every H_l; dx is d(dispatched)). The gradient needs the dx and dW products,
// 4*E*C*M^2*L = 60.1 GFLOP at the Building shape against ~65 MB of x, g,
// dx and fp32 dW: bound by tensor-core operations. The TPU kernel adds each
// C block's dW into an output block its in-order grid revisits; the card
// runs blocks in no order, so there are two deterministic passes (no
// atomics), both on the warp-specialised wgmma + TMA skeleton of
// chain_sm90.cuh:
//
//   pass 1, one CTA per 128 rows of an expert (chain_bwd_sm90): rerun the
//     forward for layers 0..L-2 (the last layer's output is never needed),
//     sending each layer's input H_l to hsave [L, E, C, M] by an
//     asynchronous TMA store and keeping each ReLU mask (H_{l+1} > 0) as
//     bits in shared memory. Then the reverse sweep, in the TPU kernel's
//     order and roundings:
//       g = gh (+ gxin at a skip layer); g *= mask unless last; gxin = g at
//       a skip layer; G_l = g -> gsave by TMA store; gh = bf16(G_l @ W_l^T)
//     with W_l read in its own row-major layout as a K-major B operand (no
//     transposing copy): 32-column slices with the 64-byte swizzle,
//     streamed W_{L-1} .. W_0 through the same ring.
//     dx = bf16(gh + gxin) leaves by TMA store. Nothing is read back from
//     device memory.
//   pass 2, one CTA per (128 rows of dW, expert, layer) (chain_dw_sm90):
//     dW[l, e] = H_l^T G_l over all C with both operands MN-major (both
//     transpose bits), fed by a 4-stage TMA ring of 64-row C slices; each
//     CTA holds a 128 x M fp32 tile in two consumer warpgroups, so G_l is
//     read M/128 times per (layer, expert) and H_l once (64-row tiles, with
//     G_l read M/64 times, measured slower). db = the fp32
//     column sums of G_l, taken from each ring stage before it is
//     released, in ascending C order by the CTAs of the first tile row.
// kRagged: x, g and dx are [N, M] sorted by expert; pass 1 reads x by
// kGather's cp.async copy and g, and writes dx, with 16-byte copies that
// stop at the expert's last row (copy_rows), zero-filling g past it, so
// G_l is 0 on those tile rows; H_l and G_l go by TMA to the expert's
// segment of the [L, ragged_ws_rows(N, E), M] workspaces (whole tiles).
// Pass 2 then splits each segment into chunks of kChunkRows rows
// (rows.cuh): one CTA per (128 rows of dW, chunk, layer) sums the chunk's
// first ceil(rows / 64) slices into a partial dW and db, and
// reduce_partials adds each expert's partials in ascending chunk order.
// Skewed counts so spread over the card (one CTA per expert over all of
// its rows lets the expert with most rows set the pass's time), and the
// grid (2 x 7 x <= 24 CTAs at E8 M256 L7, N = 32,768) fills the 132 SMs
// at balanced counts too. An expert with no rows gets dW = 0 and
// db = 0 from the reduction.
// At M = 512 (Cfg::kSplit) pass 1 runs chain_sm90.cuh's 64-row tiles with
// each consumer warpgroup on half the columns (the ReLU masks of 6 layers
// then take 24 KB, and 7 layers fit), and pass 2 cuts dW into 128 x 256
// tiles (DwCfg::kTN: wgmma's widest product), so G_l is read M/128 times
// per (layer, expert) as before.
// Every sum runs in a fixed order: results are bit-identical from run to
// run.
#pragma once

#include "chain_sm90.cuh"

namespace sm90 {

// The most layers pass 1 takes on this device: its shared memory holds the
// ReLU masks of L - 1 layers (on an H100, 8 layers at M = 256, 7 at 512).
template <int M>
inline int max_bwd_layers(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int L = 0;
  while (L < 32 && Smem<M>(L + 1, true).bytes <= limit) ++L;
  return L;
}

inline int bwd_max_layers(int device, int M) {
  switch (M) {
    case 64:
      return max_bwd_layers<64>(device);
    case 128:
      return max_bwd_layers<128>(device);
    case 256:
      return max_bwd_layers<256>(device);
    case 512:
      return max_bwd_layers<512>(device);
    default:
      return 0;
  }
}

// The sweep epilogue of layer l for this warpgroup's rows: from gh (the
// accumulator of the previous product, or the g tile already in h for the
// last layer) form G_l in h, updating gxin at a skip layer.
template <int M, bool FROM_ACC>
__device__ __forceinline__ void sweep_epilogue(float (&acc)[Cfg<M>::kAcc],
                                               uint8_t* h, uint8_t* gxin,
                                               bool skip, bool last,
                                               const uint32_t* mask, int cw,
                                               int t) {
  using C = Cfg<M>;
  const int lane = t & 31;
  const int r0 = C::row_of(cw) + (t >> 5) * 16 + (lane >> 2);
  const int q = lane & 3;
  uint32_t bits[C::kMaskWords];
#pragma unroll
  for (int w = 0; w < C::kMaskWords; ++w)
    bits[w] = last ? ~0u : mask[w * 2 * kWgThreads + cw * kWgThreads + t];
#pragma unroll
  for (int j = 0; j < C::kWN / 8; ++j) {
    const int c = C::col_of(cw) + 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      const uint32_t off = swz<C::kRows>(r0 + 8 * half, c);
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(h + off);
      __nv_bfloat162 g2 =
          FROM_ACC ? __float22bfloat162_rn(make_float2(acc[i], acc[i + 1]))
                   : *hp;
      __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(gxin + off);
      if (skip) g2 = __hadd2(g2, *xp);
      // g * (H_{l+1} > 0): keep or clear each half by its mask bit
      const uint32_t keep = (((bits[i / 32] >> (i % 32)) & 1u) ? 0xFFFFu : 0u) |
                            (((bits[i / 32] >> ((i + 1) % 32)) & 1u)
                                 ? 0xFFFF0000u : 0u);
      uint32_t gbits = *reinterpret_cast<uint32_t*>(&g2) & keep;
      g2 = *reinterpret_cast<__nv_bfloat162*>(&gbits);
      if (skip) *xp = g2;
      *hp = g2;
    }
  }
}

// dx = bf16(bf16(acc) + gxin) into h; with `zero` set, instead zero this
// thread's elements of gxin (before the sweep).
template <int M>
__device__ __forceinline__ void dx_epilogue(float (&acc)[Cfg<M>::kAcc],
                                            uint8_t* h, uint8_t* gxin,
                                            bool zero, int cw, int t) {
  using C = Cfg<M>;
  const int lane = t & 31;
  const int r0 = C::row_of(cw) + (t >> 5) * 16 + (lane >> 2);
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < C::kWN / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      const uint32_t off =
          swz<C::kRows>(r0 + 8 * half, C::col_of(cw) + 8 * j + 2 * q);
      __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(gxin + off);
      if (zero)
        *xp = __float2bfloat162_rn(0.0f);
      else
        *reinterpret_cast<__nv_bfloat162*>(h + off) = __hadd2(
            __float22bfloat162_rn(make_float2(acc[i], acc[i + 1])), *xp);
    }
  }
}

// ------------------------------------------------------------ pass 1 ----
// x_map, g_map and dx_map are used in place and with kGather; kRagged reads
// x, g and writes dx through gather (its tokens, grad and out).
template <int M, int SRC>
__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_sm90(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap wt_map,
               const __grid_constant__ CUtensorMap g_map,
               const __grid_constant__ CUtensorMap dx_map,
               const __grid_constant__ CUtensorMap hsave_map,
               const __grid_constant__ CUtensorMap gsave_map,
               const __nv_bfloat16* __restrict__ bs, const Gather gather,
               int E, int L, unsigned skip_mask) {
  using C = Cfg<M>;
  constexpr int kMaskLayer = 2 * kWgThreads * C::kMaskWords;  // words
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const Smem<M> lay(L, true);
  uint8_t* h = smem + lay.h;
  uint8_t* xin = smem + lay.xin;
  uint8_t* ring = smem + lay.ring;
  __nv_bfloat16* bias = reinterpret_cast<__nv_bfloat16*>(smem + lay.bias);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + lay.mask);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* x_full = empty + C::kStages;
  uint64_t* g_full = x_full + 1;

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * C::kRows;
  const ExpertRows er = expert_rows<SRC>(gather.idx, e, gather.C);
  if (SRC == kRagged && row0 >= er.count) return;  // past its rows
  // workspace coordinates of layer l's rows of this tile
  const long long ws_row0 = (SRC == kRagged ? er.ws : 0) + row0;
  auto ws_z = [&](int l) { return SRC == kRagged ? l : l * E + e; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads);
    }
    mbar_init(x_full, SRC != kInPlace ? kWgThreads : 1);
    mbar_init(&g_full[0], 1);
    mbar_init(&g_full[1], 1);
    fence_barrier_init();
  }
  load_bias<M>(bias, bs, E, e, L);
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    // W_0 .. W_{L-2} for the recompute, then W_{L-1} .. W_0 for the sweep
    constexpr int K = C::kKChunks;
    const int n_fwd = (L - 1) * K;
    int stage = 0;
    uint32_t phase = 0;
    auto load_w = [&](int j) {
      if (j < n_fwd) {
        produce_stage<M, true>(&w_map, ring, full, empty, (j / K) * E + e,
                               j % K, stage, phase);
      } else {
        const int r = j - n_fwd;
        produce_stage<M, false>(&wt_map, ring, full, empty,
                                (L - 1 - r / K) * E + e, r % K, stage,
                                phase);
      }
    };
    const int n_w = n_fwd + L * K;
    int j = produce_input<M, SRC>(&x_map, gather, er, h, xin, x_full, e,
                                  row0, threadIdx.x, n_w, load_w);
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      for (; j < n_w; ++j) load_w(j);
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWgThreads - 1;
    const int t = threadIdx.x % kWgThreads;
    const int row = row0 + C::row_of(cw);
    const int ws_row = (int)(ws_row0 + C::row_of(cw));
    const uint32_t a = smem_u32(h) + C::row_of(cw) * 128;
    float acc[C::kAcc];
    int stage = 0;
    uint32_t phase = 0;

    // recompute: H_l -> hsave, masks of layers 0..L-2 -> shared memory
    mbar_wait(x_full, 0);
    for (int l = 0;; ++l) {
      if (t == 0) store_rows<M>(&hsave_map, h, cw, ws_row, ws_z(l));
      if (l == L - 1) break;
      layer_product<M, 1>(acc, a, smem_u32(ring), full, empty, stage, phase,
                          cw);
      if (t == 0) bulk_wait_read();  // H_l has left h
      part_sync<M>(cw);
      fwd_epilogue<M>(acc, h, xin, bias + l * M, (skip_mask >> l) & 1u, false,
                      masks + l * kMaskLayer, cw, t);
      fence_async_smem();
      part_sync<M>(cw);
    }

    // g -> h (zero-filled past the expert's rows), gxin = 0
    if constexpr (SRC == kRagged) {
      if (t == 0) bulk_wait_read();  // H_{L-1} has left h
      part_sync<M>(cw);
      copy_rows<M, true>(const_cast<__nv_bfloat16*>(gather.grad), h, cw, t,
                         er.base, row, er.count);
      dx_epilogue<M>(acc, h, xin, true, cw, t);
      part_sync<M>(cw);
    } else {
      if (t == 0) {
        bulk_wait_read();
        mbar_expect_tx(&g_full[cw], kBox * C::kWN * 2);
        load_part<M>(h, &g_map, &g_full[cw], cw, row, e);
      }
      dx_epilogue<M>(acc, h, xin, true, cw, t);
      mbar_wait(&g_full[cw], 0);
    }

    // reverse sweep
    for (int l = L - 1; l >= 0; --l) {
      const bool skip = (skip_mask >> l) & 1u;
      if (l == L - 1)
        sweep_epilogue<M, false>(acc, h, xin, skip, true, nullptr, cw, t);
      else
        sweep_epilogue<M, true>(acc, h, xin, skip, false,
                                masks + l * kMaskLayer, cw, t);
      fence_async_smem();
      part_sync<M>(cw);
      if (t == 0) store_rows<M>(&gsave_map, h, cw, ws_row, ws_z(l));
      layer_product<M, 0>(acc, a, smem_u32(ring), full, empty, stage, phase,
                          cw);
      if (t == 0) bulk_wait_read();  // G_l has left h
      part_sync<M>(cw);
    }
    dx_epilogue<M>(acc, h, xin, false, cw, t);
    fence_async_smem();
    part_sync<M>(cw);
    if constexpr (SRC == kRagged) {
      copy_rows<M, false>(gather.out, h, cw, t, er.base, row, er.count);
    } else if (t == 0) {
      store_rows<M>(&dx_map, h, cw, row, e);
      bulk_wait();
    }
  }
}

// ------------------------------------------------------------ pass 2 ----
template <int M>
struct DwCfg {
  static constexpr int kTM = M < 128 ? M : 128;  // dW rows per CTA
  static constexpr int kTN = M < 256 ? M : 256;  // dW columns per CTA
  static constexpr int kNT = M / kTN;            // column tiles
  static constexpr int kConsumers = kTM / 64;
  static constexpr int kThreads = kWgThreads * (1 + kConsumers);
  static constexpr int kStages = 4;
  static constexpr int kHBytes = kBox * kTM * 2;  // 64 C rows of H_l
  static constexpr int kGBytes = kBox * kTN * 2;  // 64 C rows of G_l
  static constexpr int kStageBytes = kHBytes + kGBytes;
  static constexpr int kBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// counts is read with kRagged only: the workspace layers are then
// [L, ragged_ws_rows(C, E), M], blockIdx.y is a chunk of rows (rows.cuh),
// and dw / db are the partials [L, n_chunks, M, M] / [L, n_chunks, M].
template <int M, int SRC>
__global__ void __launch_bounds__(DwCfg<M>::kThreads, 1)
chain_dw_sm90(const __grid_constant__ CUtensorMap hsave_map,
              const __grid_constant__ CUtensorMap gsave_map,
              float* __restrict__ dw, float* __restrict__ db,
              const int* __restrict__ counts, int E, int C) {
  using D = DwCfg<M>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D::kStages *
                                               D::kStageBytes);
  uint64_t* empty = full + D::kStages;
  // blockIdx.x: the dW tile, kTM rows from m0 by kTN columns from n0
  const int m0 = blockIdx.x / D::kNT * D::kTM;
  const int n0 = blockIdx.x % D::kNT * D::kTN;
  const int l = blockIdx.z;
  int z, mz, mrow, rows;  // dW / db block, workspace z, first row, rows
  if constexpr (SRC == kRagged) {
    const ChunkRows cr = chunk_rows(counts, E, blockIdx.y);
    if (cr.e < 0) return;  // past the last chunk
    z = l * gridDim.y + blockIdx.y;
    mz = l;
    mrow = (int)cr.ws;
    rows = cr.count;
  } else {
    z = l * E + blockIdx.y;
    mz = z;
    mrow = 0;
    rows = C;
  }
  const int chunks = (rows + kBox - 1) / kBox;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], D::kConsumers * kWgThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    if constexpr (D::kConsumers == 2) regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = 0; ch < chunks; ++ch) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], D::kStageBytes);
        uint8_t* hs = ring + stage * D::kStageBytes;
        uint8_t* gs = hs + D::kHBytes;
        for (int p = 0; p < D::kTM / kBox; ++p)
          tma_load(hs + p * kBoxBytes, &hsave_map, &full[stage],
                   m0 + p * kBox, mrow + ch * kBox, mz);
        for (int p = 0; p < D::kTN / kBox; ++p)
          tma_load(gs + p * kBoxBytes, &gsave_map, &full[stage],
                   n0 + p * kBox, mrow + ch * kBox, mz);
        if (++stage == D::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumers (one warpgroup at M = 64 needs no rebalancing)
    if constexpr (D::kConsumers == 2) regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWgThreads - 1;
    const int t = threadIdx.x % kWgThreads;
    // db: the CTAs of the first tile row; columns n0 + nt + k * kDbStride
    constexpr int kDbStride = D::kConsumers * kWgThreads;
    constexpr int kDbCols = (D::kTN + kDbStride - 1) / kDbStride;
    const int nt = cw * kWgThreads + t;
    const bool do_db = m0 == 0 && nt < D::kTN;
    float db_acc[kDbCols];
#pragma unroll
    for (int k = 0; k < kDbCols; ++k) db_acc[k] = 0.0f;
    float acc[D::kTN / 2];
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    fence_acc(acc);
    wg_fence();
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch) {
      mbar_wait(&full[stage], phase);
      const uint8_t* hs = ring + stage * D::kStageBytes;
      const uint8_t* gs = hs + D::kHBytes;
      const uint32_t ha = smem_u32(hs) + cw * kBoxBytes;
      const uint32_t ga = smem_u32(gs);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<D::kTN, 1, 1>::mma(acc, desc_mnmajor(ha + ks * 2048, kBoxBytes),
                            desc_mnmajor(ga + ks * 2048, kBoxBytes),
                            (ch | ks) != 0);
      wg_commit();
      if (do_db) {
#pragma unroll
        for (int k = 0; k < kDbCols; ++k) {
          const int n = nt + k * kDbStride;
#pragma unroll 8
          for (int r = 0; r < kBox; ++r)
            db_acc[k] += __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(gs + swz<kBox>(r, n)));
        }
      }
      if (ch > 0) {
        wg_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == D::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[prev]);

    const int lane = t & 31;
    const int r = m0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);
    float* out = dw + (size_t)z * M * M;
#pragma unroll
    for (int j = 0; j < D::kTN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + (size_t)r * M + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * M + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (do_db) {
#pragma unroll
      for (int k = 0; k < kDbCols; ++k)
        db[(size_t)z * M + n0 + nt + k * kDbStride] = db_acc[k];
    }
  }
}

// ------------------------------------------------------------- host ----
// kRagged: dwp and dbp are the partial sums [L, ragged_chunks(C, E), M, M]
// and [L, ragged_chunks(C, E), M] (rows.cuh); unused otherwise.
template <int M, int SRC>
int launch_bwd_width(const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, const void* g, void* dx,
                     void* hsave, void* gsave, float* dw, float* db,
                     float* dwp, float* dbp, int E, int C, int L,
                     unsigned skip_mask, cudaStream_t stream) {
  CUtensorMap x_map, w_map, wt_map, g_map, dx_map, h_map, gs_map;
  Gather gather;
  const long long LE = (long long)L * E;
  constexpr int K = Cfg<M>::kStageK;
  // workspace layers: [L * E, C, M], or kRagged [L, ragged_ws_rows, M]
  const long long ws_rows = SRC == kRagged ? ragged_ws_rows(C, E) : C;
  const long long ws_outer = SRC == kRagged ? L : LE;
  int rc;
  if ((rc = input_map<SRC>(&x_map, &gather, src, idx, n_src, M, E, C)) != 0)
    return rc;
  if ((rc = make_map(&w_map, ws, M, M, LE, kBox, K)) != 0) return rc;
  if ((rc = make_map(&wt_map, ws, M, M, LE, K, kBox,
                     CU_TENSOR_MAP_SWIZZLE_64B)) != 0)
    return rc;
  if (SRC == kRagged) {
    gather.grad = static_cast<const __nv_bfloat16*>(g);
    g_map = CUtensorMap{};  // not read
  } else if ((rc = make_map(&g_map, g, M, C, E)) != 0) {
    return rc;
  }
  if ((rc = output_map<SRC>(&dx_map, &gather, dx, M, E, C)) != 0) return rc;
  if ((rc = make_map(&h_map, hsave, M, ws_rows, ws_outer)) != 0) return rc;
  if ((rc = make_map(&gs_map, gsave, M, ws_rows, ws_outer)) != 0) return rc;

  const int smem = Smem<M>(L, true).bytes;
  auto kern = chain_bwd_sm90<M, SRC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + Cfg<M>::kRows - 1) / Cfg<M>::kRows, E);
  kern<<<grid, kThreads, smem, stream>>>(
      x_map, w_map, wt_map, g_map, dx_map, h_map, gs_map,
      static_cast<const __nv_bfloat16*>(bs), gather, E, L, skip_mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using D = DwCfg<M>;
  auto kern2 = chain_dw_sm90<M, SRC>;
  err = cudaFuncSetAttribute(
      kern2, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kBytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (SRC == kRagged) {
    const int chunks = ragged_chunks(C, E);
    kern2<<<dim3(M / D::kTM * D::kNT, chunks, L), D::kThreads, D::kBytes,
            stream>>>(
        h_map, gs_map, dwp, dbp, idx, E, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_reduce_partials(dwp, dbp, idx, dw, db, E, M, L, chunks,
                                  stream);
  }
  kern2<<<dim3(M / D::kTM * D::kNT, E, L), D::kThreads, D::kBytes,
          stream>>>(
      h_map, gs_map, dw, db, idx, E, C);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched). src is x [E, C, M], with
// kGather the token rows [n_src, M] that idx [E * C] names (dx is then
// d(dispatched) [E, C, M]), with kRagged x [C, M] sorted by expert and idx
// the counts [E] (g and dx [C, M]). hsave and gsave are bf16 workspaces
// [L, E, C, M] (kRagged: [L, ragged_ws_rows(C, E), M]); dw [L, E, M, M]
// and db [L, E, 1, M] fp32; dwp / dbp kRagged's partial sums (else null).
template <int SRC>
int launch_chain_bwd(int device, const void* src, const int* idx, int n_src,
                     const void* ws, const void* bs, const void* g, void* dx,
                     void* hsave, void* gsave, float* dw, float* db,
                     float* dwp, float* dbp, int E, int C, int M, int L,
                     unsigned skip_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0 || L > bwd_max_layers(device, M))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 64:
      return launch_bwd_width<64, SRC>(src, idx, n_src, ws, bs, g, dx,
                                       hsave, gsave, dw, db, dwp, dbp, E,
                                       C, L, skip_mask, s);
    case 128:
      return launch_bwd_width<128, SRC>(src, idx, n_src, ws, bs, g, dx,
                                        hsave, gsave, dw, db, dwp, dbp, E,
                                        C, L, skip_mask, s);
    case 256:
      return launch_bwd_width<256, SRC>(src, idx, n_src, ws, bs, g, dx,
                                        hsave, gsave, dw, db, dwp, dbp, E,
                                        C, L, skip_mask, s);
    case 512:
      return launch_bwd_width<512, SRC>(src, idx, n_src, ws, bs, g, dx,
                                        hsave, gsave, dw, db, dwp, dbp, E,
                                        C, L, skip_mask, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
