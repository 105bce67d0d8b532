// Where the rows of a chain launch come from, shared by the fp32
// (chain_tf32.cuh, forward and backward) and bf16 (chain_sm90.cuh,
// chain_bwd_sm90.cuh) templates.
//
//   kInPlace (K1, K2): x [E, C, M]; expert e owns rows e*C .. e*C + C - 1.
//   kGather  (K3, K4): the dispatched layout [E, C, M] again, but row
//            e*C + r is read from tokens[idx[e*C + r]].
//   kRagged  (K1R, K2R): x [N, M] sorted by expert and counts [E] on the
//            device; expert e owns rows off[e] .. off[e] + counts[e] - 1,
//            off[e] = sum(counts[:e]). A launch's grid is sized from N (the
//            counts never reach the host), so a CTA whose rows start past
//            counts[e] exits at once.
//
// The backward's workspaces (each layer's input H_l and post-mask gradient
// G_l) keep one segment per expert. In place and gathered, segment e is
// rows e*C .. of a layer of E*C rows in bf16 (TMA stores clip at C), and
// rows e * padded_seg_rows(C) .. in fp32 (chain_tf32.cuh: C rounded up to
// whole 64-row tiles, since its threads store whole tiles). Ragged,
// segment e starts at sum(ceil(counts[:e] / kSegRows) * kSegRows), so
// every tile of an expert (128 rows; 64 at M = 512) has whole rows of its
// own in the workspace, and a layer holds ragged_ws_rows(N, E) rows, a
// bound that needs no counts.
#pragma once

#include <cuda_runtime.h>

enum RowSource : int { kInPlace = 0, kGather = 1, kRagged = 2 };

constexpr int kSegRows = 128;  // ragged workspace segments: whole bf16 tiles
constexpr int kPadSegRows = 64;  // fp32 padded segments: whole fp32 tiles

// Rows per workspace layer of a ragged launch: sum_e ceil(c_e / 128) <=
// ceil(N / 128) + E tiles, whatever the counts.
__host__ __device__ inline long long ragged_ws_rows(long long N, int E) {
  return ((N + kSegRows - 1) / kSegRows + E) * kSegRows;
}

// Rows of one expert's segment in the fp32 padded workspaces.
__host__ __device__ inline long long padded_seg_rows(int C) {
  return (long long)(C + kPadSegRows - 1) / kPadSegRows * kPadSegRows;
}

// The rows of expert e: the first row in x / out / g / dx, how many, and the
// first row of its segment in a workspace layer.
struct ExpertRows {
  long long base;
  int count;
  long long ws;
};

// counts is read only by kRagged (E int32 loads, done by every thread of
// the CTA: they hit the same cache lines).
template <int SRC>
__device__ __forceinline__ ExpertRows expert_rows(const int* counts, int e,
                                                  int C) {
  if (SRC != kRagged) return {(long long)e * C, C, (long long)e * C};
  long long base = 0, ws = 0;
  for (int i = 0; i < e; ++i) {
    const int c = counts[i];
    base += c;
    ws += (long long)(c + kSegRows - 1) / kSegRows * kSegRows;
  }
  return {base, counts[e], ws};
}

// K2R's dW pass splits each expert's workspace segment into chunks of
// kChunkRows rows (whole segment tiles), one CTA per (dW tile, chunk,
// layer), so an expert with most of the rows no longer sets the pass's
// time alone. Chunk c of a launch is the c-th chunk in expert order;
// sum_e ceil(c_e / kChunkRows) <= ceil(N / kChunkRows) + E, a bound that
// needs no counts, sizes the grid and the partial-sum workspaces. At
// N = 32,768: <= 20 chunks at E4, <= 24 at E8 (at M = 256, 7 layers and
// 16-24 chunks: 224-336 CTAs over 132 SMs with bf16's 2 dW tiles a layer,
// 476 with the fp32 pass's 4).
constexpr int kChunkRows = 2048;
static_assert(kChunkRows % kSegRows == 0, "chunks hold whole tiles");

__host__ __device__ inline int ragged_chunks(long long N, int E) {
  return (int)((N + kChunkRows - 1) / kChunkRows) + E;
}

// The padded layout's (in place, gathered) chunks: ceil(C / kChunkRows) an
// expert, E of them a layer, from the capacity alone.
__host__ __device__ inline int padded_chunks(int C) {
  return (C + kChunkRows - 1) / kChunkRows;
}

// A fp32 backward launch's workspace rows a layer and dW chunks (rows: N
// with kRagged, else the capacity C): what the wrappers allocate.
template <int SRC>
__host__ __device__ inline long long bwd_ws_rows(int rows, int E) {
  return SRC == kRagged ? ragged_ws_rows(rows, E)
                        : E * padded_seg_rows(rows);
}

template <int SRC>
__host__ __device__ inline int bwd_chunks(int rows, int E) {
  return SRC == kRagged ? ragged_chunks(rows, E) : E * padded_chunks(rows);
}

// Chunk c: its expert (-1 past the last chunk), its first row in the
// expert's workspace segment's layer (ws) and its row count (<= kChunkRows).
struct ChunkRows {
  int e;
  long long ws;
  int count;
};

__device__ __forceinline__ ChunkRows chunk_rows(const int* counts, int E,
                                                int c) {
  long long ws = 0;
  for (int e = 0; e < E; ++e) {
    const int n = counts[e];
    const int k = (n + kChunkRows - 1) / kChunkRows;
    if (c < k) {
      const int r0 = c * kChunkRows;
      return {e, ws + r0, n - r0 < kChunkRows ? n - r0 : kChunkRows};
    }
    c -= k;
    ws += (long long)(n + kSegRows - 1) / kSegRows * kSegRows;
  }
  return {-1, 0, 0};
}

// The same for any row source: kRagged's above, the padded layout's from C
// (chunk c is chunk c % padded_chunks(C) of expert c / padded_chunks(C)).
template <int SRC>
__device__ __forceinline__ ChunkRows chunk_rows(const int* counts, int E,
                                                int C, int c) {
  if constexpr (SRC == kRagged) {
    return chunk_rows(counts, E, c);
  } else {
    const int k = padded_chunks(C);
    const int e = c / k, r0 = c % k * kChunkRows;
    return {e, e * padded_seg_rows(C) + r0,
            C - r0 < kChunkRows ? C - r0 : kChunkRows};
  }
}

// The partial sums of K2R's (and fp32 K2/K4's) dW pass: dwp
// [L, chunks, M, M] and dbp [L, chunks, M] fp32, chunk c's sums of its
// expert's rows. Summed here per expert in ascending chunk order into dw
// [L, E, M, M] and db [L, E, 1, M] (exact zeros for an expert with no
// rows): no atomics, the same bits on every run. One thread per 4
// consecutive dW entries of one (layer, expert); the CTAs of
// blockIdx.x == 0 also sum db. Reads the partials once (<= 44 MB at E8
// M256 L7), ~15-30 us. An expert's chunks: kRagged's from the counts, the
// padded layout's from C.
template <int SRC>
__global__ void reduce_partials(const float* __restrict__ dwp,
                                const float* __restrict__ dbp,
                                const int* __restrict__ counts,
                                float* __restrict__ dw, float* __restrict__ db,
                                int E, int M, int chunks, int C) {
  const int e = blockIdx.y, l = blockIdx.z;
  int first = 0, n;
  if constexpr (SRC == kRagged) {
    for (int i = 0; i < e; ++i)
      first += (counts[i] + kChunkRows - 1) / kChunkRows;
    n = (counts[e] + kChunkRows - 1) / kChunkRows;
  } else {
    n = padded_chunks(C);
    first = e * n;
  }
  const long long mm = (long long)M * M;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v * 4 < mm) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = first; c < first + n; ++c) {
      const float4 p = reinterpret_cast<const float4*>(
          dwp + ((long long)l * chunks + c) * mm)[v];
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    reinterpret_cast<float4*>(dw + ((long long)l * E + e) * mm)[v] = s;
  }
  if (blockIdx.x == 0) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) {
      float s = 0.0f;
      for (int c = first; c < first + n; ++c)
        s += dbp[((long long)l * chunks + c) * M + j];
      db[((long long)l * E + e) * M + j] = s;
    }
  }
}

template <int SRC = kRagged>
inline int launch_reduce_partials(const float* dwp, const float* dbp,
                                  const int* counts, float* dw, float* db,
                                  int E, int M, int L, int chunks,
                                  cudaStream_t stream, int C = 0) {
  constexpr int kThreads = 256;
  const dim3 grid((unsigned)(((long long)M * M / 4 + kThreads - 1) / kThreads),
                  E, L);
  reduce_partials<SRC><<<grid, kThreads, 0, stream>>>(dwp, dbp, counts, dw,
                                                      db, E, M, chunks, C);
  return (int)cudaGetLastError();
}
