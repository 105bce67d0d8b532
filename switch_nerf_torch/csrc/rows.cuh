// Where the rows of a chain launch come from, shared by the fp32 (chain.cuh,
// chain_bwd.cuh) and bf16 (chain_sm90.cuh, chain_bwd_sm90.cuh) templates.
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
// rows e*C .. of a layer of E*C rows. Ragged, segment e starts at
// sum(ceil(counts[:e] / kSegRows) * kSegRows), so every 128-row tile of an
// expert has whole rows of its own in the workspace, and a layer holds
// ragged_ws_rows(N, E) rows, a bound that needs no counts.
#pragma once

#include <cuda_runtime.h>

enum RowSource : int { kInPlace = 0, kGather = 1, kRagged = 2 };

constexpr int kSegRows = 128;  // ragged workspace segments: whole bf16 tiles

// Rows per workspace layer of a ragged launch: sum_e ceil(c_e / 128) <=
// ceil(N / 128) + E tiles, whatever the counts.
__host__ __device__ inline long long ragged_ws_rows(long long N, int E) {
  return ((N + kSegRows - 1) / kSegRows + E) * kSegRows;
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
