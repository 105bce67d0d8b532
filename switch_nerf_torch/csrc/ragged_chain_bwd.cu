// Kernel K2R: the per-expert MLP chain over expert-sorted rows, backward:
// dx [N, M] and fp32 dW [L, E, M, M], db [L, E, 1, M], each expert's summed
// over its own rows only. Replaces the autograd of the JAX package's
// ExpertMLP.ragged (switch_nerf_tpu/models/experts.py:79, jax.lax.ragged_dot
// per layer). Bound by the dx and dW products (4*N*M^2*L operations). Three
// deterministic steps, no atomics: pass 1 recomputes and sweeps each tile
// of an expert into whole-tile workspace segments (rows.cuh); pass 2 splits
// every expert's segment into chunks of kChunkRows rows, one CTA per (dW
// tile, chunk, layer), so skewed routing cannot leave one expert's CTAs
// with most of the work; reduce_partials sums each expert's chunk partials
// in ascending order (exact zeros for an expert with no rows). bf16 on the
// wgmma + TMA design of chain_bwd_sm90.cuh; fp32 in 3xTF32 on the tensor
// cores (chain_tf32.cuh: 3 * 4*N*M^2*L TF32 operations, 0.365 ms at E4
// M256 L7 N = 32,768 against 0.898 ms on the CUDA cores), but for pass
// 1's recompute, which runs on the CUDA cores in the plain chain's order
// so that the ReLU masks are the plain version's. Plain C interface,
// loaded with ctypes (switch_nerf_torch/ops/ragged_chain.py).
#include "chain_bwd_sm90.cuh"
#include "chain_tf32.cuh"

// hsave [L, ragged_ws_rows(N, E), M] in x's dtype; gsave the same in bf16,
// fp32 [2, L, M, ragged_ws_rows(N, E)] (G_l^T split); wsplit fp32 only,
// 2 * L*E*M*M floats; dwp [L, chunks, M, M] and dbp [L, chunks, M] fp32
// with chunks = ragged_chain_chunks(N, E).
extern "C" int ragged_chain_bwd(int device, const void* x, const int* counts,
                                const void* ws, const void* bs, const void* g,
                                void* dx, void* hsave, void* gsave,
                                void* wsplit, float* dwp, float* dbp,
                                float* dw, float* db, int E, int N, int M,
                                int L, unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_bwd<kRagged>(device, x, counts, N, ws, bs, g,
                                           dx, hsave, gsave, dw, db, dwp, dbp,
                                           E, N, M, L, skip_mask, stream);
  return tf32::launch_chain_bwd<kRagged>(device, x, counts, N, ws, bs, g, dx,
                                         hsave, gsave, wsplit, dw, db, dwp,
                                         dbp, E, N, M, L, skip_mask, stream);
}

// Rows per workspace layer (rows.cuh), so the caller allocates what the
// kernel addresses.
extern "C" long long ragged_chain_ws_rows(int N, int E) {
  return ragged_ws_rows(N, E);
}

// Row chunks of the dW pass (rows.cuh): the partial sums' second dimension.
extern "C" int ragged_chain_chunks(int N, int E) { return ragged_chunks(N, E); }

// The most layers the kernel takes at width M: bf16 as K2's (ReLU-mask bits
// in shared memory), fp32 as chain_tf32.cuh's pass 1.
extern "C" int ragged_chain_bwd_max_layers(int device, int M, int is_bf16) {
  return is_bf16 ? sm90::bwd_max_layers(device, M)
                 : tf32::bwd_max_layers(device, M);
}

extern "C" const char* ragged_chain_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
