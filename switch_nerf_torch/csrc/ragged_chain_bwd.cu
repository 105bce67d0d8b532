// Kernel K2R: the per-expert MLP chain over expert-sorted rows, backward:
// dx [N, M] and fp32 dW [L, E, M, M], db [L, E, 1, M], each expert's summed
// over its own rows only. Replaces the autograd of the JAX package's
// ExpertMLP.ragged (switch_nerf_tpu/models/experts.py:79, jax.lax.ragged_dot
// per layer). K2's two deterministic passes (no atomics) with the kRagged
// row source (rows.cuh): pass 1 recomputes and sweeps each 128-row tile of
// an expert into whole-tile workspace segments, pass 2 forms
// dW_e = H_e^T G_e and db_e over the expert's segment; an expert with no
// rows gets exact zeros. Bound by the dx and dW products (4*N*M^2*L
// operations). bf16 on chain_bwd_sm90.cuh, fp32 on chain_bwd.cuh. Plain C
// interface, loaded with ctypes (switch_nerf_torch/ops/ragged_chain.py).
#include "chain_bwd.cuh"
#include "chain_bwd_sm90.cuh"

// hsave and gsave are [L, ragged_ws_rows(N, E), M] workspaces in x's dtype.
extern "C" int ragged_chain_bwd(int device, const void* x, const int* counts,
                                const void* ws, const void* bs, const void* g,
                                void* dx, void* hsave, void* gsave, float* dw,
                                float* db, int E, int N, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_bwd<kRagged>(device, x, counts, N, ws, bs, g,
                                           dx, hsave, gsave, dw, db, E, N, M,
                                           L, skip_mask, stream);
  return launch_chain_bwd<kRagged>(device, x, counts, N, ws, bs, g, dx,
                                   hsave, gsave, dw, db, E, N, M, L,
                                   skip_mask, stream);
}

// Rows per workspace layer (rows.cuh), so the caller allocates what the
// kernel addresses.
extern "C" long long ragged_chain_ws_rows(int N, int E) {
  return ragged_ws_rows(N, E);
}

// The most layers the kernel takes at width M (as K2's).
extern "C" int ragged_chain_bwd_max_layers(int device, int M, int is_bf16) {
  return is_bf16 ? sm90::bwd_max_layers(device, M) : 32;
}

extern "C" const char* ragged_chain_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
