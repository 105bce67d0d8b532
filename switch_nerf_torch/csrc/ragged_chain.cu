// Kernel K1R: the per-expert MLP chain over expert-sorted rows (no-drop
// dispatch), forward. Replaces the ragged form of the JAX package's expert
// chain, switch_nerf_tpu/models/experts.py:79 ExpertMLP.ragged (one
// jax.lax.ragged_dot per layer, an XLA op with no Pallas counterpart).
// x [N, M] holds expert e's rows at off[e] = sum(counts[:e]) ..; counts [E]
// stays on the device, and the grid is sized from N, so a launch needs no
// host sync. What bounds it is K1's (2*N*M^2*L operations against x, W and
// out, far above the card's ridge in bf16): K1's mainloops with the kRagged
// row source (rows.cuh), bf16 on the wgmma + TMA design of chain_sm90.cuh,
// fp32 on the CUDA-core path of chain.cuh. Plain C interface, loaded with
// ctypes (switch_nerf_torch/ops/ragged_chain.py).
#include "chain.cuh"
#include "chain_sm90.cuh"

extern "C" int ragged_chain_fwd(int device, const void* x, const int* counts,
                                const void* ws, const void* bs, void* out,
                                int E, int N, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_fwd<kRagged>(device, x, counts, N, ws, bs, out,
                                           E, N, M, L, skip_mask, stream);
  return launch_chain<kRagged>(device, x, counts, N, ws, bs, out, E, N, M, L,
                               skip_mask, stream);
}

extern "C" const char* ragged_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
