// Kernel K1R: the per-expert MLP chain over expert-sorted rows (no-drop
// dispatch), forward. Replaces the ragged form of the JAX package's expert
// chain, switch_nerf_tpu/models/experts.py:79 ExpertMLP.ragged (one
// jax.lax.ragged_dot per layer, an XLA op with no Pallas counterpart).
// x [N, M] holds expert e's rows at off[e] = sum(counts[:e]) ..; counts [E]
// stays on the device, and the grid is sized from N, so a launch needs no
// host sync. Bound by operations (2*N*M^2*L against x, W and out): bf16 on
// K1's wgmma + TMA design with the kRagged row source (chain_sm90.cuh,
// rows.cuh); fp32 on the tensor cores in split precision, 3xTF32
// (chain_tf32.cuh: 3 * 2*N*M^2*L TF32 operations, 0.182 ms at E4 M256 L7
// N = 32,768 against 0.449 ms on the CUDA cores). Plain C interface, loaded
// with ctypes (switch_nerf_torch/ops/ragged_chain.py).
#include "chain_sm90.cuh"
#include "chain_tf32.cuh"

// wsplit: fp32 only, a workspace of 2 * L*E*M*M floats (the split weights).
extern "C" int ragged_chain_fwd(int device, const void* x, const int* counts,
                                const void* ws, const void* bs, void* wsplit,
                                void* out, int E, int N, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_fwd<kRagged>(device, x, counts, N, ws, bs, out,
                                           E, N, M, L, skip_mask, stream);
  return tf32::launch_chain_fwd<kRagged>(device, x, counts, 0, ws, bs, wsplit,
                                         out, E, N, M, L, skip_mask, stream);
}

extern "C" const char* ragged_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
