// Kernel K3: dispatch gather + per-expert MLP chain, forward.
// Replaces switch_nerf_tpu/ops/fused_dispatch.py:_fwd_call (Pallas
// _fwd_kernel / _gather_block / _chain_fwd_from). Each CTA loads its own
// slot->token indices and reads the token rows straight from device memory;
// the [E, C, M] dispatch buffer never exists. bf16 runs K1's wgmma + TMA
// mainloop (chain_sm90.cuh) behind a cp.async row gather; fp32 K1's 3xTF32
// design (chain_tf32.cuh) with the same gather. Plain C interface, loaded
// with ctypes (switch_nerf_torch/ops/fused_dispatch.py).
#include "chain_sm90.cuh"
#include "chain_tf32.cuh"

// wsplit: fp32 only, a workspace of 2 * L*E*M*M floats (the split weights).
extern "C" int fused_dispatch_fwd(int device, const void* tokens,
                                  const int* stt, int n_tokens,
                                  const void* ws, const void* bs,
                                  void* wsplit, void* out, int E, int C,
                                  int M, int L, unsigned skip_mask,
                                  int is_bf16, void* stream) {
  if (is_bf16)
    return sm90::launch_chain_fwd<kGather>(device, tokens, stt, n_tokens, ws,
                                           bs, out, E, C, M, L, skip_mask,
                                           stream);
  return tf32::launch_chain_fwd<kGather>(device, tokens, stt, n_tokens, ws,
                                         bs, wsplit, out, E, C, M, L,
                                         skip_mask, stream);
}

extern "C" const char* fused_dispatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
