// Kernel K3: dispatch gather + per-expert MLP chain, forward.
// Replaces switch_nerf_tpu/ops/fused_dispatch.py:_fwd_call (Pallas
// _fwd_kernel / _gather_block / _chain_fwd_from). Each CTA loads its own
// slot->token indices and reads the token rows straight from device memory;
// the [E, C, M] dispatch buffer never exists. bf16 runs K1's wgmma + TMA
// mainloop (chain_sm90.cuh) behind a cp.async row gather; fp32 the
// CUDA-core path of chain.cuh. Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/fused_dispatch.py).
#include "chain.cuh"
#include "chain_sm90.cuh"

extern "C" int fused_dispatch_fwd(int device, const void* tokens,
                                  const int* stt, int n_tokens,
                                  const void* ws, const void* bs, void* out,
                                  int E, int C, int M, int L,
                                  unsigned skip_mask, int is_bf16,
                                  void* stream) {
  if (is_bf16)
    return sm90::launch_chain_fwd<kGather>(device, tokens, stt, n_tokens, ws,
                                           bs, out, E, C, M, L, skip_mask,
                                           stream);
  return launch_chain<kGather>(device, tokens, stt, n_tokens, ws, bs, out, E,
                               C, M, L, skip_mask, stream);
}

extern "C" const char* fused_dispatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
