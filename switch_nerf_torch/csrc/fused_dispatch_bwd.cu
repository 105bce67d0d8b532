// Kernel K4: dispatch gather + per-expert MLP chain, backward. Replaces
// switch_nerf_tpu/ops/fused_dispatch.py:_bwd_call (Pallas _bwd_kernel):
// each CTA gathers its token rows again through the slot->token map, then
// K2's two passes (chain_bwd.cuh) give d(dispatched) [E, C, M] and fp32
// dW/db. Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/fused_dispatch.py).
#include "chain_bwd.cuh"

extern "C" int fused_dispatch_bwd(int device, const void* tokens,
                                  const int* stt, int n_tokens,
                                  const void* ws, const void* bs,
                                  const void* g, void* dxd, void* hsave,
                                  void* gsave, float* dw, float* db, int E,
                                  int C, int M, int L, unsigned skip_mask,
                                  int is_bf16, void* stream) {
  return launch_chain_bwd<true>(device, tokens, stt, n_tokens, ws, bs, g, dxd,
                                hsave, gsave, dw, db, E, C, M, L, skip_mask,
                                is_bf16, stream);
}

extern "C" const char* fused_dispatch_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
