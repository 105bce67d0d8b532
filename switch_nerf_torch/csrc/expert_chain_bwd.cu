// Kernel K2: the per-expert MLP chain over the padded dispatch buffer,
// backward. Replaces switch_nerf_tpu/ops/expert_kernel.py:_bwd_call (Pallas
// _bwd_kernel). Two passes (chain_bwd.cuh): recompute + reverse sweep, then
// dW/db. Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/expert_kernel.py).
#include "chain_bwd.cuh"

extern "C" int expert_chain_bwd(int device, const void* x, const void* ws,
                                const void* bs, const void* g, void* dx,
                                void* hsave, void* gsave, float* dw,
                                float* db, int E, int C, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  return launch_chain_bwd<false>(device, x, nullptr, 0, ws, bs, g, dx, hsave,
                                 gsave, dw, db, E, C, M, L, skip_mask,
                                 is_bf16, stream);
}

extern "C" const char* expert_chain_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
