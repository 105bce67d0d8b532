// Kernel K2: the per-expert MLP chain over the padded dispatch buffer,
// backward. Replaces switch_nerf_tpu/ops/expert_kernel.py:_bwd_call (Pallas
// _bwd_kernel). Two passes, recompute + reverse sweep, then dW/db: bf16 on
// the warp-specialised wgmma + TMA design of chain_bwd_sm90.cuh, fp32 on the
// CUDA-core path of chain_bwd.cuh. Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/expert_kernel.py).
#include "chain_bwd.cuh"
#include "chain_bwd_sm90.cuh"

extern "C" int expert_chain_bwd(int device, const void* x, const void* ws,
                                const void* bs, const void* g, void* dx,
                                void* hsave, void* gsave, float* dw,
                                float* db, int E, int C, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_bwd<kInPlace>(device, x, nullptr, 0, ws, bs, g,
                                            dx, hsave, gsave, dw, db, nullptr,
                                            nullptr, E, C, M, L, skip_mask,
                                            stream);
  return launch_chain_bwd<kInPlace>(device, x, nullptr, 0, ws, bs, g, dx,
                                    hsave, gsave, dw, db, E, C, M, L,
                                    skip_mask, stream);
}

// The most layers the kernel takes at width M (fp32: 32, the wrapper's
// limit; bf16: what pass 1's shared memory holds on this device).
extern "C" int expert_chain_bwd_max_layers(int device, int M, int is_bf16) {
  return is_bf16 ? sm90::bwd_max_layers(device, M) : 32;
}

extern "C" const char* expert_chain_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
