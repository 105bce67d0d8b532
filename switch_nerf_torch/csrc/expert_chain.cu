// Kernel K1: the per-expert MLP chain over the padded dispatch buffer.
// Replaces switch_nerf_tpu/ops/expert_kernel.py:_fwd_call (Pallas
// _fwd_kernel). bf16 runs the warp-specialised wgmma + TMA design of
// chain_sm90.cuh; fp32 the 3xTF32 design of chain_tf32.cuh (K1R's, with
// the rows read in place). Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/expert_kernel.py).
#include "chain_sm90.cuh"
#include "chain_tf32.cuh"

// wsplit: fp32 only, a workspace of 2 * L*E*M*M floats (the split weights).
extern "C" int expert_chain_fwd(int device, const void* x, const void* ws,
                                const void* bs, void* wsplit, void* out,
                                int E, int C, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_fwd<kInPlace>(device, x, nullptr, 0, ws, bs,
                                            out, E, C, M, L, skip_mask,
                                            stream);
  return tf32::launch_chain_fwd<kInPlace>(device, x, nullptr, 0, ws, bs,
                                          wsplit, out, E, C, M, L, skip_mask,
                                          stream);
}

extern "C" const char* expert_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
