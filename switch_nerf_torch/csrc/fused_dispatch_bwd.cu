// Kernel K4: dispatch gather + per-expert MLP chain, backward. Replaces
// switch_nerf_tpu/ops/fused_dispatch.py:_bwd_call (Pallas _bwd_kernel):
// each CTA gathers its token rows again through the slot->token map, then
// K2's two passes give d(dispatched) [E, C, M] and fp32 dW/db: bf16 on the
// wgmma + TMA design of chain_bwd_sm90.cuh behind a cp.async row gather,
// fp32 on K2's split-precision design (chain_tf32.cuh with kGather: the
// rows gathered by cp.async, the recompute on the CUDA cores, the sweep
// and dW in 3xTF32). Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/fused_dispatch.py).
#include "chain_bwd_sm90.cuh"
#include "chain_tf32.cuh"

// tokens [n_tokens, M], stt [E * C] int32 into them; g, dxd [E, C, M];
// the workspaces as expert_chain_bwd's.
extern "C" int fused_dispatch_bwd(int device, const void* tokens,
                                  const int* stt, int n_tokens,
                                  const void* ws, const void* bs,
                                  const void* g, void* dxd, void* hsave,
                                  void* gsave, void* wsplit, float* dwp,
                                  float* dbp, float* dw, float* db, int E,
                                  int C, int M, int L, unsigned skip_mask,
                                  int is_bf16, void* stream) {
  if (is_bf16)
    return sm90::launch_chain_bwd<kGather>(device, tokens, stt, n_tokens, ws,
                                           bs, g, dxd, hsave, gsave, dw, db,
                                           nullptr, nullptr, E, C, M, L,
                                           skip_mask, stream);
  return tf32::launch_chain_bwd<kGather>(device, tokens, stt, n_tokens, ws,
                                         bs, g, dxd, hsave, gsave, wsplit, dw,
                                         db, dwp, dbp, E, C, M, L, skip_mask,
                                         stream);
}

// fp32 workspace rows a layer and dW row chunks at capacity C (rows.cuh).
extern "C" long long fused_dispatch_bwd_ws_rows(int E, int C) {
  return bwd_ws_rows<kGather>(C, E);
}

extern "C" int fused_dispatch_bwd_chunks(int E, int C) {
  return bwd_chunks<kGather>(C, E);
}

// The most layers the kernel takes at width M (fp32: 32, as K2; bf16: what
// pass 1's shared memory holds on this device, as K2).
extern "C" int fused_dispatch_bwd_max_layers(int device, int M, int is_bf16) {
  return is_bf16 ? sm90::bwd_max_layers(device, M) : 32;
}

extern "C" const char* fused_dispatch_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
