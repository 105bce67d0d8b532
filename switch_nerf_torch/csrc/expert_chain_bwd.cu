// Kernel K2: the per-expert MLP chain over the padded dispatch buffer,
// backward. Replaces switch_nerf_tpu/ops/expert_kernel.py:_bwd_call (Pallas
// _bwd_kernel). Two passes, recompute + reverse sweep, then dW/db: bf16 on
// the warp-specialised wgmma + TMA design of chain_bwd_sm90.cuh; fp32 on
// K2R's split-precision design (chain_tf32.cuh with kInPlace: the recompute
// on the CUDA cores in the plain chain's order, the sweep and dW in 3xTF32
// on the tensor cores, dW over 2,048-row chunks reduced in ascending
// order). Plain C interface, loaded with ctypes
// (switch_nerf_torch/ops/expert_kernel.py).
#include "chain_bwd_sm90.cuh"
#include "chain_tf32.cuh"

// x, g, dx [E, C, M]; dw [L, E, M, M], db [L, E, 1, M] fp32. bf16: hsave
// and gsave [L, E, C, M] bf16 (wsplit, dwp, dbp unused). fp32: hsave
// [L, ws_rows, M], gsave [2, L, M, ws_rows], wsplit 2 * L*E*M*M floats,
// dwp [L, chunks, M, M], dbp [L, chunks, M], with ws_rows and chunks from
// expert_chain_bwd_ws_rows / _chunks.
extern "C" int expert_chain_bwd(int device, const void* x, const void* ws,
                                const void* bs, const void* g, void* dx,
                                void* hsave, void* gsave, void* wsplit,
                                float* dwp, float* dbp, float* dw, float* db,
                                int E, int C, int M, int L,
                                unsigned skip_mask, int is_bf16,
                                void* stream) {
  if (is_bf16)
    return sm90::launch_chain_bwd<kInPlace>(device, x, nullptr, 0, ws, bs, g,
                                            dx, hsave, gsave, dw, db, nullptr,
                                            nullptr, E, C, M, L, skip_mask,
                                            stream);
  return tf32::launch_chain_bwd<kInPlace>(device, x, nullptr, 0, ws, bs, g,
                                          dx, hsave, gsave, wsplit, dw, db,
                                          dwp, dbp, E, C, M, L, skip_mask,
                                          stream);
}

// fp32 pass 1 stopped after its recompute (the same arguments; nothing
// reads its outputs): the recompute's time alone, for chip_smoke.py.
extern "C" int expert_chain_bwd_recompute(int device, const void* x,
                                          const void* ws, const void* bs,
                                          const void* g, void* dx,
                                          void* hsave, void* gsave,
                                          void* wsplit, float* dwp,
                                          float* dbp, float* dw, float* db,
                                          int E, int C, int M, int L,
                                          unsigned skip_mask, void* stream) {
  return tf32::launch_chain_bwd<kInPlace, false>(
      device, x, nullptr, 0, ws, bs, g, dx, hsave, gsave, wsplit, dw, db,
      dwp, dbp, E, C, M, L, skip_mask, stream);
}

// fp32 workspace rows a layer and dW row chunks at capacity C (rows.cuh).
extern "C" long long expert_chain_bwd_ws_rows(int E, int C) {
  return bwd_ws_rows<kInPlace>(C, E);
}

extern "C" int expert_chain_bwd_chunks(int E, int C) {
  return bwd_chunks<kInPlace>(C, E);
}

// The most layers the kernel takes at width M (fp32: 32, the wrapper's
// limit, its masks read back from hsave; bf16: what pass 1's shared memory
// holds on this device).
extern "C" int expert_chain_bwd_max_layers(int device, int M, int is_bf16) {
  return is_bf16 ? sm90::bwd_max_layers(device, M) : 32;
}

extern "C" const char* expert_chain_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
