#!/usr/bin/env python3
"""Drive the PyTorch port (switch_nerf_torch) on one CUDA card and check it.

    python3 chip_smoke.py                # one card: every phase below
    python3 chip_smoke.py --dp-cards 4   # Building data-parallel on 4 cards
                                         # of the host against one card
    python3 chip_smoke.py --points-unsplit   # one eval_points request in
                                         # one model call: its peak memory
                                         # or the card's out-of-memory error

Phases, each fatal (an exception ends the run with a non-zero exit):
  0. the card: `nvidia-smi` name and power limit, torch and CUDA versions
  1. build the Hopper kernels K1-K4, K1R and K2R from
     switch_nerf_torch/csrc (one nvcc per source, all started together),
     and report each library's HGMMA (wgmma) instructions (cuobjdump,
     where the toolkit has it; none is a failure, nor none on TF32 in the
     ragged libraries) and ptxas's spill bytes (a spill in a 3xTF32
     kernel is a failure)
  2. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with CUDA-event timings beside its bound,
     achieved TFLOP/s and share of the bound, and one library call's time
     (K1/K3 forward, K2/K4 backward); K2 and K4 twice on the same inputs
     (bit-identical), K2's two passes timed by torch.profiler, and the
     K3 / K1 and K4 / K2 time ratios (what the row gather costs on the
     same mainloop); then K1R and K2R, the ragged chain of no-drop
     dispatch, against their plain versions at one 32,768-point chunk,
     fp32 at Bungee's shape (E4) and bf16 at Building's (E8), over skewed
     counts (an empty expert, a count off the row blocks, one expert with
     most rows) and balanced ones: times beside the bound (fp32: the
     3xTF32 design's and the CUDA cores'), the plain version and a
     per-expert addmm chain (and its autograd), each step's device time
     by kernel name (prep, pass 1, pass 2, reduction); K2R twice on the
     same inputs (bit-identical) and the empty expert's dW and db exactly
     0; the fp32 kernels' error against a float64 run of the plain chain
     at most 4x the plain fp32 chain's
  2a. the chain kernels at Mission Bay's width, M = 512 bf16 (E8 L7
     skips (3,), one 32,768-point chunk): K1 and K2 (C = 4,096; K2 twice,
     bit-identical) and K1R (skewed and balanced counts) against their
     plain versions, timed beside the bound, the plain version and the
     library call; K3, K4 and K2R at the same width checked and timed the
     same way
  2c. K1R's 64-bit row offsets: one launch over one published
     eval_points request's rows, N = 65,536 x 256 = 16,777,216 (M256 bf16
     E8 L7, balanced counts; 4.3e9 elements an activation), against its
     plain version on every row (the last 4,096 apart); and K1 at the
     padded eval_points request's capacity (8,192 rays x 256: C =
     262,144); each timed beside its bound, the plain version and the
     library call
  2b. no-drop = padded: an MoE layer (M256 L7) in no-drop dispatch (K1R /
     K2R) and in padded dispatch (K1 / K2) with the same weights at
     capacity factor E, where padding drops nothing: outputs and every
     gradient agree (fp32 E4 within 1e-5, bf16 E8 within the bf16 rule)
  3. eval: the Building eval render at full published width (8 experts x
     7 x 256, bg NeRF, 256 + 512 samples, bf16, padded eval dispatch,
     32768-point chunks) through make_eval_step: a warm-up and three
     4096-ray requests, the same request without --moe_test_batch (no-drop
     eval dispatch, K1R once per chunk; its rays/s beside the padded
     figure), a CPU fp32 cross-check on 256 rays, and one request with
     SWITCH_NERF_FUSED_DISPATCH=1
  4. train: the published Building training step at the same width
     (padded train dispatch, sigma noise, perturb 1.0, l_aux weight 5e-4,
     Adam) through make_train_step on one fixed 1024-ray batch: a warm-up
     and 20 timed steps with K1 and K2 launched 24 times per step, a CPU
     fp32 cross-check of one step's loss and gradients on 64 rays, and one
     step with SWITCH_NERF_FUSED_DISPATCH=1 (K3/K4)
  5. runner: serve a trained scene end to end. A synthetic Mega-NeRF scene
     (6 train + 2 val 1024x768 JPEGs from a seed) in a temp directory; a
     port train state from seeds after one train step, written with
     checkpoints.save_checkpoint and loaded into fresh models (every
     parameter and Adam moment bit-equal, fingerprint equal); then
     Runner(h).eval_image() with the eval phase's flags: each 256x192 val
     image (--val_scale_factor 4) in one 65,536-ray request, K1 launched
     for every image, finite metrics, the reference file set, and the
     first 4,096 rays of val image 0 equal to a direct make_eval_step call
  6. train runner: train a scene end to end. The same synthetic scene in a
     temp directory; train.main with the published Building train flags
     (the train phase's) on the chunked filesystem dataset: 256x192 train
     images (--train_scale_factor 4) written into 10 chunks, 40 steps of
     1,024 rays (across a chunk boundary), a checkpoint every 20 steps, a
     log line every 10, no validation. K1 and K2 launched 24 times per
     step, every logged metric finite, step directories 20 and 40, and the
     cursor, counters and generator state in step 20's extra.json; then a
     second run resumed from step 20 to 40 feeds the same batches (equal
     hashes) and its first loss equals the first run's to 1e-3. Prints the
     chunk write and load seconds, train rays/s through Runner.train beside
     the train phase's fixed-batch figure, the mean data_sample_time, the
     checkpoint save seconds and max_memory_allocated
  7. Bungee: the mip workload end to end through its entry points with the
     README's flags (bungee.yaml, 4 experts x 7 x 256, 65 + 65 samples,
     batch 4096, fp32, no --moe_*_batch: no-drop dispatch). A synthetic
     scene of 17 288x216 PNGs (scale factor 3: 96x72; images 0 and 16 held
     out) in a temp directory; train_nerf_moe for one epoch (25 steps), a
     checkpoint at step 20 and at the end, a log line every 5 steps: K1R
     and K2R launched on every chunk of every step, every logged metric
     finite, photo_loss falling, and the largest expert's share of each
     chunk's rows (min, median, max); then eval_nerf_moe on the final
     checkpoint (8,192-ray requests): K1R on every chunk, finite metrics,
     the summary file. Prints train rays/s, step seconds,
     max_memory_allocated, eval seconds per image and K1R/K2R launches per
     step
  8. Mission Bay: the Block-NeRF workload end to end through its entry
     points with the README's flags (mission_bay.yaml, 8 experts x 7 x 512,
     appearance_dim 48, 513 + 513 samples, 1,664 rays a step, bf16, padded
     train dispatch). A synthetic scene of 8 96x64 images in 3 GZIP
     tfrecords written by the port's own writer (make_block_scene; the
     validation record's 2 images carry moving-object masks and train on
     their left halves) in a temp directory; train.main on the chunked
     Block-NeRF dataset (2 chunks) for 15 steps, a checkpoint at step 10
     and at the end: K1 and K2 launched on every model chunk of every step
     (52 each a step), no K1R/K2R, every logged metric finite, photo_loss
     falling; a resume from step 10 replays the batches (equal hashes) and
     its first loss equals the first run's to 1e-3; then
     eval_image_blocknerf on the final checkpoint (no --moe_test_batch:
     no-drop dispatch, K1R on every chunk; one 6,144-ray request an
     image): finite masked and unmasked metrics, the per-image files and
     records, the 'Average val/...' summary. Prints train rays/s, step
     seconds, max_memory_allocated, eval seconds per image
  9. data parallel: the port's training and serving in a process group
     (parallel/), 2 ranks on the one card over gloo (NCCL refuses two
     ranks on one card; gloo runs the all_reduce and broadcast the port
     uses on CUDA tensors), each a `chip_smoke.py --dp-worker` process:
     train.main on the runner phase's scene with the published Building
     flags at full width, a global batch of 2,048 rays (1,024 a rank, a
     card's share of the published 8,192 over 8), 10 steps with a save at
     5, the chunks written by both ranks: K1 and K2 on every chunk of
     every step on every rank, the ranks' parameter hashes equal at each
     save, every metric finite, the ranks' batches different; a resume
     from step 5 replays each rank's batches and its first loss equals the
     run's to 1e-3; the drop-free first step (capacity factor 8, l_aux 0,
     no noise, perturb 0) on a fixed 2,048-ray batch, each rank its half,
     against one process on the whole batch: all_loss within 1e-3
     relative, the averaged gradient's cosine >= 0.999; eval_image (no
     --moe_test_batch: K1R) on the final checkpoint in 2 ranks against one
     process: the same file set, PSNR and SSIM means within 1e-4; then one
     rank with torchrun's variables, whose group init_distributed starts
     over NCCL, trains 5 steps. The published routing (capacity factor
     1.0, BPR, l_aux 5e-4; no noise, perturb 0) with 98,304-point chunks,
     so chunks span the two ranks (parallel/chunks.py): each rank's half of
     a fixed 2,048-ray batch against one process on the whole batch: the
     same tokens dropped, gate_loss within 1e-5 relative, all_loss within
     1e-3 relative, the averaged gradient's cosine >= 0.999, the ranks'
     parameter hashes equal after two steps (each timed), the shared
     chunks counted; the same step with each rank's pieces routed alone
     must drop other tokens (so the drop check tells per-rank routing from
     global routing); and the published Building and
     Mission Bay runs' chunk arithmetic at 8 ranks (no chunk spans ranks).
     Prints seconds a step per rank, train rays/s through Runner.train,
     the gradient all-reduce's milliseconds and bytes
  10. serving what users already have, on the runner phase's synthetic
     scene: a reference-layout .pt (module. prefix, dense bg NeRF) of
     seeded Building weights converted by `python -m
     switch_nerf_torch.convert_torch_ckpt` (its leaves bit-equal to the
     .pt's, the process's seconds), Runner.eval_image on it (K1); then
     eval_points with the published flags (no --moe_test_batch: K1R,
     65,536-ray requests, --render_test_points_sample_skip 4, both val
     images): the PLY file set, the points of an image and their split
     over the experts, K1R's launches and rows a launch, each request's
     seconds and each image's with its PLY writes, max_memory_allocated;
     K1R against its plain version and timed at the first call's rows an
     expert with the model's weights; its gates on 256 rays against a CPU
     run (>= 99.5 % equal); eval_points --moe_test_batch (K1, 8,192-ray
     requests, one image); eval_ckpt (step and parameter count); a
     container written by convert_to_container_moe served with
     --container_path (the checkpoint's PSNR and SSIM within 1e-6)
  11. orbax: the committed fixture tests/data/orbax_ep_fixture (a tiny
     Building-graph train state, width 64, 2 experts, that JAX wrote on an
     expert-sharded (4, 2) CPU mesh; tests/make_orbax_fixture.py) read by
     checkpoints.load_checkpoint from its orbax directory and from its
     msgpack twin, each served on the card (one 3,072-ray eval request,
     K1 at the fixture's shape held against its plain version): the two
     states' leaves and rgb bit-equal, finite. Prints the read seconds
  12. expert parallelism at the published Building flags' full width:
     K1 and K2 at a rank's shapes (E_loc 4 and 2 of 8 experts, C = the
     expert axis x 4,096, bf16) against their plain versions (K2 twice,
     bit-identical), timed against bound, plain and library; then 2 ranks
     on the card over gloo with --expert_parallel --mesh_shape 1 2:
     train.main 10 steps with a save at 5 and a resume from it (K1, K2 on
     every chunk; the ranks' non-expert parameters hash-equal at each
     save), the drop-free first step against one process (all_loss 1e-3,
     the averaged gradient's cosine >= 0.999), and the token exchange:
     its form (all_reduce of zero-filled buffers for CUDA tensors under
     gloo) held equal to the other (all_to_all on CPU copies), its
     milliseconds and bytes. `chip_smoke.py --dp-cards 4` adds NCCL runs
     with --mesh_shape 1 4 and 2 2 beside the pure data-parallel one
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit; before that, the `kernels` JSON line.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np
import torch

N_RAYS = 4096          # rays per eval request
N_REQUESTS = 3
CHECK_RAYS = 256       # rays of the CPU fp32 eval cross-check
TRAIN_STEPS = 20       # timed train steps on the 1024-ray batch
TRAIN_CHECK_RAYS = 64  # rays of the CPU fp32 train cross-check
SCENE_W, SCENE_H = 1024, 768   # the runner scene's full-size images
SCENE_TRAIN, SCENE_VAL = 6, 2  # its images (8 appearance rows)
RUNNER_CHECK_RAYS = 4096       # rays of val image 0 checked against the step
RUN_STEPS, RUN_CKPT, RUN_PRINT = 40, 20, 10   # the train runner's schedule
RUN_CHUNKS = 10                # chunks of the train runner's scene
RAGGED_N = 32768               # rows of one model chunk (K1R / K2R)
MOE_TOKENS = 8192              # tokens of the no-drop = padded layer check
BUNGEE_W, BUNGEE_H = 288, 216  # the Bungee scene's full-size images
BUNGEE_IMAGES = 17             # llffhold 16 holds out images 0 and 16
BUNGEE_CKPT, BUNGEE_PRINT = 20, 5   # its run's checkpoint and log interval
BUNGEE_EVAL_BATCH = 8192       # rays per eval request (one per image)
BUNGEE_FLAGS = ["--config_file", "configs/switch_nerf/bungee.yaml",
                "--batch_size", "4096", "--moe_expert_num", "4", "--no_amp",
                "--use_moe_external_gate", "--use_gate_input_norm"]
MB_FLAGS = ["--config_file", "configs/switch_nerf/mission_bay.yaml",
            "--batch_size", "1664", "--moe_train_batch",
            "--use_moe_external_gate", "--use_gate_input_norm",
            "--batch_prioritized_routing", "--moe_capacity_factor", "1.0",
            "--moe_l_aux_wt", "0.0005"]   # the README's, 13,312 rays / 8
MB_W, MB_H = 96, 64            # the Mission Bay scene's images
MB_RECORDS = (("train_0000.tfrecord", 3), ("train_0001.tfrecord", 3),
              ("validation_0000.tfrecord", 2))   # (file, images)
MB_CHUNKS = 2                  # chunks of its 43,008 training rays
MB_STEPS, MB_CKPT, MB_PRINT = 15, 10, 5   # its run's schedule
BUILDING_EVAL_FLAGS = [   # profile_eval.building_eval_hparams' own
    "--config_file", "configs/switch_nerf/building.yaml", "--use_moe",
    "--use_moe_external_gate", "--use_gate_input_norm",
    "--batch_prioritized_routing", "--moe_capacity_factor", "1.0",
    "--moe_expert_num", "8", "--appearance_dim", "48", "--moe_test_batch",
    "--coarse_samples", "256", "--fine_samples", "512",
    "--model_chunk_size", "32768"]
POINTS_N = 65536 * 256         # rows of one published eval_points request
POINTS_PADDED_BATCH = 8192     # rays per request of the padded eval_points
REF_ITERATION = 1234           # the reference .pt's iteration
STRADDLE_CHUNK = 3 * 32768     # a model chunk that spans the 2 ranks
BF16_REL_TOL = 2e-2    # max |kernel - plain| <= this * max |plain| in bf16
FP32_TOL = 1e-4        # max |kernel - plain| in fp32

# Published dense peaks (NVIDIA H100 data sheet): tensor-core bf16 and
# TF32, fp32 on the CUDA cores, and device-memory bandwidth, per H100 form
# factor.
PEAKS = {
    "PCIe": {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "bytes": 2.0e12},
    "NVL": {"bf16": 835e12, "tf32": 417.5e12, "fp32": 60e12,
            "bytes": 3.9e12},
    "SXM": {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12,
            "bytes": 3.35e12},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> dict:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def cuda_ms(fn, iters: int = 50, warmup: int = 10,
            warm_s: float = 0.5) -> float:
    """Mean device time of fn() in ms, from CUDA events after a warm-up of
    at least `warmup` calls and `warm_s` seconds (an idle card, as after
    the build, runs its first kernels at lower clocks)."""
    t0 = time.perf_counter()
    n = 0
    while n < warmup or time.perf_counter() - t0 < warm_s:
        fn()
        n += 1
        if n % 10 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.bfloat16:
        tol = BF16_REL_TOL * ref.float().abs().max().item()
    else:
        tol = FP32_TOL
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {err} > {tol}")
    return err


def bmm_chain(x, ws, bs, skips):
    """The library yardstick: one torch.baddbmm per layer (cuBLAS)."""
    h = xin = x
    layers = ws.shape[0]
    for l in range(layers):
        h = torch.baddbmm(bs[l], h, ws[l])
        last = l == layers - 1
        if l in skips:
            h = h + xin
            if not last:
                h = torch.relu(h)
            xin = h
        elif not last:
            h = torch.relu(h)
    return h


def chain_weights(e, m, layers, dtype, gen):
    bound = m ** -0.5
    ws = (torch.rand(layers, e, m, m, generator=gen) * 2 - 1) * bound
    bs = (torch.rand(layers, e, 1, m, generator=gen) * 2 - 1) * bound
    return ws.to("cuda", dtype), bs.to("cuda", dtype)


def chain_bound(flops, nbytes, dtype, peaks):
    """(ms, what bounds it): the larger of flops over the peak of dtype's
    unit (bf16 and "tf32" the tensor cores, fp32 the CUDA cores) and
    nbytes over the memory rate."""
    key = {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(dtype, dtype)
    t_ops = flops / peaks[key]
    t_bytes = nbytes / peaks["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rate(flops: float, ms: float, bound_ms: float) -> str:
    """Achieved TFLOP/s and the share of the bound, for a kernel line."""
    return (f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of "
            f"the bound")


def device_ms_by_kernel(fn, keys: dict, iters: int = 10) -> dict:
    """Mean device ms per call of fn() in the kernels whose names contain
    each of keys' values (torch.profiler over `iters` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label in keys}
    for ev in prof.key_averages():
        for label, key in keys.items():
            if key in ev.key:
                out[label] += ev.self_device_time_total / 1e3 / iters
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def skewed_slot_map(s, e, m, dtype, gen):
    """A real slot map: skewed routing through the port's own routing code,
    so some experts overflow (dropped tokens) and others leave empty slots.
    Returns (tokens_ext [S + 1, M], stt [E*C] int32, drops, empty slots)."""
    from switch_nerf_torch.ops import dispatch, fused_dispatch
    from switch_nerf_torch.ops.routing import extract_critical
    tokens = torch.randn(s, m, generator=gen).to("cuda", dtype)
    logits = torch.randn(s, e, generator=gen)
    logits[:, 0] += 1.0
    plan, _ = extract_critical(torch.softmax(logits, 1).cuda(), 1, 1.0, True)
    dp = dispatch.build_dispatch_plan(plan, e)
    n_drop = int((~dp.kept).sum())
    n_empty = int((~dp.filled).sum())
    if not (n_drop and n_empty):
        raise AssertionError("slot map lacks drops or empty slots")
    tokens_ext = torch.cat([tokens, tokens.new_zeros((1, m))])
    stt = fused_dispatch.fused_slot_map(dp.slot_to_token[0], dp.filled[0], s)
    return tokens_ext, stt, n_drop, n_empty


def kernel_phase(peaks, building):
    """Each forward kernel vs its plain version at the main path's shapes."""
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch

    e = building["experts"]
    m, layers, skips = building["width"], building["layers"], building["skips"]
    s = building["chunk"]
    c = s // e                                  # capacity at factor 1.0
    gen = torch.Generator().manual_seed(0)
    rows = {}

    log(f"[kernels] K1 expert chain: E{e} C{c} M{m} L{layers} skips{skips}")
    for dtype, cc in ((torch.bfloat16, c), (torch.float32, c),
                      (torch.bfloat16, 1000)):
        ws, bs = chain_weights(e, m, layers, dtype, gen)
        x = torch.randn(e, cc, m, generator=gen).to("cuda", dtype)
        err = check_close(f"K1 {str(dtype)[6:]} C{cc}",
                          expert_kernel.expert_mlp_chain(x, ws, bs, skips),
                          expert_kernel.expert_mlp_chain_plain(x, ws, bs,
                                                               skips))
        if dtype == torch.bfloat16 and cc == c:
            flops = 2 * e * cc * m * m * layers
            bound_ms, bound_by = chain_bound(
                flops, nbytes(x, ws, bs) + nbytes(x), dtype, peaks)
            t = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain(
                     x, ws, bs, skips)),
                 "plain_ms": cuda_ms(lambda: expert_kernel
                                     .expert_mlp_chain_plain(x, ws, bs,
                                                             skips)),
                 "library_ms": cuda_ms(lambda: bmm_chain(x, ws, bs, skips))}
            log(f"  K1 bf16 C{cc}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, baddbmm chain {t['library_ms']:.4f}"
                f" ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"{rate(flops, t['ms'], bound_ms)}")
            rows["K1"] = dict(max_abs_err=err, bound_ms=bound_ms,
                              bound_by=bound_by, **t)

    log(f"[kernels] K3 fused dispatch: S{s} E{e} C{c} M{m} L{layers}")
    for dtype in (torch.bfloat16, torch.float32):
        tokens_ext, stt, n_drop, n_empty = skewed_slot_map(s, e, m, dtype,
                                                           gen)
        ws, bs = chain_weights(e, m, layers, dtype, gen)
        err = check_close(
            f"K3 {str(dtype)[6:]} ({n_drop} dropped, {n_empty} empty slots)",
            fused_dispatch.fused_dispatch_chain_fwd(tokens_ext, stt, ws, bs,
                                                    skips),
            fused_dispatch.fused_dispatch_chain_plain(tokens_ext, stt, ws, bs,
                                                      skips))
        if dtype == torch.bfloat16:
            flops = 2 * e * c * m * m * layers
            out_bytes = e * c * m * tokens_ext.element_size()
            bound_ms, bound_by = chain_bound(
                flops, nbytes(tokens_ext, stt, ws, bs) + out_bytes, dtype,
                peaks)
            stt_long = stt.long()
            t = {"ms": cuda_ms(lambda: fused_dispatch.fused_dispatch_chain_fwd(
                     tokens_ext, stt, ws, bs, skips)),
                 "plain_ms": cuda_ms(lambda: fused_dispatch
                                     .fused_dispatch_chain_plain(
                                         tokens_ext, stt, ws, bs, skips)),
                 "library_ms": cuda_ms(lambda: bmm_chain(
                     tokens_ext.index_select(0, stt_long).view(e, c, m),
                     ws, bs, skips))}
            log(f"  K3 bf16: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, index_select + baddbmm chain "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {rate(flops, t['ms'], bound_ms)}")
            rows["K3"] = dict(max_abs_err=err, bound_ms=bound_ms,
                              bound_by=bound_by, **t)
    k1, k3 = rows["K1"], rows["K3"]
    log(f"  K3 / K1: {k3['ms'] / k1['ms']:.3f}; K1 / baddbmm chain: "
        f"{k1['ms'] / k1['library_ms']:.3f}")
    return rows


def check_bwd(name: str, out, ref) -> float:
    """(dx, dW, db) of a backward kernel vs its plain version: dx with
    check_close's limits, dW and db relative to their largest entry (they
    sum C products). Returns the largest absolute error of the three."""
    torch.cuda.synchronize()
    errs = []
    for part, o, r, rel in zip(("dx", "dW", "db"), out, ref,
                               (False, True, True)):
        err = (o.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        if out[0].dtype == torch.bfloat16:
            tol = BF16_REL_TOL * scale
        else:
            tol = FP32_TOL * (scale if rel else 1.0)
        log(f"  {name} {part}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name} {part}: kernel disagrees with its "
                                 f"plain version: {err} > {tol}")
        errs.append(err)
    return max(errs)


def check_deterministic(name: str, fn) -> None:
    """fn() (a backward kernel's launch) twice: outputs bit-identical."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name} differs between two launches")
    log(f"  {name}: dx, dW, db bit-identical across two launches")


def autograd_ms(out, inputs, g) -> float:
    """The library yardstick of a backward: torch.autograd.grad through
    the recorded cuBLAS graph (no recompute), retained between calls."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, g,
                                               retain_graph=True))


def bwd_kernel_phase(peaks, building):
    """K2 and K4 vs their plain backwards at the train path's shapes."""
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch

    e = building["experts"]
    m, layers, skips = building["width"], building["layers"], building["skips"]
    s = building["chunk"]
    c = s // e
    gen = torch.Generator().manual_seed(1)
    rows = {}

    def bound(flops, in_bytes, dtype):
        # the gradient's products only (dx and dW: 4*E*C*M^2*L); the
        # kernel's recompute is its own choice and not in the bound
        return chain_bound(flops, in_bytes, dtype, peaks)

    log(f"[kernels] K2 expert chain backward: E{e} C{c} M{m} L{layers} "
        f"skips{skips}")
    for dtype, cc in ((torch.bfloat16, c), (torch.float32, c),
                      (torch.bfloat16, 1000)):
        ws, bs = chain_weights(e, m, layers, dtype, gen)
        x = torch.randn(e, cc, m, generator=gen).to("cuda", dtype)
        g = torch.randn(e, cc, m, generator=gen).to("cuda", dtype)
        err = check_bwd(f"K2 {str(dtype)[6:]} C{cc}",
                        expert_kernel.expert_mlp_chain_bwd(x, ws, bs, g,
                                                           skips),
                        expert_kernel.expert_mlp_chain_bwd_plain(x, ws, bs, g,
                                                                 skips))
        if dtype == torch.bfloat16 and cc == c:
            check_deterministic("K2 bf16", lambda: expert_kernel
                                .expert_mlp_chain_bwd(x, ws, bs, g, skips))
            flops = 4 * e * cc * m * m * layers
            out_bytes = nbytes(x) + 4 * (ws.numel() + bs.numel())
            bound_ms, bound_by = bound(
                flops, nbytes(x, g, ws, bs) + out_bytes, dtype)
            leaves = [t.clone().requires_grad_() for t in (x, ws, bs)]
            lib_out = bmm_chain(*leaves, skips)
            t = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain_bwd(
                     x, ws, bs, g, skips), iters=20),
                 "plain_ms": cuda_ms(lambda: expert_kernel
                                     .expert_mlp_chain_bwd_plain(
                                         x, ws, bs, g, skips), iters=20),
                 "library_ms": autograd_ms(lib_out, leaves, g)}
            del lib_out
            passes = device_ms_by_kernel(
                lambda: expert_kernel.expert_mlp_chain_bwd(x, ws, bs, g,
                                                           skips),
                {"pass 1": "chain_bwd_sm90", "pass 2": "chain_dw_sm90"})
            log(f"  K2 bf16 C{cc}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, autograd of the baddbmm chain "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {rate(flops, t['ms'], bound_ms)} (the "
                f"gradient's products); profiled pass 1 "
                f"{passes['pass 1']:.4f} ms, pass 2 {passes['pass 2']:.4f} ms")
            rows["K2"] = dict(max_abs_err=err, bound_ms=bound_ms,
                              bound_by=bound_by, **t)

    log(f"[kernels] K4 fused dispatch backward: S{s} E{e} C{c} M{m} "
        f"L{layers}")
    for dtype in (torch.bfloat16, torch.float32):
        tokens_ext, stt, n_drop, n_empty = skewed_slot_map(s, e, m, dtype,
                                                           gen)
        ws, bs = chain_weights(e, m, layers, dtype, gen)
        g = torch.randn(e, c, m, generator=gen).to("cuda", dtype)
        err = check_bwd(
            f"K4 {str(dtype)[6:]} ({n_drop} dropped, {n_empty} empty slots)",
            fused_dispatch.fused_dispatch_chain_bwd(tokens_ext, stt, ws, bs,
                                                    g, skips),
            fused_dispatch.fused_dispatch_chain_bwd_plain(tokens_ext, stt,
                                                          ws, bs, g, skips))
        if dtype == torch.bfloat16:
            check_deterministic("K4 bf16", lambda: fused_dispatch
                                .fused_dispatch_chain_bwd(tokens_ext, stt, ws,
                                                          bs, g, skips))
            flops = 4 * e * c * m * m * layers
            kept_rows = int((stt < s).sum())        # the token rows read
            in_bytes = (kept_rows * m * tokens_ext.element_size()
                        + nbytes(stt, g, ws, bs))
            out_bytes = nbytes(g) + 4 * (ws.numel() + bs.numel())
            bound_ms, bound_by = bound(flops, in_bytes + out_bytes, dtype)
            xg = tokens_ext.index_select(0, stt.long()).view(e, c, m)
            leaves = [t.clone().requires_grad_() for t in (xg, ws, bs)]
            lib_out = bmm_chain(*leaves, skips)
            t = {"ms": cuda_ms(lambda: fused_dispatch.fused_dispatch_chain_bwd(
                     tokens_ext, stt, ws, bs, g, skips), iters=20),
                 "plain_ms": cuda_ms(lambda: fused_dispatch
                                     .fused_dispatch_chain_bwd_plain(
                                         tokens_ext, stt, ws, bs, g, skips),
                                     iters=20),
                 "library_ms": autograd_ms(lib_out, leaves, g)}
            del lib_out
            log(f"  K4 bf16: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, autograd of index_select + "
                f"baddbmm chain {t['library_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), "
                f"{rate(flops, t['ms'], bound_ms)}")
            rows["K4"] = dict(max_abs_err=err, bound_ms=bound_ms,
                              bound_by=bound_by, **t)
    k2, k4 = rows["K2"], rows["K4"]
    log(f"  K4 / K2: {k4['ms'] / k2['ms']:.3f}; K2 / autograd of the "
        f"baddbmm chain: {k2['ms'] / k2['library_ms']:.3f}")
    return rows


def build_report() -> None:
    """Each library's HGMMA (wgmma) instruction count from `cuobjdump
    -sass` and its spill bytes from ptxas's -v report beside it. Every
    library holds a bf16 wgmma kernel, so a count of 0 fails the run; the
    ragged libraries' fp32 kernels run wgmma on TF32 operands, so a count
    of 0 TF32 HGMMAs there fails too, as does a spill in a 3xTF32 kernel."""
    import re
    from pathlib import Path
    from switch_nerf_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")  # nvcc's toolkit
    if not cuobjdump.exists():
        cuobjdump = None
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        report = lib.with_suffix(".log")
        text = report.read_text(errors="replace") if report.exists() else ""
        spills = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", text))
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        # which kernels spill: "Function properties for <mangled name>"
        # is followed by its stack frame and spill line
        spilling = sorted({
            re.sub(r"^.*?\d(chain_[a-z0-9_]*?(?:kernel|sm90|tf32))ILi(\d+)E"
                   r"(?:Li(\d+)E)?.*$", r"\1<\2,\3>", fn)
            + f" ({int(st) + int(ld)} B)"
            for fn, st, ld in re.findall(
                r"Function properties for (\S+)\n[^\n]*?(\d+) bytes spill "
                r"stores, (\d+) bytes spill loads", text)
            if int(st) or int(ld)})
        if cuobjdump is None:
            hgmma = "not measured (no cuobjdump)"
        else:
            sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                                  capture_output=True, text=True,
                                  timeout=120, check=True).stdout
            hgmma = sass.count("HGMMA")
            if hgmma == 0:
                raise AssertionError(f"lib{name}: no HGMMA instruction")
            if name.startswith("ragged"):
                tf32 = sum("TF32" in ln for ln in sass.splitlines()
                           if "HGMMA" in ln)
                if tf32 == 0:
                    raise AssertionError(f"lib{name}: no TF32 HGMMA")
                hgmma = f"{hgmma} ({tf32} on TF32)"
        if any("tf32" in k for k in spilling):
            raise AssertionError(f"lib{name}: a 3xTF32 kernel spills: "
                                 f"{spilling}")
        log(f"  lib{name}: HGMMA {hgmma}; ptxas spill bytes "
            f"{spills if text else 'not measured (no report)'}"
            f"{f' in {spilling}' if spilling else ''}, registers "
            f"per kernel {sorted(set(regs))}")


def check_finite(res: dict, n: int) -> None:
    for k, v in res.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite values in {k}")
    if tuple(res["rgb_fine"].shape) != (n, 3):
        raise AssertionError(f"rgb_fine shape {tuple(res['rgb_fine'].shape)}")


def slice_phase(h, counts):
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch
    from switch_nerf_torch.profile_eval import ray_batch
    from switch_nerf_torch.trainer import (
        SceneInfo, make_eval_step, render_config_from_hparams)

    cfg = render_config_from_hparams(h)
    scene = SceneInfo(np.zeros(3, np.float32), np.ones(3, np.float32))

    def eval_step(hp, device):
        model = get_nerf(hp, 8, device=device, seed=0)
        bg = get_bg_nerf(hp, 8, device=device, seed=1)
        return make_eval_step(model, bg, hp, cfg, scene, device=device)

    step = eval_step(h, "cuda")
    log(f"[slice] Building eval, bf16, {N_RAYS} rays per request")
    check_finite(step(ray_batch(N_RAYS, 100, "cuda")), N_RAYS)   # warm-up
    torch.cuda.synchronize()

    batches = [ray_batch(N_RAYS, seed, "cuda") for seed in range(N_REQUESTS)]
    expert_kernel.launches = fused_dispatch.launches = 0
    times, results = [], []
    for b in batches:
        t0 = time.perf_counter()
        res = step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        results.append(res)
    counts["K1"] = expert_kernel.launches
    for res in results:
        check_finite(res, N_RAYS)
    chunks = (-(-N_RAYS * h.coarse_samples // h.model_chunk_size)
              + -(-N_RAYS * h.fine_samples // h.model_chunk_size))
    log(f"  request seconds {[round(t, 4) for t in times]}; K1 launches "
        f"{counts['K1']} (expected {chunks} per request)")
    if counts["K1"] != chunks * N_REQUESTS or fused_dispatch.launches:
        raise AssertionError("the main path did not run K1 once per fg chunk")
    rays_per_s = N_RAYS * N_REQUESTS / sum(times)
    log(f"  eval rays/s: {rays_per_s:.1f}")

    # the same request without --moe_test_batch: no-drop eval dispatch,
    # the reference's default, on K1R (the same seeded weights)
    from switch_nerf_torch.ops import ragged_chain
    hn = Namespace(**vars(h))
    hn.moe_test_batch = False
    nodrop_step = eval_step(hn, "cuda")
    check_finite(nodrop_step(batches[1]), N_RAYS)                 # warm-up
    torch.cuda.synchronize()
    expert_kernel.launches = ragged_chain.ragged_launches = 0
    t0 = time.perf_counter()
    nodrop = nodrop_step(batches[0])
    torch.cuda.synchronize()
    t_nodrop = time.perf_counter() - t0
    counts["K1R"] = ragged_chain.ragged_launches
    check_finite(nodrop, N_RAYS)
    log(f"  no-drop eval (no --moe_test_batch): request {t_nodrop:.4f} s, "
        f"{N_RAYS / t_nodrop:.1f} rays/s beside padded {rays_per_s:.1f}; K1R "
        f"launches {counts['K1R']} a request (expected {chunks}), K1 "
        f"{expert_kernel.launches}")
    if counts["K1R"] != chunks or expert_kernel.launches:
        raise AssertionError("the no-drop eval did not run K1R once per fg "
                             "chunk")

    # CPU fp32 cross-check: the same weights (same seeds, fp32 parameters)
    # on the CPU with the plain versions and on the card with the fp32
    # kernel. A token whose two best gates nearly tie can take another
    # expert under cuBLAS than under the CPU's GEMM, moving a few rays by
    # more than the median: hence median and 99th-percentile limits.
    h32 = Namespace(**vars(h))
    h32.amp = False
    sub = {k: v[:CHECK_RAYS] for k, v in batches[0].items()}
    gpu32 = eval_step(h32, "cuda")(sub)
    cpu32 = eval_step(h32, "cpu")({k: v.cpu() for k, v in sub.items()})
    diff = (gpu32["rgb_fine"].cpu() - cpu32["rgb_fine"]).abs().flatten()
    med, p99 = diff.median().item(), diff.quantile(0.99).item()
    log(f"  card fp32 vs CPU fp32 on {CHECK_RAYS} rays: |d rgb_fine| median "
        f"{med:.3e} (limit 1e-4), p99 {p99:.3e} (limit 1e-2)")
    if not (med <= 1e-4 and p99 <= 1e-2):
        raise AssertionError("the card disagrees with the CPU reference")

    # the fused dispatch + chain path (opt-in, as in the JAX package)
    os.environ["SWITCH_NERF_FUSED_DISPATCH"] = "1"
    try:
        expert_kernel.launches = fused_dispatch.launches = 0
        t0 = time.perf_counter()
        fused = step(batches[0])
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        counts["K3"] = fused_dispatch.launches
    finally:
        del os.environ["SWITCH_NERF_FUSED_DISPATCH"]
    check_finite(fused, N_RAYS)
    ref = results[0]["rgb_fine"].float()
    err = (fused["rgb_fine"].float() - ref).abs().max().item()
    log(f"  fused request {t_fused:.4f} s, K3 launches {counts['K3']}, "
        f"max |d rgb_fine| vs unfused {err:.3e}")
    if counts["K3"] == 0 or expert_kernel.launches:
        raise AssertionError("the fused path did not run K3")
    if not err <= BF16_REL_TOL * ref.abs().max().item():
        raise AssertionError("fused and unfused renders disagree")
    return rays_per_s


def flat(grads) -> torch.Tensor:
    return torch.cat([g.detach().float().reshape(-1).cpu() for g in grads])


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a.double(), b.double())
                 / (a.double().norm() * b.double().norm()))


def train_phase(counts):
    """The published Building train step at full width on the card."""
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch
    from switch_nerf_torch.profile_eval import (
        SCENE, building_train_hparams, ray_batch)
    from switch_nerf_torch.trainer import (
        create_train_state, make_train_step, render_config_from_hparams)

    def setup(hp, device):
        state = create_train_state(
            hp, get_nerf(hp, 8, device=device, seed=0),
            get_bg_nerf(hp, 8, device=device, seed=1), device=device)
        step = make_train_step(hp, render_config_from_hparams(hp), SCENE,
                               device=device)
        return state, step

    h = building_train_hparams()
    chunks = (-(-h.batch_size * h.coarse_samples // h.model_chunk_size)
              + -(-h.batch_size * h.fine_samples // h.model_chunk_size))
    log(f"[train] Building train step, bf16, {h.batch_size} rays, "
        f"{chunks} fg chunks per step")
    state, step = setup(h, "cuda")
    batch = ray_batch(h.batch_size, 0, "cuda", rgbs=True)
    step(state, batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    expert_kernel.launches = expert_kernel.bwd_launches = 0
    fused_dispatch.launches = fused_dispatch.bwd_launches = 0
    times, photo = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in met.items() if not bool(torch.isfinite(v))]
        if bad or float(met["finite"]) != 1.0:
            raise AssertionError(f"train step {i + 1}: non-finite {bad}")
        photo.append(float(met["photo_loss"]))
    counts["K1"] = expert_kernel.launches
    counts["K2"] = expert_kernel.bwd_launches
    k3, k4 = fused_dispatch.launches, fused_dispatch.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    rays_per_s = h.batch_size * TRAIN_STEPS / sum(times)
    log(f"  step seconds {[round(t, 4) for t in times]}")
    log(f"  photo_loss step 1 {photo[0]:.6f}, step {TRAIN_STEPS} "
        f"{photo[-1]:.6f}; last metrics "
        f"{ {k: round(float(v), 6) for k, v in met.items()} }")
    log(f"  launches: K1 {counts['K1']}, K2 {counts['K2']} (expected "
        f"{chunks * TRAIN_STEPS} each), K3 {k3}, K4 {k4}")
    if not (counts["K1"] == counts["K2"] == chunks * TRAIN_STEPS
            and k3 == k4 == 0):
        raise AssertionError("the train path did not run K1 and K2 once "
                             "per fg chunk")
    if not photo[-1] < photo[0]:
        raise AssertionError("photo_loss did not fall over the steps")
    log(f"  train rays/s {rays_per_s:.1f}, mean step "
        f"{sum(times) / len(times):.4f} s, max_memory_allocated "
        f"{peak} B ({peak / 2 ** 30:.2f} GiB)")

    # CPU fp32 cross-check of one step's loss and gradients: the same
    # seeded weights on the card (kernels) and on the CPU (plain versions),
    # no perturbation or noise. A token whose two best gates nearly tie can
    # take another expert under cuBLAS than under the CPU's GEMM, so the
    # gradients are held to a cosine, not to equality.
    h32 = copy.copy(h)
    h32.amp = False
    h32.perturb = 0.0
    h32.use_sigma_noise = False
    sub = {k: v[:TRAIN_CHECK_RAYS] for k, v in batch.items()}
    sg, stg = setup(h32, "cuda")
    sc, stc = setup(h32, "cpu")
    met_g, grads_g = stg.loss_and_grads(sg, sub)
    met_c, grads_c = stc.loss_and_grads(sc, {k: v.cpu()
                                             for k, v in sub.items()})
    d_loss = abs(float(met_g["all_loss"]) - float(met_c["all_loss"]))
    cos = cosine(flat(grads_g), flat(grads_c))
    log(f"  card fp32 vs CPU fp32 train step on {TRAIN_CHECK_RAYS} rays: "
        f"|d all_loss| {d_loss:.3e} (limit 1e-4 * {float(met_c['all_loss']):.4f})"
        f", gradient cosine {cos:.6f} (limit 0.999)")
    if not (d_loss <= 1e-4 * abs(float(met_c["all_loss"])) and cos >= 0.999):
        raise AssertionError("the card's train step disagrees with the CPU")
    del sg, stg, sc, stc, grads_g, grads_c

    # the fused dispatch + chain path (opt-in, as in the JAX package): the
    # same state, batch and generator seed, with and without the switch
    seed = h.random_seed + 1
    state.generator.manual_seed(seed)
    met_u, grads_u = step.loss_and_grads(state, batch)
    grads_u = flat(grads_u)
    os.environ["SWITCH_NERF_FUSED_DISPATCH"] = "1"
    try:
        expert_kernel.launches = expert_kernel.bwd_launches = 0
        fused_dispatch.launches = fused_dispatch.bwd_launches = 0
        state.generator.manual_seed(seed)
        t0 = time.perf_counter()
        met_f, grads_f = step.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        counts["K3"] = fused_dispatch.launches
        counts["K4"] = fused_dispatch.bwd_launches
        k1, k2 = expert_kernel.launches, expert_kernel.bwd_launches
    finally:
        del os.environ["SWITCH_NERF_FUSED_DISPATCH"]
    lu, lf = float(met_u["all_loss"]), float(met_f["all_loss"])
    cos = cosine(flat(grads_f), grads_u)
    log(f"  fused train step {t_fused:.4f} s, K3 {counts['K3']} / K4 "
        f"{counts['K4']} launches (K1 {k1}, K2 {k2}); all_loss {lf:.6f} vs "
        f"unfused {lu:.6f}, gradient cosine {cos:.6f}")
    if not (counts["K3"] > 0 and counts["K4"] > 0 and k1 == k2 == 0):
        raise AssertionError("the fused train step did not run K3 and K4")
    if not (abs(lf - lu) <= BF16_REL_TOL * abs(lu) and cos >= 0.999):
        raise AssertionError("fused and unfused train steps disagree")
    return {"rays_per_s": rays_per_s, "step_s": sum(times) / len(times),
            "peak_bytes": peak}


def make_scene(root, seed: int) -> None:
    """A synthetic Mega-NeRF scene in `root`: coordinates.pt, and
    SCENE_TRAIN + SCENE_VAL cameras 0.8 above the origin in the
    pose-normalised frame (drb: +x is down), looking straight down, each
    with metadata/<name>.pt (c2w, W, H, 4-entry intrinsics) and a smooth
    random rgbs/<name>.jpg at SCENE_W x SCENE_H."""
    from pathlib import Path

    from PIL import Image
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    # origin and scale put building.yaml's altitude range [8, 50] at
    # x in [-0.44, 0.4] of the normalised frame
    torch.save({"origin_drb": torch.tensor([30.0, 0.0, 0.0]),
                "pose_scale_factor": 50.0}, root / "coordinates.pt")
    look_down = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], np.float32)
    val = {1, 4}
    for i in range(SCENE_TRAIN + SCENE_VAL):
        split = root / ("val" if i in val else "train")
        (split / "metadata").mkdir(parents=True, exist_ok=True)
        (split / "rgbs").mkdir(parents=True, exist_ok=True)
        c2w = np.concatenate([look_down, np.array(
            [[-0.8], rng.uniform(-0.4, 0.4, [1]),
             rng.uniform(-0.4, 0.4, [1])], np.float32)], 1)
        torch.save({"c2w": torch.from_numpy(c2w), "W": SCENE_W,
                    "H": SCENE_H, "intrinsics": torch.tensor(
                        [900.0, 900.0, SCENE_W / 2, SCENE_H / 2])},
                   split / "metadata" / f"{i:06d}.pt")
        coarse = rng.uniform(0, 255, (SCENE_H // 16, SCENE_W // 16, 3))
        Image.fromarray(coarse.astype(np.uint8)).resize(
            (SCENE_W, SCENE_H), Image.BICUBIC).save(
                split / "rgbs" / f"{i:06d}.jpg")


def checkpoint_round_trip(h, ckpt_dir) -> dict:
    """Save a port train state made from seeds (after one train step, so
    its Adam moments are not zero) and load it into fresh models: every
    parameter and moment bit-equal, fingerprints equal."""
    from switch_nerf_torch import checkpoints
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
    from switch_nerf_torch.profile_eval import SCENE, ray_batch
    from switch_nerf_torch.trainer import (
        create_train_state, make_train_step, render_config_from_hparams)

    ht = copy.copy(h)
    ht.moe_train_batch = True           # the same parameters, trainable
    n_images = SCENE_TRAIN + SCENE_VAL
    state = create_train_state(ht, get_nerf(ht, n_images, seed=10),
                               get_bg_nerf(ht, n_images, seed=11))
    make_train_step(ht, render_config_from_hparams(ht), SCENE)(
        state, ray_batch(1024, 3, "cuda", rgbs=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoints.save_checkpoint(ckpt_dir, state)
    save_s = time.perf_counter() - t0

    fresh = create_train_state(h, get_nerf(h, n_images, seed=20),
                               get_bg_nerf(h, n_images, seed=21),
                               for_training=False)
    t0 = time.perf_counter()
    _, extra = checkpoints.load_checkpoint(ckpt_dir, fresh,
                                           restore_rng_states=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params = list(zip(state.parameters(), fresh.parameters()))
    for a, b in params:
        sa, sb = state.optimizer.state[a], fresh.optimizer.state[b]
        if not (torch.equal(a, b) and all(
                torch.equal(sa[k], sb[k])
                for k in ("step", "exp_avg", "exp_avg_sq"))):
            raise AssertionError("checkpoint round trip is not bit-equal")
    if not any(bool(state.optimizer.state[a]["exp_avg"].any())
               for a, _ in params):
        raise AssertionError("the saved Adam moments are all zero")
    if extra["param_fingerprint"] != checkpoints._state_fingerprint(fresh):
        raise AssertionError("checkpoint fingerprint mismatch")
    size = (path / "state.msgpack").stat().st_size
    log(f"  checkpoint {path.name}: state.msgpack {size} B, save "
        f"{save_s:.4f} s, load {load_s:.4f} s; {len(params)} parameters "
        "and their Adam moments bit-equal, fingerprint equal")
    return {"ckpt_bytes": size, "save_s": save_s, "load_s": load_s}


def read_metrics(path) -> dict:
    return {k: float(v) for k, v in (
        line.split(": ") for line in path.read_text().splitlines())}


def runner_phase() -> str:
    """Serve a trained scene: checkpoint round trip, Runner.eval_image on
    the card, and the checks of the module docstring's phase 5."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch.datasets.ray_utils import (get_ray_directions,
                                                      get_rays)
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch
    from switch_nerf_torch.profile_eval import building_eval_hparams
    from switch_nerf_torch.runner import Runner
    from switch_nerf_torch.trainer import (SceneInfo, make_eval_step,
                                           render_config_from_hparams)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as tmp:
        tmp = Path(tmp)
        make_scene(tmp / "scene", seed=0)
        h = building_eval_hparams()
        h.dataset_path = str(tmp / "scene")
        h.exp_name = str(tmp / "exp")
        h.ckpt_path = str(tmp / "ckpt")
        log(f"[runner] Building eval_image on a synthetic {SCENE_W}x"
            f"{SCENE_H} scene, --val_scale_factor {h.val_scale_factor}, "
            f"{h.image_pixel_batch_size}-ray requests")
        ckpt = checkpoint_round_trip(h, tmp / "ckpt")

        runner = Runner(h)
        per_image, renders = [], []
        real = runner.render_image

        def counted(metadata, render_chunks):
            expert_kernel.launches = fused_dispatch.launches = 0
            res = real(metadata, render_chunks)
            per_image.append((expert_kernel.launches,
                              fused_dispatch.launches))
            renders.append(res)
            return res
        runner.render_image = counted
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        means = runner.eval_image()
        eval_s = time.perf_counter() - t0
        exp = runner.experiment_path

        md = runner.val_items[0]
        n_rays = md.W * md.H
        bs = h.image_pixel_batch_size         # rays per (padded) request
        chunks = -(-n_rays // bs) * (-(-bs * h.coarse_samples
                                       // h.model_chunk_size)
                                     + -(-bs * h.fine_samples
                                         // h.model_chunk_size))
        log(f"  K1/K3 launches per image {per_image} (expected K1 {chunks})")
        if any(k1 != chunks or k3 for k1, k3 in per_image) \
                or len(per_image) != SCENE_VAL:
            raise AssertionError("the runner did not run K1 on every image")

        metrics = [read_metrics(exp / "images" / f"metrics_{i}.txt")
                   for i in range(SCENE_VAL)]
        for m in metrics:
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite metrics {m}")
            lp = [v for k, v in m.items() if k.startswith("lpips-")]
            if not (-1.0 <= m["ssim"] <= 1.0 and len(lp) == 3
                    and min(lp) >= 0.0):
                raise AssertionError(f"metrics out of range {m}")
        want = ["metrics.txt"]
        for i in range(SCENE_VAL):
            want += [f"images/metrics_{i}.txt", f"val_images/{i}.jpg"]
            for sub in ("", "_bg", "_fg"):
                want += [f"images/{i}_{p}{sub}.jpg"
                         for p in ("gt", "pred", "depth")]
            want += [f"val_images/{i}_bg.jpg", f"val_images/{i}_fg.jpg"]
        missing = [f for f in want if not (exp / f).is_file()]
        if missing:
            raise AssertionError(f"eval files missing: {missing}")
        if "Average val/psnr" not in (exp / "metrics.txt").read_text():
            raise AssertionError("metrics.txt lacks the psnr average")

        # the first rays of val image 0 through a direct eval step call:
        # 4,096 rays fill whole model chunks in both calls (4096 x 256 and
        # 4096 x 512 points are multiples of 32,768), so every chunk routes
        # the same tokens and the GEMMs see the same shapes
        rays = get_rays(get_ray_directions(
            md.W, md.H, *md.intrinsics, h.center_pixels), md.c2w,
            runner.near, runner.far, runner.ray_altitude_range
        ).reshape(-1, 8)[:RUNNER_CHECK_RAYS]
        step = make_eval_step(runner.nerf, runner.bg_nerf, h,
                              render_config_from_hparams(h),
                              SceneInfo(runner.sphere_center,
                                        runner.sphere_radius))
        direct = step({"rays": torch.from_numpy(rays).cuda(),
                       "image_indices": torch.full(
                           (rays.shape[0],), float(md.image_index),
                           device="cuda")})
        ran = renders[0]["rgb_fine"].reshape(-1, 3)[:rays.shape[0]]
        err = float(np.abs(direct["rgb_fine"].float().cpu().numpy()
                           - ran).max())
        log(f"  first {RUNNER_CHECK_RAYS} rays of val image 0 vs a direct "
            f"make_eval_step call: max |d rgb_fine| {err:.3e} (limit 1e-6)")
        if not err <= 1e-6:
            raise AssertionError("the runner's render differs from the step")

    secs = [m["time"] for m in metrics]
    m0 = metrics[0]
    line = (f"{n_rays} rays ({md.W}x{md.H}) per image, render seconds per "
            f"image {[round(t, 4) for t in secs]}, rays/s per image "
            f"{[round(n_rays / t, 1) for t in secs]}, eval_image "
            f"{eval_s:.4f} s for {SCENE_VAL} images; max_memory_allocated "
            f"{max(m['memory'] for m in metrics):.1f} MiB; image 0 psnr "
            f"{m0['psnr']:.4f} ssim {m0['ssim']:.4f} "
            + " ".join(f"{k} {v:.4f}" for k, v in m0.items()
                       if k.startswith("lpips-"))
            + f"; checkpoint {ckpt['ckpt_bytes']} B, save "
            f"{ckpt['save_s']:.4f} s, load {ckpt['load_s']:.4f} s; means "
            f"psnr {means['psnr']:.4f}")
    return line


@contextlib.contextmanager
def wrapped(owner, name: str, make):
    """owner.name replaced by make(the original) for the block."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def drop_masks():
    """Each MoE routing call's dropped tokens (location >= capacity) in
    the block, a bool array a call in call order, on the host."""
    from switch_nerf_torch.models import moe as tmoe
    masks = []

    def make(real):
        def run(*a, **k):
            plan, l_aux = real(*a, **k)
            masks.append((plan.locations[0] >= plan.capacity).cpu().numpy())
            return plan, l_aux
        return run
    with wrapped(tmoe, "extract_critical", make):
        yield masks


def batch_digest(batch: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def param_hash(state) -> str:
    """sha1 of the replicated parameters (under expert parallelism a
    rank's block of experts is its own)."""
    h = hashlib.sha1()
    for p in state.parameters():
        if getattr(p, "expert_mesh", None) is None:
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def run_training(h, dataset_cls=None, device=None) -> dict:
    """train.main(h, device) on the card with the runner's data path, steps
    and saves instrumented: per-step batch hashes, losses (and photo_loss),
    whether every metric was finite, and host-clock end times (each step
    ends in a sync: the finite check), chunk write / read / blocked seconds
    of the chunked dataset class (FilesystemDataset unless given),
    checkpoint save seconds and the parameters' hash at each save, and the
    K1-K4 launches of the run."""
    from switch_nerf_torch import runner as runner_mod
    from switch_nerf_torch import train
    from switch_nerf_torch.datasets.filesystem_dataset import \
        FilesystemDataset
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch
    from switch_nerf_torch.parallel import experts as ep_ops

    dataset_cls = dataset_cls or FilesystemDataset
    rec = {"digests": [], "loss": [], "photo": [], "finite": [], "t_end": [],
           "write_s": [], "read_s": [], "blocked_s": [], "save_s": [],
           "hashes": {}}

    def timed(key):
        def make(real):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = real(*a, **k)
                rec[key].append(time.perf_counter() - t0)
                return out
            return run
        return make

    def put(real):
        def run(self, batch, *a):
            rec["digests"].append(batch_digest(batch))
            return real(self, batch, *a)
        return run

    def saving(real):
        def run(ckpt_dir, state, *a, **k):
            rec["hashes"][int(state.step)] = param_hash(state)
            return timed("save_s")(real)(ckpt_dir, state, *a, **k)
        return run

    def make_step(real):
        def make(*a, **k):
            step = real(*a, **k)

            def run(state, batch):
                state, m = step(state, batch)
                rec["loss"].append(float(m["loss"]))
                rec["photo"].append(float(m["photo_loss"]))
                rec["finite"].append(all(bool(torch.isfinite(v))
                                         for v in m.values()))
                rec["t_end"].append(time.perf_counter())
                return state, m
            return run
        return make

    with contextlib.ExitStack() as stack:
        for owner, name, make in (
                (dataset_cls, "_write_chunks", timed("write_s")),
                (dataset_cls, "_read_chunk", timed("read_s")),
                (dataset_cls, "load_chunk", timed("blocked_s")),
                (runner_mod, "save_checkpoint", saving),
                (runner_mod.Runner, "_put_batch", put),
                (runner_mod, "make_train_step", make_step)):
            stack.enter_context(wrapped(owner, name, make))
        expert_kernel.launches = expert_kernel.bwd_launches = 0
        fused_dispatch.launches = fused_dispatch.bwd_launches = 0
        ep_ops.STATS.update(exchanges=0, bytes=0, form=None)
        t0 = time.perf_counter()
        state = train.main(h, device=device)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["exchange"] = dict(ep_ops.STATS)
        rec["launches"] = {"K1": expert_kernel.launches,
                           "K2": expert_kernel.bwd_launches,
                           "K3": fused_dispatch.launches,
                           "K4": fused_dispatch.bwd_launches}
    rec["step"] = state.step
    rec["n_params"] = sum(p.numel() for p in state.parameters())
    return rec


def logged_windows(log_path) -> list:
    """The runner's --i_print lines as {name: value} dicts."""
    out = []
    for line in log_path.read_text().splitlines():
        if line.startswith("iter "):
            fields = dict(f.split("=") for f in line.split()[2:])
            out.append({k: float(v) for k, v in fields.items()})
    return out


def train_runner_phase(fixed_rays_per_s: float) -> str:
    """Train a scene end to end through Runner.train on the card and
    resume it: the checks of the module docstring's phase 6."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch.profile_eval import building_train_hparams

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        make_scene(tmp / "scene", seed=0)
        h = building_train_hparams()
        h.dataset_path = str(tmp / "scene")
        h.exp_name = str(tmp / "exp")
        h.dataset_type = "filesystem"
        h.chunk_paths = [str(tmp / "chunks")]
        h.train_scale_factor = 4
        h.num_chunks = RUN_CHUNKS
        h.train_iterations = RUN_STEPS
        h.ckpt_interval = RUN_CKPT
        h.i_print = RUN_PRINT
        h.val_interval = RUN_STEPS + 1
        chunks = (-(-h.batch_size * h.coarse_samples // h.model_chunk_size)
                  + -(-h.batch_size * h.fine_samples // h.model_chunk_size))
        log(f"[train_runner] Runner.train on a synthetic {SCENE_W}x{SCENE_H}"
            f" scene, --train_scale_factor {h.train_scale_factor}, "
            f"{RUN_CHUNKS} chunks, {RUN_STEPS} steps of {h.batch_size} rays")
        torch.cuda.reset_peak_memory_stats()
        first = run_training(h)
        peak = torch.cuda.max_memory_allocated()
        exp = Path(h.exp_name) / "0"
        n = first["launches"]
        log(f"  launches: {n} (expected K1, K2 {chunks * RUN_STEPS} each)")
        if not (first["step"] == RUN_STEPS
                and n["K1"] == n["K2"] == chunks * RUN_STEPS
                and n["K3"] == n["K4"] == 0):
            raise AssertionError("Runner.train did not run K1 and K2 once "
                                 "per fg chunk of every step")
        windows = logged_windows(exp / "log.txt")
        if len(windows) != RUN_STEPS // RUN_PRINT or not all(
                np.isfinite(v) for w in windows for v in w.values()):
            raise AssertionError(f"logged metrics {windows}")
        steps = sorted(int(p.name) for p in (exp / "models").iterdir())
        extra = json.loads((exp / "models" / str(RUN_CKPT)
                            / "extra.json").read_text())
        cursor = json.loads(extra["dataset_state"])
        log(f"  step dirs {steps}; step {RUN_CKPT} extra.json: host_iteration"
            f" {extra['host_iteration']}, dataset_index "
            f"{extra['dataset_index']}, chunk {cursor['chunk']}, generator "
            f"state {len(extra['torch_generator_state'])} base64 chars")
        if not (steps == [RUN_CKPT, RUN_STEPS]
                and extra["host_iteration"] == RUN_CKPT
                and extra["dataset_index"] >= 0 and "batch_rng" in cursor
                and extra["torch_generator_state"]):
            raise AssertionError("interval checkpoints incomplete")
        rows = 0
        for part in (tmp / "chunks").glob("chunk_*/part_*.npz"):
            with np.load(part) as z:
                rows += z["rgbs"].shape[0]

        resumed = copy.copy(h)
        resumed.exp_name = str(tmp / "resumed")
        resumed.ckpt_path = str(exp / "models" / str(RUN_CKPT))
        second = run_training(resumed)
        same = second["digests"] == first["digests"][RUN_CKPT:]
        rel = [abs(a - b) / abs(b) for a, b in
               zip(second["loss"], first["loss"][RUN_CKPT:])]
        log(f"  resumed from step {RUN_CKPT}: {len(second['digests'])} "
            f"batches, hashes equal to the first run's {same}; loss "
            f"relative difference first step {rel[0]:.3e} (limit 1e-3), "
            f"largest over the resumed steps {max(rel):.3e}")
        if not (same and second["step"] == RUN_STEPS and rel[0] <= 1e-3):
            raise AssertionError("the resumed run does not replay the run")

    t = first["t_end"]
    runner_rays_s = (RUN_STEPS - RUN_PRINT) * h.batch_size / (
        t[-1] - t[RUN_PRINT - 1])
    data_s = [w["data_sample_time"] for w in windows]
    return (f"{rows} rays in {RUN_CHUNKS} chunks, chunk write "
            f"{first['write_s'][0]:.4f} s, chunk load seconds "
            f"{[round(x, 4) for x in first['read_s']]}, load_chunk blocked "
            f"seconds {[round(x, 4) for x in first['blocked_s']]}; train "
            f"rays/s through Runner.train (steps {RUN_PRINT + 1}-{RUN_STEPS})"
            f" {runner_rays_s:.1f} vs {fixed_rays_per_s:.1f} fixed-batch "
            f"({runner_rays_s / fixed_rays_per_s:.3f}); mean data_sample_time"
            f" {sum(data_s) / len(data_s):.6f} s; checkpoint save seconds "
            f"{[round(x, 4) for x in first['save_s']]}; first run "
            f"{first['wall_s']:.1f} s wall; max_memory_allocated {peak} B "
            f"({peak / 2 ** 30:.2f} GiB); resumed loss max rel diff "
            f"{max(rel):.3e}")


# ------------------------------------------------ no-drop: K1R, K2R ----

def skewed_counts(n: int, e: int) -> list:
    """Expert row counts summing to n: expert 0 gets none, expert 1 a count
    off the 32- and 128-row blocks (3,001), expert 2 three quarters of the
    rest, the others the remainder."""
    rest = n - 3001
    big = rest * 3 // 4
    others = [(rest - big) // (e - 3)] * (e - 3)
    others[-1] += rest - big - sum(others)
    return [0, 3001, big] + others


def dirty_allocator(nbytes: int = 1 << 30) -> None:
    """Leave NaN bytes in the caching allocator's free blocks, so a kernel
    output that is allocated with torch.empty and not written shows."""
    torch.full((nbytes // 4,), float("nan"), device="cuda")
    torch.cuda.synchronize()


def addmm_ragged(x, counts_host, ws, bs, skips):
    """The library yardstick of K1R: after the counts reach the host, one
    torch.addmm (cuBLAS, bias fused) per expert and layer."""
    outs, lo = [], 0
    layers = ws.shape[0]
    for e, c in enumerate(counts_host):
        if not c:
            continue
        h = xin = x[lo:lo + c]
        for l in range(layers):
            h = torch.addmm(bs[l, e], h, ws[l, e])
            last = l == layers - 1
            if l in skips:
                h = h + xin
                if not last:
                    h = torch.relu(h)
                xin = h
            elif not last:
                h = torch.relu(h)
        outs.append(h)
        lo += c
    return torch.cat(outs)


def f64_errors(x, counts, ws, bs, g, skips) -> dict:
    """At one chunk of Bungee's fp32 layer: the largest error of K1R/K2R's
    outputs (out, dx, dW, db) and of the plain fp32 chain's against a
    float64 run of the plain chain (autograd for the gradients), each
    relative to the float64 output's largest entry."""
    from switch_nerf_torch.ops import ragged_chain as rc
    wide = [t.double().requires_grad_() for t in (x, ws, bs)]
    ref = rc.ragged_chain_plain(wide[0], counts, wide[1], wide[2], skips)
    refs = [ref.detach()] + list(torch.autograd.grad(ref, wide, g.double()))
    del ref, wide
    out = {}
    for who, fwd, bwd in (("kernel", rc.ragged_chain_fwd, rc.ragged_chain_bwd),
                          ("plain", rc.ragged_chain_plain,
                           rc.ragged_chain_bwd_plain)):
        got = [fwd(x, counts, ws, bs, skips)] + list(
            bwd(x, counts, ws, bs, g, skips))
        out[who] = [((o.double() - r).abs().max() / r.abs().max()).item()
                    for o, r in zip(got, refs)]
    return out


def ragged_kernel_phase(peaks, shapes):
    """K1R and K2R vs their plain versions at the shapes of the no-drop
    paths (one 32,768-point model chunk): fp32 at Bungee's (E4, the
    training path) and bf16 at Building's (E8, an eval without
    --moe_test_batch), over skewed counts (checked and timed) and balanced
    ones (timed); K2R deterministic and an empty expert's dW and db exactly
    zero; each step's device time by kernel name (torch.profiler); the fp32
    kernels' error against float64 beside the plain fp32 chain's. Returns
    the rows of both shapes (skewed counts)."""
    from switch_nerf_torch.ops import ragged_chain as rc

    gen = torch.Generator().manual_seed(2)
    rows = {}
    for label, dtype, e in (("Bungee", torch.float32, shapes["bungee_e"]),
                            ("Building", torch.bfloat16, shapes["experts"])):
        n, m = RAGGED_N, shapes["width"]
        layers, skips = shapes["layers"], shapes["skips"]
        dt = str(dtype)[6:]
        ws, bs = chain_weights(e, m, layers, dtype, gen)
        x = torch.randn(n, m, generator=gen).to("cuda", dtype)
        g = torch.randn(n, m, generator=gen).to("cuda", dtype)
        if dtype == torch.bfloat16:
            steps_fwd = {"K1R": "chain_fwd_sm90"}
            steps_bwd = {"pass 1": "chain_bwd_sm90", "pass 2": "chain_dw_sm90",
                         "reduction": "reduce_partials"}
        else:
            steps_fwd = {"prep": "tf32_split_weights", "K1R": "chain_fwd_tf32"}
            steps_bwd = {"prep": "tf32_split_weights",
                         "pass 1": "chain_bwd_tf32", "pass 2": "chain_dw_tf32",
                         "reduction": "reduce_partials"}
        flops_f, flops_b = 2 * n * m * m * layers, 4 * n * m * m * layers
        out_bytes = nbytes(x) + 4 * (ws.numel() + bs.numel())
        bounds = {}
        for name, flops, nb in (
                ("K1R", flops_f, nbytes(x, ws, bs) + 4 * e + nbytes(x)),
                ("K2R", flops_b, nbytes(x, g, ws, bs) + 4 * e + out_bytes)):
            bounds[name] = chain_bound(flops, nb, dtype, peaks)
            if dtype == torch.float32:   # 3 TF32 products per fp32 product
                bounds[name + " cuda cores"] = bounds[name]
                bounds[name] = chain_bound(3 * flops, nb, "tf32", peaks)
        for kind in ("skewed", "balanced"):
            counts_host = (skewed_counts(n, e) if kind == "skewed"
                           else [n // e] * e)
            counts = torch.tensor(counts_host, dtype=torch.int32,
                                  device="cuda")
            log(f"[kernels] K1R/K2R ragged chain, {label}: E{e} N{n} M{m} "
                f"L{layers} skips{skips} {dt}, {kind} counts {counts_host}")
            err = check_close(f"K1R {dt}", rc.ragged_chain_fwd(
                x, counts, ws, bs, skips), rc.ragged_chain_plain(
                    x, counts, ws, bs, skips))
            dirty_allocator()
            got = rc.ragged_chain_bwd(x, counts, ws, bs, g, skips)
            err_b = check_bwd(f"K2R {dt}", got, rc.ragged_chain_bwd_plain(
                x, counts, ws, bs, g, skips))
            empty = [i for i, c in enumerate(counts_host) if c == 0]
            if any(bool(got[1][:, i].any()) or bool(got[2][:, i].any())
                   for i in empty):
                raise AssertionError("K2R: an empty expert's dW or db is "
                                     "not 0")
            if empty:
                log(f"  K2R {dt}: dW and db of the empty experts {empty} "
                    "exactly 0 (outputs allocated over NaN bytes)")
            check_deterministic(f"K2R {dt}", lambda: rc.ragged_chain_bwd(
                x, counts, ws, bs, g, skips))
            del got
            if dtype == torch.float32 and kind == "skewed":
                f64 = f64_errors(x, counts, ws, bs, g, skips)
                log(f"  fp32 error against a float64 run (out, dx, dW, db; "
                    f"relative to its largest entry): kernels "
                    f"{['%.3e' % v for v in f64['kernel']]}, plain fp32 "
                    f"{['%.3e' % v for v in f64['plain']]}")
                if not all(k <= 4 * p for k, p in zip(f64["kernel"],
                                                      f64["plain"])):
                    raise AssertionError("the fp32 kernels' error against "
                                         "float64 exceeds 4x the plain "
                                         "chain's")

            bound_ms, bound_by = bounds["K1R"]
            t = {"ms": cuda_ms(lambda: rc.ragged_chain_fwd(
                    x, counts, ws, bs, skips), iters=20),
                 "plain_ms": cuda_ms(lambda: rc.ragged_chain_plain(
                     x, counts, ws, bs, skips), iters=10, warmup=3),
                 "library_ms": cuda_ms(lambda: addmm_ragged(
                     x, counts_host, ws, bs, skips), iters=10, warmup=3)}
            steps = device_ms_by_kernel(lambda: rc.ragged_chain_fwd(
                x, counts, ws, bs, skips), steps_fwd, iters=5)
            core = (f", CUDA-core bound {bounds['K1R cuda cores'][0]:.4f} ms"
                    if "K1R cuda cores" in bounds else "")
            log(f"  K1R {dt} {kind}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, addmm chain per expert "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}){core}, {rate(flops_f, t['ms'], bound_ms)}; "
                f"profiled {', '.join(f'{k} {v:.4f}' for k, v in steps.items())}"
                " ms")
            if kind == "skewed":
                rows[f"K1R {label}"] = dict(max_abs_err=err, bound_ms=bound_ms,
                                            bound_by=bound_by, **t)

            bound_ms, bound_by = bounds["K2R"]
            leaves = [t_.clone().requires_grad_() for t_ in (x, ws, bs)]
            lib_out = addmm_ragged(*leaves[:1], counts_host, *leaves[1:],
                                   skips)
            t = {"ms": cuda_ms(lambda: rc.ragged_chain_bwd(
                    x, counts, ws, bs, g, skips), iters=10),
                 "plain_ms": cuda_ms(lambda: rc.ragged_chain_bwd_plain(
                     x, counts, ws, bs, g, skips), iters=5, warmup=2),
                 "library_ms": cuda_ms(lambda: torch.autograd.grad(
                     lib_out, leaves, g, retain_graph=True), iters=10,
                     warmup=3)}
            del lib_out, leaves
            steps = device_ms_by_kernel(lambda: rc.ragged_chain_bwd(
                x, counts, ws, bs, g, skips), steps_bwd, iters=5)
            core = (f", CUDA-core bound {bounds['K2R cuda cores'][0]:.4f} ms"
                    if "K2R cuda cores" in bounds else "")
            log(f"  K2R {dt} {kind}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, autograd of the addmm chain "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}){core}, {rate(flops_b, t['ms'], bound_ms)} (the "
                f"gradient's products); profiled "
                f"{', '.join(f'{k} {v:.4f}' for k, v in steps.items())} ms")
            rows[f"K2R {label} {kind}"] = t
            if kind == "skewed":
                rows[f"K2R {label}"] = dict(max_abs_err=err_b,
                                            bound_ms=bound_ms,
                                            bound_by=bound_by, **t)
        ratio = (rows[f"K2R {label} skewed"]["ms"]
                 / rows[f"K2R {label} balanced"]["ms"])
        log(f"  K2R {dt}: skewed / balanced time {ratio:.3f}")
    return rows


def nodrop_padded_phase(shapes) -> None:
    """A no-drop MoE layer (K1R/K2R) against the padded one (K1/K2) with
    the same weights at capacity factor E, where padding drops nothing:
    outputs and every gradient agree (fp32 within 1e-5 of the largest
    entry: sums in another order; bf16 within the bf16 rule)."""
    from switch_nerf_torch.models.moe import MoELayer
    from switch_nerf_torch.ops import expert_kernel, ragged_chain

    m, layers, skips = shapes["width"], shapes["layers"], shapes["skips"]
    for dtype, e in ((torch.float32, shapes["bungee_e"]),
                     (torch.bfloat16, shapes["experts"])):
        dt = str(dtype)[6:]
        gen = torch.Generator().manual_seed(4)
        x0 = torch.randn(MOE_TOKENS, m, generator=gen).cuda()
        gy = torch.randn(MOE_TOKENS, m, generator=gen).to("cuda", dtype)
        outs, grads, launches = [], [], []
        for mode in ("padded", "nodrop"):
            layer = MoELayer(m, e, layer_num=layers, skips=skips,
                             capacity_factor=e, batch_prioritized_routing=True,
                             train_dispatch=mode, eval_dispatch=mode,
                             generator=torch.Generator().manual_seed(5)).cuda()
            x = x0.to(dtype).requires_grad_(True)
            expert_kernel.launches = expert_kernel.bwd_launches = 0
            ragged_chain.ragged_launches = ragged_chain.ragged_bwd_launches = 0
            y, _, _ = layer(x, train=True)
            grads.append(torch.autograd.grad(y, [x] + list(layer.parameters()),
                                             gy))
            outs.append(y.detach().float())
            launches.append((expert_kernel.launches,
                             expert_kernel.bwd_launches,
                             ragged_chain.ragged_launches,
                             ragged_chain.ragged_bwd_launches))
        torch.cuda.synchronize()
        if launches != [(1, 1, 0, 0), (0, 0, 1, 1)]:
            raise AssertionError(f"K1/K2, K1R/K2R launches {launches}")
        tol = 1e-5 if dtype == torch.float32 else BF16_REL_TOL
        worst = 0.0
        for a, b in [(outs[0], outs[1])] + list(zip(*grads)):
            a, b = a.float(), b.float()
            rel = (b - a).abs().max().item() / max(a.abs().max().item(), 1e-30)
            worst = max(worst, rel)
        log(f"[nodrop] MoE layer E{e} M{m} L{layers} {dt}, {MOE_TOKENS} "
            f"tokens at capacity factor {e}: no-drop (K1R/K2R) vs padded (K1/K2), "
            f"output and {len(grads[0])} gradients: largest error {worst:.3e} "
            f"of the largest entry (limit {tol:g})")
        if not worst <= tol:
            raise AssertionError("no-drop and padded MoE layers disagree")


def max_err_by_rows(out, ref, rows: int = 1 << 20) -> float:
    """max |out - ref| over row blocks (the [N, M] fp32 copies of a whole
    16.8M-row pair would not fit beside them)."""
    return max(float((out[lo:lo + rows].float() - ref[lo:lo + rows].float())
                     .abs().max()) for lo in range(0, out.shape[0], rows))


def k1r_at_rows(label: str, x, counts_host, ws, bs, skips, peaks) -> dict:
    """K1R over x's rows (sorted by expert, `counts_host` a expert) against
    its plain version on every row, the last 4,096 rows reported apart;
    then timed with CUDA events beside its bound, the plain version and
    the per-expert addmm chain."""
    from switch_nerf_torch.ops import ragged_chain as rc

    n, m = x.shape
    layers = ws.shape[0]
    counts = torch.tensor(counts_host, dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    out = rc.ragged_chain_fwd(x, counts, ws, bs, skips)
    ref = rc.ragged_chain_plain(x, counts, ws, bs, skips)
    err = max_err_by_rows(out, ref)
    tail = max_err_by_rows(out[-4096:], ref[-4096:])
    tol = BF16_REL_TOL * max(float(ref[lo:lo + (1 << 20)].float().abs()
                                   .max()) for lo in range(0, n, 1 << 20))
    log(f"  K1R {label}: max_abs_err {err:.3e}, last 4,096 rows {tail:.3e} "
        f"(tolerance {tol:.3e}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    if not (err <= tol and tail <= tol):
        raise AssertionError(f"K1R disagrees with its plain version at "
                             f"{label}")
    del out, ref
    flops = 2 * n * m * m * layers
    bound_ms, bound_by = chain_bound(flops, nbytes(x, ws, bs, counts)
                                     + nbytes(x), x.dtype, peaks)
    t = {"ms": cuda_ms(lambda: rc.ragged_chain_fwd(x, counts, ws, bs, skips),
                       iters=5, warmup=2),
         "plain_ms": cuda_ms(lambda: rc.ragged_chain_plain(
             x, counts, ws, bs, skips), iters=3, warmup=1),
         "library_ms": cuda_ms(lambda: addmm_ragged(
             x, counts_host, ws, bs, skips), iters=3, warmup=1)}
    log(f"  K1R {label}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
        f"ms, per-expert addmm chain {t['library_ms']:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {rate(flops, t['ms'], bound_ms)}")
    return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, n=n,
                **t)


def points_kernel_phase(peaks, shapes):
    """K1R's 64-bit row offsets, and K1 at the padded eval_points request's
    capacity. K1R in one launch over N = 65,536 x 256 = 16,777,216 rows
    (a published eval_points request's points; M256, so every activation
    holds 4.3e9 elements, past 2^31: the row offsets must be 64-bit),
    balanced counts, against its plain version over every row; K1 at C =
    262,144 (8,192 rays x 256 samples in one MoE call). Each timed beside
    its bound, the plain version and the library call. (eval_points' own
    K1R calls are held at their size and routing in phase 10.)"""
    from switch_nerf_torch.ops import expert_kernel

    e, m = shapes["experts"], shapes["width"]
    layers, skips = shapes["layers"], shapes["skips"]
    gen = torch.Generator().manual_seed(5)
    rows = {}
    n = POINTS_N
    ws, bs = chain_weights(e, m, layers, torch.bfloat16, gen)
    counts_host = [n // e] * e
    counts_host[-1] += n - sum(counts_host)
    x = torch.empty(n, m, dtype=torch.bfloat16, device="cuda")
    cg = torch.Generator(device="cuda").manual_seed(5)
    for lo in range(0, n, 1 << 22):
        x[lo:lo + (1 << 22)].normal_(generator=cg)
    log(f"[kernels 64-bit offsets] K1R bf16: N {n} rows (E{e} M{m} "
        f"L{layers} skips{skips}, {n * m} elements an activation)")
    rows["K1R 64-bit offsets"] = k1r_at_rows(f"N{n}", x, counts_host, ws, bs,
                                             skips, peaks)
    del x

    c = POINTS_PADDED_BATCH * 256 // e
    x = torch.randn(e, c, m, generator=gen).to("cuda", torch.bfloat16)
    log(f"[kernels eval_points] K1 bf16: E{e} C{c} M{m} L{layers}")
    err = check_close(f"K1 C{c}",
                      expert_kernel.expert_mlp_chain(x, ws, bs, skips),
                      expert_kernel.expert_mlp_chain_plain(x, ws, bs, skips))
    flops = 2 * e * c * m * m * layers
    bound_ms, bound_by = chain_bound(flops, nbytes(x, ws, bs) + nbytes(x),
                                     torch.bfloat16, peaks)
    t = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain(
             x, ws, bs, skips), iters=10, warmup=3),
         "plain_ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain_plain(
             x, ws, bs, skips), iters=5, warmup=2),
         "library_ms": cuda_ms(lambda: bmm_chain(x, ws, bs, skips), iters=5,
                               warmup=2)}
    log(f"  K1 C{c}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"baddbmm chain {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {rate(flops, t['ms'], bound_ms)}")
    rows["K1 eval_points"] = dict(max_abs_err=err, bound_ms=bound_ms,
                                  bound_by=bound_by, **t)
    del x
    torch.cuda.empty_cache()
    return rows


def make_bungee_scene(root, seed: int) -> None:
    """A synthetic Bungee-NeRF scene in `root`: poses_enu.json (scene scale
    1e-4, the earth's centre 6,371,011 m below the ENU origin) and
    BUNGEE_IMAGES smooth random PNGs of BUNGEE_W x BUNGEE_H under images/;
    the cameras hover 600-800 m up and look straight down."""
    from pathlib import Path

    from PIL import Image
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(BUNGEE_IMAGES):
        c2w = np.eye(3, 4)
        c2w[:, 3] = [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                     rng.uniform(0.06, 0.08)]
        hwf = np.array([[BUNGEE_H], [BUNGEE_W], [1.2 * BUNGEE_W]])
        poses.append(np.concatenate([c2w, hwf], 1).reshape(-1).tolist()
                     + [0.0, 1.0])
        coarse = rng.uniform(0, 255, (BUNGEE_H // 16, BUNGEE_W // 16, 3))
        Image.fromarray(coarse.astype(np.uint8)).resize(
            (BUNGEE_W, BUNGEE_H), Image.BICUBIC).save(
                root / "images" / f"{i:03d}.png")
    (root / "poses_enu.json").write_text(json.dumps({
        "poses": poses, "scene_scale": 1e-4,
        "scene_origin": [0.0, 0.0, -6371011.0],
        "scale_split": [BUNGEE_IMAGES]}))


def bungee_phase(counts: dict) -> str:
    """Train and serve the Bungee-NeRF mip workload end to end through its
    two entry points, with the README's flags at full width, on a
    synthetic scene: train_nerf_moe for one epoch (K1R/K2R every step, one
    interval checkpoint, finite metrics, a falling photo_loss), then
    eval_nerf_moe on its checkpoint (finite metrics, the file set)."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch import eval_nerf_moe, train_nerf_moe
    from switch_nerf_torch import runner as runner_mod
    from switch_nerf_torch.config import get_opts_nerf, parse_args
    from switch_nerf_torch.ops import expert_kernel, ragged_chain

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bungee_") as tmp:
        tmp = Path(tmp)
        make_bungee_scene(tmp / "scene", seed=0)
        h = parse_args(get_opts_nerf(), BUNGEE_FLAGS + [
            "--dataset_path", str(tmp / "scene"), "--exp_name",
            str(tmp / "exp"), "--num_epochs", "1", "--ckpt_interval",
            str(BUNGEE_CKPT), "--i_print", str(BUNGEE_PRINT)])
        sf = h.scale_factor * h.llff_factor
        per_image = (BUNGEE_W // sf) * (BUNGEE_H // sf)
        n_train = per_image * (BUNGEE_IMAGES - 2)
        steps = n_train // h.batch_size
        moe = h.model["layers"]["0"]

        def chunks_of(rays):      # model chunks of one request, both passes
            return (-(-rays * (h.coarse_samples - 1) // h.model_chunk_size)
                    + -(-rays * (h.fine_samples - 1) // h.model_chunk_size))
        chunks = chunks_of(h.batch_size)
        log(f"[bungee] train_nerf_moe on a synthetic scene: {BUNGEE_IMAGES} "
            f"{BUNGEE_W}x{BUNGEE_H} images / {sf} -> {n_train} train rays, "
            f"{steps} steps of {h.batch_size} rays, {h.moe_expert_num} experts"
            f" x {moe['num']} x {moe['out_ch']}, {h.coarse_samples} + "
            f"{h.fine_samples} samples, fp32, no-drop dispatch")
        rec = {"t_end": [], "photo": []}

        def make_step(real):
            def make(*a, **k):
                step = real(*a, **k)

                def run(state, batch):
                    state, met = step(state, batch)
                    rec["photo"].append(float(met["photo_loss"]))
                    rec["t_end"].append(time.perf_counter())
                    return state, met
                return run
            return make

        routed = []     # each chunk's expert counts, kept on the card

        def keep_counts(real):
            def run(x, cnt, *a, **k):
                routed.append(cnt.clone())
                return real(x, cnt, *a, **k)
            return run

        torch.cuda.reset_peak_memory_stats()
        with wrapped(runner_mod, "make_train_step", make_step), \
                wrapped(ragged_chain, "ragged_chain_fwd", keep_counts):
            expert_kernel.launches = expert_kernel.bwd_launches = 0
            ragged_chain.ragged_launches = ragged_chain.ragged_bwd_launches = 0
            t0 = time.perf_counter()
            state = train_nerf_moe.main(h)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts["K1R"] = ragged_chain.ragged_launches
            counts["K2R"] = ragged_chain.ragged_bwd_launches
            k1 = expert_kernel.launches
        peak = torch.cuda.max_memory_allocated()
        routed = torch.stack(routed).double()
        share = (routed.max(1).values / routed.sum(1)).cpu()
        skew = (f"largest expert's share of a chunk's rows over "
                f"{len(share)} chunks: min {share.min().item():.4f}, median "
                f"{share.median().item():.4f}, max {share.max().item():.4f}"
                f" (E{routed.shape[1]}; balanced {1 / routed.shape[1]:.4f})")
        log(f"  routing: {skew}")
        exp = tmp / "exp" / "0"
        log(f"  launches: K1R {counts['K1R']}, K2R {counts['K2R']} (expected "
            f"{chunks * steps} each, {chunks} a step), K1 {k1}")
        if not (state.step == steps and k1 == 0
                and counts["K1R"] == counts["K2R"] == chunks * steps):
            raise AssertionError("train_nerf_moe did not run K1R and K2R "
                                 "on every chunk of every step")
        windows = logged_windows(exp / "log.txt")
        saved = sorted(int(p.name) for p in (exp / "models").iterdir())
        want = sorted(set(range(BUNGEE_CKPT, steps + 1, BUNGEE_CKPT))
                      | {steps})
        # each step draws new rays: compare the first and last five steps
        first, last = (float(np.mean(rec["photo"][sl]))
                       for sl in (slice(0, 5), slice(-5, None)))
        log(f"  photo_loss per step {[round(v, 5) for v in rec['photo']]}: "
            f"mean of the first 5 {first:.5f}, of the last 5 {last:.5f}; "
            f"checkpoints {saved}")
        if not (all(np.isfinite(v) for w in windows for v in w.values())
                and len(windows) == steps // BUNGEE_PRINT
                and last < first and saved == want):
            raise AssertionError(f"Bungee training: {windows} {saved}")
        t = rec["t_end"]
        step_s = (t[-1] - t[BUNGEE_PRINT - 1]) / (steps - BUNGEE_PRINT)
        train_rays_s = h.batch_size / step_s

        he = parse_args(get_opts_nerf(), BUNGEE_FLAGS + [
            "--dataset_path", str(tmp / "scene"), "--exp_name",
            str(tmp / "eval"), "--ckpt_path", str(exp / "models" / str(steps)),
            "--image_pixel_batch_size", str(BUNGEE_EVAL_BATCH)])
        ragged_chain.ragged_launches = 0
        torch.cuda.reset_peak_memory_stats()
        means = eval_nerf_moe.main(he)
        eval_k1r = ragged_chain.ragged_launches
        out = tmp / "eval" / "0" / "test_images_0"
        metrics = [read_metrics(out / f"metrics_{i}.txt")
                   for i in (0, BUNGEE_IMAGES - 1)]
        bs = he.image_pixel_batch_size
        eval_chunks = 2 * -(-per_image // bs) * chunks_of(bs)
        log(f"  eval_nerf_moe: means {means}; K1R {eval_k1r} launches "
            f"(expected {eval_chunks}, {eval_chunks // 2} an image)")
        if not (all(np.isfinite(v) for m_ in metrics for v in m_.values())
                and eval_k1r == eval_chunks
                and "Average test/psnr" in (out / "metrics.txt").read_text()):
            raise AssertionError("Bungee eval: metrics or launches")
    return (f"train rays/s {train_rays_s:.1f} (steps {BUNGEE_PRINT + 1}-"
            f"{steps}), step {step_s:.4f} s, {steps} steps in {wall:.1f} s "
            f"wall, max_memory_allocated {peak} B ({peak / 2 ** 30:.2f} GiB);"
            f" K1R / K2R launches per step {counts['K1R'] // steps} / "
            f"{counts['K2R'] // steps}; {skew}; eval seconds per image "
            f"{[round(m_['time'], 4) for m_ in metrics]} ({per_image} rays an"
            f" image), psnr {means['psnr']:.4f}, ssim {means['ssim']:.4f}")


# --------------------------------------------- Block-NeRF Mission Bay ----
def make_block_scene(root, seed: int, w: int = MB_W, h: int = MB_H,
                     records=MB_RECORDS):
    """A synthetic Block-NeRF scene in `root`, written with the port's own
    tfrecord writer (no TensorFlow): GZIP records of tf.train.Example
    images (BGR PNGs of w x h: a sky above the horizon, a road below, and
    smooth random noise; 64-bit hashes, some negative) with per-pixel rays
    of cameras 1.5 m up looking down a street (+x),
    intrinsics and exposure, and on the "validation" records a moving-
    object mask (a patch of 1s in the right half). Also train.txt (every
    record: the validation images train on their left halves), val.txt
    and image_hash_id_map.json (a map per record file). Returns {"train":
    path, "val": path, "id_map": path, "val_images": n}."""
    from pathlib import Path

    from PIL import Image

    from switch_nerf_torch.datasets.tfrecord import encode_png, write_examples
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    focal = 1.2 * w
    v, u = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs = np.stack([np.ones_like(u), (u - w / 2) / focal,
                     -(v - h / 2) / focal], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    id_map, next_id, val_images = {}, 0, 0
    for name, n in records:
        is_val = "validation" in name
        examples, ids = [], {}
        for _ in range(n):
            image_hash = int(rng.integers(-2 ** 63, 2 ** 63 - 1))
            ids[str(image_hash)] = next_id
            next_id += 1
            coarse = rng.uniform(-40, 40, (h // 8, w // 8, 3)) + 128
            noise = np.asarray(Image.fromarray(coarse.astype(np.uint8)).resize(
                (w, h), Image.BICUBIC), np.float32) - 128
            base = np.where(dirs[..., 2:] > 0, [230.0, 180.0, 150.0],
                            [90.0, 90.0, 95.0])        # BGR sky / road
            bgr = np.clip(base + noise, 0, 255).astype(np.uint8)
            origin = np.array([rng.uniform(0, 20), rng.uniform(-2, 2), 1.5])
            feats = {
                "image_hash": ("int64", [image_hash]),
                "cam_idx": ("int64", [int(rng.integers(0, 12))]),
                "equivalent_exposure": ("float", [rng.uniform(0.5, 2.0)]),
                "height": ("int64", [h]),
                "width": ("int64", [w]),
                "image": ("bytes", [encode_png(bgr)]),
                "ray_origins": ("float", np.broadcast_to(
                    origin, (h, w, 3)).astype(np.float32)),
                "ray_dirs": ("float", dirs.astype(np.float32)),
                "intrinsics": ("float", [focal, focal, w / 2, h / 2]),
            }
            if is_val:
                mask = np.zeros((h, w), np.int64)
                mask[h // 4:h // 2, 3 * w // 4:] = 1
                feats["mask"] = ("int64", mask)
                val_images += 1
            examples.append(feats)
        write_examples(root / name, examples)
        id_map[name] = ids
    (root / "train.txt").write_text("".join(f"{n}\n" for n, _ in records))
    (root / "val.txt").write_text("".join(
        f"{n}\n" for n, _ in records if "validation" in n))
    (root / "image_hash_id_map.json").write_text(json.dumps(id_map))
    return {"train": root / "train.txt", "val": root / "val.txt",
            "id_map": root / "image_hash_id_map.json",
            "val_images": val_images}


def wide_kernel_phase(peaks, shapes):
    """The chain kernels at Mission Bay's width (M = 512, bf16: 64-row
    tiles, each consumer warpgroup on half the columns) against their plain
    versions at one 32,768-point model chunk, E8 L7 skips (3,): K1 and K2
    (padded dispatch, C = 4,096; K2 twice, bit-identical) and K1R (no-drop,
    skewed and balanced counts), timed beside the bound, the plain version
    and the library call; K3, K4 and K2R (skewed counts) at the same width
    checked and timed the same way (no path runs them at this width yet:
    K3/K4 with SWITCH_NERF_FUSED_DISPATCH=1, K2R in no-drop training).
    Returns the rows."""
    from switch_nerf_torch.ops import expert_kernel, fused_dispatch
    from switch_nerf_torch.ops import ragged_chain as rc

    e, m = shapes["experts"], shapes["width"]
    layers, skips, n = shapes["layers"], shapes["skips"], shapes["chunk"]
    c = n // e
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(9)
    rows = {}
    ws, bs = chain_weights(e, m, layers, dtype, gen)
    x = torch.randn(e, c, m, generator=gen).to("cuda", dtype)
    g = torch.randn(e, c, m, generator=gen).to("cuda", dtype)
    flops = 2 * e * c * m * m * layers
    log(f"[kernels M512] K1/K2 expert chain: E{e} C{c} M{m} L{layers} "
        f"skips{skips} bf16")
    err = check_close("K1 bf16 M512", expert_kernel.expert_mlp_chain(
        x, ws, bs, skips), expert_kernel.expert_mlp_chain_plain(x, ws, bs,
                                                                skips))
    bound_ms, bound_by = chain_bound(flops, nbytes(x, ws, bs) + nbytes(x),
                                     dtype, peaks)
    t = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain(
             x, ws, bs, skips)),
         "plain_ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain_plain(
             x, ws, bs, skips), iters=20),
         "library_ms": cuda_ms(lambda: bmm_chain(x, ws, bs, skips),
                               iters=20)}
    log(f"  K1 bf16 M512: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, baddbmm chain {t['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), "
        f"{rate(flops, t['ms'], bound_ms)}")
    rows["K1"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                      **t)

    err = check_bwd("K2 bf16 M512", expert_kernel.expert_mlp_chain_bwd(
        x, ws, bs, g, skips), expert_kernel.expert_mlp_chain_bwd_plain(
            x, ws, bs, g, skips))
    check_deterministic("K2 bf16 M512", lambda: expert_kernel
                        .expert_mlp_chain_bwd(x, ws, bs, g, skips))
    bound_ms, bound_by = chain_bound(
        2 * flops, nbytes(x, g, ws, bs) + nbytes(x)
        + 4 * (ws.numel() + bs.numel()), dtype, peaks)
    leaves = [t_.clone().requires_grad_() for t_ in (x, ws, bs)]
    lib_out = bmm_chain(*leaves, skips)
    t = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain_bwd(
             x, ws, bs, g, skips), iters=20),
         "plain_ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain_bwd_plain(
             x, ws, bs, g, skips), iters=10, warmup=3),
         "library_ms": autograd_ms(lib_out, leaves, g)}
    del lib_out, leaves
    passes = device_ms_by_kernel(
        lambda: expert_kernel.expert_mlp_chain_bwd(x, ws, bs, g, skips),
        {"pass 1": "chain_bwd_sm90", "pass 2": "chain_dw_sm90"})
    log(f"  K2 bf16 M512: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, autograd of the baddbmm chain "
        f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{rate(2 * flops, t['ms'], bound_ms)} (the gradient's products); "
        f"profiled pass 1 {passes['pass 1']:.4f} ms, pass 2 "
        f"{passes['pass 2']:.4f} ms; bwd_max_layers "
        f"{expert_kernel.bwd_max_layers(x.device, m, dtype)}")
    rows["K2"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                      **t)

    tokens_ext, stt, n_drop, n_empty = skewed_slot_map(n, e, m, dtype, gen)
    err = check_close(
        f"K3 bf16 M512 ({n_drop} dropped, {n_empty} empty slots)",
        fused_dispatch.fused_dispatch_chain_fwd(tokens_ext, stt, ws, bs,
                                                skips),
        fused_dispatch.fused_dispatch_chain_plain(tokens_ext, stt, ws, bs,
                                                  skips))
    stt_long = stt.long()
    bound_ms, bound_by = chain_bound(
        flops, nbytes(tokens_ext, stt, ws, bs)
        + e * c * m * tokens_ext.element_size(), dtype, peaks)
    t = {"ms": cuda_ms(lambda: fused_dispatch.fused_dispatch_chain_fwd(
             tokens_ext, stt, ws, bs, skips), iters=20),
         "plain_ms": cuda_ms(lambda: fused_dispatch.fused_dispatch_chain_plain(
             tokens_ext, stt, ws, bs, skips), iters=10, warmup=3),
         "library_ms": cuda_ms(lambda: bmm_chain(
             tokens_ext.index_select(0, stt_long).view(e, c, m), ws, bs,
             skips), iters=20)}
    log(f"  K3 bf16 M512: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, index_select + baddbmm chain "
        f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{rate(flops, t['ms'], bound_ms)}")
    rows["K3"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                      **t)

    err = check_bwd("K4 bf16 M512", fused_dispatch.fused_dispatch_chain_bwd(
        tokens_ext, stt, ws, bs, g, skips),
        fused_dispatch.fused_dispatch_chain_bwd_plain(tokens_ext, stt, ws,
                                                      bs, g, skips))
    kept_rows = int((stt < n).sum())            # the token rows read
    bound_ms, bound_by = chain_bound(
        2 * flops, kept_rows * m * tokens_ext.element_size()
        + nbytes(stt, g, ws, bs) + nbytes(g) + 4 * (ws.numel() + bs.numel()),
        dtype, peaks)
    leaves = [t_.clone().requires_grad_() for t_ in (
        tokens_ext.index_select(0, stt_long).view(e, c, m), ws, bs)]
    lib_out = bmm_chain(*leaves, skips)
    t = {"ms": cuda_ms(lambda: fused_dispatch.fused_dispatch_chain_bwd(
             tokens_ext, stt, ws, bs, g, skips), iters=20),
         "plain_ms": cuda_ms(lambda: fused_dispatch
                             .fused_dispatch_chain_bwd_plain(
                                 tokens_ext, stt, ws, bs, g, skips),
                             iters=10, warmup=3),
         "library_ms": autograd_ms(lib_out, leaves, g)}
    del lib_out, leaves, tokens_ext, stt, stt_long
    log(f"  K4 bf16 M512: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, autograd of index_select + baddbmm chain "
        f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{rate(2 * flops, t['ms'], bound_ms)}")
    rows["K4"] = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                      **t)

    xr = x.reshape(n, m)
    gr = g.reshape(n, m)
    for kind in ("skewed", "balanced"):
        counts_host = skewed_counts(n, e) if kind == "skewed" else [c] * e
        counts = torch.tensor(counts_host, dtype=torch.int32, device="cuda")
        log(f"[kernels M512] K1R ragged chain: E{e} N{n} M{m} L{layers} "
            f"bf16, {kind} counts {counts_host}")
        err = check_close(f"K1R bf16 M512 {kind}", rc.ragged_chain_fwd(
            xr, counts, ws, bs, skips), rc.ragged_chain_plain(
                xr, counts, ws, bs, skips))
        if kind == "skewed":
            dirty_allocator()
            err_b = check_bwd("K2R bf16 M512", rc.ragged_chain_bwd(
                xr, counts, ws, bs, gr, skips), rc.ragged_chain_bwd_plain(
                    xr, counts, ws, bs, gr, skips))
            bound_ms, bound_by = chain_bound(
                2 * flops, nbytes(xr, gr, ws, bs) + 4 * e + nbytes(xr)
                + 4 * (ws.numel() + bs.numel()), dtype, peaks)
            leaves = [t_.clone().requires_grad_() for t_ in (xr, ws, bs)]
            lib_out = addmm_ragged(leaves[0], counts_host, *leaves[1:],
                                   skips)
            t = {"ms": cuda_ms(lambda: rc.ragged_chain_bwd(
                     xr, counts, ws, bs, gr, skips), iters=10),
                 "plain_ms": cuda_ms(lambda: rc.ragged_chain_bwd_plain(
                     xr, counts, ws, bs, gr, skips), iters=5, warmup=2),
                 "library_ms": cuda_ms(lambda: torch.autograd.grad(
                     lib_out, leaves, gr, retain_graph=True), iters=10,
                     warmup=3)}
            del lib_out, leaves
            log(f"  K2R bf16 M512 skewed: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, autograd of the addmm chain "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {rate(2 * flops, t['ms'], bound_ms)}")
            rows["K2R"] = dict(max_abs_err=err_b, bound_ms=bound_ms,
                               bound_by=bound_by, **t)
        bound_ms, bound_by = chain_bound(
            flops, nbytes(xr, ws, bs) + 4 * e + nbytes(xr), dtype, peaks)
        t = {"ms": cuda_ms(lambda: rc.ragged_chain_fwd(
                 xr, counts, ws, bs, skips), iters=20),
             "plain_ms": cuda_ms(lambda: rc.ragged_chain_plain(
                 xr, counts, ws, bs, skips), iters=10, warmup=3),
             "library_ms": cuda_ms(lambda: addmm_ragged(
                 xr, counts_host, ws, bs, skips), iters=10, warmup=3)}
        log(f"  K1R bf16 M512 {kind}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, addmm chain per expert "
            f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {rate(flops, t['ms'], bound_ms)}")
        rows[f"K1R {kind}"] = dict(max_abs_err=err, bound_ms=bound_ms,
                                   bound_by=bound_by, **t)
    return rows


def mission_bay_phase(counts: dict) -> str:
    """Train and serve Block-NeRF Mission Bay end to end through its two
    entry points, with the README's flags at full width, on a synthetic
    scene: train.main for MB_STEPS steps (K1 and K2 on every model chunk
    of every step, an interval checkpoint, finite metrics, a falling
    photo_loss), a resume from the interval checkpoint that replays the
    batches and repeats the step's loss, then eval_image_blocknerf.main on
    the val records (K1R on every chunk: no --moe_test_batch, so no-drop
    dispatch; finite metrics, the JAX package's file set)."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch import eval_image_blocknerf
    from switch_nerf_torch.config import get_opts, parse_args
    from switch_nerf_torch.datasets.block_filesystem_dataset import \
        BlockFilesystemDataset
    from switch_nerf_torch.ops import expert_kernel, ragged_chain

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mission_bay_") as tmp:
        tmp = Path(tmp)
        scene = make_block_scene(tmp / "scene", seed=0)
        lists = ["--dataset_path", str(tmp / "scene"),
                 "--block_train_list_path", str(scene["train"]),
                 "--block_val_list_path", str(scene["val"]),
                 "--block_image_hash_id_map_path", str(scene["id_map"])]
        h = parse_args(get_opts(), MB_FLAGS + lists + [
            "--exp_name", str(tmp / "exp"), "--dataset_type", "filesystem",
            "--chunk_paths", str(tmp / "chunks"), "--num_chunks",
            str(MB_CHUNKS), "--train_iterations", str(MB_STEPS),
            "--ckpt_interval", str(MB_CKPT), "--i_print", str(MB_PRINT)])
        moe = h.model["layers"]["0"]

        def chunks_of(rays):      # model chunks of one request, both passes
            return (-(-rays * (h.coarse_samples - 1) // h.model_chunk_size)
                    + -(-rays * (h.fine_samples - 1) // h.model_chunk_size))
        chunks = chunks_of(h.batch_size)
        log(f"[mission_bay] train.main on a synthetic scene: "
            f"{sum(n for _, n in MB_RECORDS)} {MB_W}x{MB_H} images in "
            f"{len(MB_RECORDS)} GZIP tfrecords, {MB_CHUNKS} chunks, "
            f"{MB_STEPS} steps of {h.batch_size} rays, {h.moe_expert_num} "
            f"experts x {moe['num']} x {moe['out_ch']}, {h.coarse_samples} + "
            f"{h.fine_samples} samples, {'bf16' if h.amp else 'fp32'}, "
            f"appearance_dim {h.appearance_dim}")
        torch.cuda.reset_peak_memory_stats()
        ragged_chain.ragged_launches = ragged_chain.ragged_bwd_launches = 0
        first = run_training(h, BlockFilesystemDataset)
        k1r = ragged_chain.ragged_launches + ragged_chain.ragged_bwd_launches
        peak = torch.cuda.max_memory_allocated()
        counts["K1 Mission Bay"] = first["launches"]["K1"]
        counts["K2 Mission Bay"] = first["launches"]["K2"]
        exp = tmp / "exp" / "0"
        n = first["launches"]
        log(f"  launches: {n}, K1R/K2R {k1r} (expected K1, K2 "
            f"{chunks * MB_STEPS} each, {chunks} a step)")
        if not (first["step"] == MB_STEPS and k1r == 0
                and n["K1"] == n["K2"] == chunks * MB_STEPS
                and n["K3"] == n["K4"] == 0):
            raise AssertionError("Mission Bay training did not run K1 and K2 "
                                 "on every chunk of every step")
        windows = logged_windows(exp / "log.txt")
        saved = sorted(int(p.name) for p in (exp / "models").iterdir())
        loss = first["loss"]
        firsts, lasts = (float(np.mean(first["photo"][sl]))
                         for sl in (slice(0, 5), slice(-5, None)))
        log(f"  photo_loss per step {[round(v, 5) for v in first['photo']]}:"
            f" mean of the first 5 {firsts:.5f}, of the last 5 {lasts:.5f}; "
            f"checkpoints {saved}; chunk write {first['write_s'][0]:.2f} s")
        if not (len(windows) == MB_STEPS // MB_PRINT
                and all(np.isfinite(v) for w in windows for v in w.values())
                and lasts < firsts and saved == [MB_CKPT, MB_STEPS]):
            raise AssertionError(f"Mission Bay training: {windows} {saved}")

        resumed = copy.copy(h)
        resumed.exp_name = str(tmp / "resumed")
        resumed.ckpt_path = str(exp / "models" / str(MB_CKPT))
        second = run_training(resumed, BlockFilesystemDataset)
        same = second["digests"] == first["digests"][MB_CKPT:]
        rel = [abs(a - b) / abs(b) for a, b in
               zip(second["loss"], loss[MB_CKPT:])]
        log(f"  resumed from step {MB_CKPT}: {len(second['digests'])} "
            f"batches, hashes equal to the first run's {same}; loss relative"
            f" difference first step {rel[0]:.3e} (limit 1e-3), largest "
            f"{max(rel):.3e}")
        if not (same and second["step"] == MB_STEPS and rel[0] <= 1e-3):
            raise AssertionError("the resumed Mission Bay run does not "
                                 "replay the run")
        t = first["t_end"]
        step_s = (t[-1] - t[MB_PRINT - 1]) / (MB_STEPS - MB_PRINT)

        bs = MB_W * MB_H                  # one request an image
        he = parse_args(get_opts(), MB_FLAGS + lists + [
            "--exp_name", str(tmp / "eval"), "--ckpt_path",
            str(exp / "models" / str(MB_STEPS)),
            "--image_pixel_batch_size", str(bs)])
        expert_kernel.launches = ragged_chain.ragged_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        means = eval_image_blocknerf.main(he)
        eval_s = time.perf_counter() - t0
        counts["K1R Mission Bay"] = ragged_chain.ragged_launches
        eval_k1 = expert_kernel.launches
        eval_peak = torch.cuda.max_memory_allocated()
        base = tmp / "eval"
        hashes = sorted(p.name[len("metrics-"):-len(".json")]
                        for p in (base / "val_metrics").glob("*.json"))
        per_image = [json.loads((base / "val_metrics"
                                 / f"metrics-{k}.json").read_text())
                     for k in hashes]
        want_k1r = scene["val_images"] * chunks_of(bs)
        files_ok = all(
            (base / sub / name.format(k)).exists() for k in hashes
            for sub, name in (("val_images", "{}.jpg"),
                              ("images", "{}_gt.jpg"),
                              ("images", "{}_pred.jpg"),
                              ("images", "{}_depth.jpg"),
                              ("images", "metrics_{}.txt")))
        summary = (base / "0" / "metrics.txt").read_text()
        log(f"  eval_image_blocknerf: means {means}; K1R "
            f"{counts['K1R Mission Bay']} launches (expected {want_k1r}), K1 "
            f"{eval_k1}; images {hashes}")
        if not (len(hashes) == scene["val_images"] and files_ok
                and all(np.isfinite(v) for m_ in per_image
                        for v in m_.values())
                and {"psnr_mask", "ssim_mask"} <= set(per_image[0])
                and counts["K1R Mission Bay"] == want_k1r and eval_k1 == 0
                and "Average val/psnr_mask: " in summary):
            raise AssertionError("Mission Bay eval: metrics, files or "
                                 "launches")
    return (f"train rays/s {h.batch_size / step_s:.1f} (steps "
            f"{MB_PRINT + 1}-{MB_STEPS}), step {step_s:.4f} s, {MB_STEPS} "
            f"steps in {first['wall_s']:.1f} s wall (chunk write "
            f"{first['write_s'][0]:.2f} s), max_memory_allocated {peak} B "
            f"({peak / 2 ** 30:.2f} GiB); K1 / K2 launches per step "
            f"{counts['K1 Mission Bay'] // MB_STEPS} / "
            f"{counts['K2 Mission Bay'] // MB_STEPS}; resumed loss max rel "
            f"diff {max(rel):.3e}; eval {eval_s:.1f} s for "
            f"{len(hashes)} {MB_W}x{MB_H} images "
            f"({[round(m_['time'], 4) for m_ in per_image]} s render), "
            f"K1R {counts['K1R Mission Bay'] // len(hashes)} an image, "
            f"max_memory_allocated {eval_peak / 2 ** 30:.2f} GiB, psnr "
            f"{means['psnr']:.4f}, psnr_mask {means['psnr_mask']:.4f}")


# ------------------------------------------- serving what users have ----
def reference_state_dict(model, moe: bool, prefix: str = "") -> dict:
    """A port model's parameters under the reference (MiZhenxing/
    Switch-NeRF) names: the inverse of switch_nerf_torch.convert_torch_ckpt's
    map (``module.`` as `prefix` for a DDP save)."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if name == "embedding_a.weight":
            ref = name
        elif not moe:
            head, _, idx = parts[0].rpartition("_")
            if head == "xyz_encoding" and idx.isdigit():
                ref = f"xyz_encodings.{idx}.0.{parts[-1]}"
            elif parts[0] == "dir_a_encoding":
                ref = f"dir_a_encoding.0.{parts[-1]}"
            else:
                ref = name
        else:
            tag = parts[0][len("layer_"):]
            if len(parts) == 2:
                ref = f"layers.{tag}.{parts[1]}"          # a LayerNorm
            elif parts[1] == "wg":
                ref = f"layers.{tag}.gates.0.wg.weight"
            elif parts[1] == "experts":
                kind = "weights" if parts[2][0] == "w" else "bias"
                ref = f"layers.{tag}.experts.0.{kind}.{parts[2][1:]}"
            elif parts[1].startswith("fc"):
                ref = f"layers.{tag}.fcs.{parts[1][2:]}.{parts[2]}"
            elif parts[1].startswith("norm"):
                ref = f"layers.{tag}.norms.{parts[1][4:]}.{parts[2]}"
            else:
                raise KeyError(f"no reference name for {name}")
        out[prefix + ref] = p.detach().cpu().clone()
    return out


def flat_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def serving_hparams(tmp, exp: str, **over):
    """The eval phase's Building flags on make_scene's scene in `tmp`."""
    from switch_nerf_torch.profile_eval import building_eval_hparams
    h = building_eval_hparams()
    h.dataset_path = str(tmp / "scene")
    h.exp_name = str(tmp / exp)
    for k, v in over.items():
        setattr(h, k, v)
    return h


def write_reference_pt(tmp):
    """make_scene's scene in `tmp` and a reference-layout tmp/ref.pt of
    seeded Building weights (``module.`` prefix, the dense bg NeRF);
    returns the port's models it was written from."""
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
    make_scene(tmp / "scene", seed=0)
    count = SCENE_TRAIN + SCENE_VAL
    model = get_nerf(serving_hparams(tmp, "e"), count, device="cpu", seed=5)
    bg = get_bg_nerf(serving_hparams(tmp, "e"), count, device="cpu", seed=6)
    torch.save({"iteration": REF_ITERATION,
                "model_state_dict": reference_state_dict(model, True,
                                                         "module."),
                "bg_model_state_dict": reference_state_dict(bg, False)},
               tmp / "ref.pt")
    return model, bg


def points_hparams(tmp, exp: str, ckpt, images: int):
    """eval_points with the published flags: no-drop, 65,536-ray requests,
    every fourth sample written."""
    return serving_hparams(tmp, exp, ckpt_path=str(ckpt),
                           moe_test_batch=False,
                           render_test_points_image_num=images,
                           render_test_points_sample_skip=4,
                           image_pixel_batch_size=65536)


def points_unsplit() -> int:
    """``chip_smoke.py --points-unsplit``: one published eval_points request
    (65,536 rays x 256 samples, no-drop) in one model call of 16,777,216
    points instead of runner.POINTS_CALL_ROWS-point calls, on phase 10's
    converted checkpoint: its max_memory_allocated, or the out-of-memory
    error the card raises and the memory allocated then. Prints one JSON
    line. Not part of the one-card run."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch import convert_torch_ckpt
    from switch_nerf_torch import runner as trunner
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_unsplit_") as tmp:
        tmp = Path(tmp)
        write_reference_pt(tmp)
        ckpt = convert_torch_ckpt.main(serving_hparams(
            tmp, "conv", torch_ckpt=str(tmp / "ref.pt"),
            out_ckpt=str(tmp / "ckpt")))
        trunner.POINTS_CALL_ROWS = POINTS_N            # one call a request
        runner = trunner.Runner(points_hparams(tmp, "points", ckpt, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = {"points_a_call": POINTS_N, "card": smi,
               "total_bytes": torch.cuda.get_device_properties(0)
               .total_memory}
        try:
            runner.eval_points()
            torch.cuda.synchronize()
            res["fits"] = True
        except torch.cuda.OutOfMemoryError as exc:
            res["fits"] = False
            res["error"] = str(exc).splitlines()[0]
            res["allocated_at_error"] = torch.cuda.memory_allocated()
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[points unsplit] {res}")
    print(json.dumps({"points_unsplit": res}))
    return 0


def serving_phase(counts: dict) -> dict:
    """Serve what users already have: the checks of the module docstring's
    phase 10. Returns its numbers, and the routing and weights of
    eval_points' first K1R call under "k1r_inputs"."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch import _msgpack, bridge, convert_to_container_moe
    from switch_nerf_torch import runner as trunner
    from switch_nerf_torch.datasets.ray_utils import (get_ray_directions,
                                                      get_rays)
    from switch_nerf_torch.ops import expert_kernel
    from switch_nerf_torch.ops import ragged_chain as rc
    from switch_nerf_torch.utils.ply import read_ply_points

    Runner = trunner.Runner
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        tmp = Path(tmp)

        def hp(exp, **over):
            return serving_hparams(tmp, exp, **over)

        # a reference-layout .pt from seeded weights, converted by the CLI
        model, bg = write_reference_pt(tmp)
        log(f"[serving] a reference-layout .pt (module. prefix, the dense "
            f"bg NeRF, iteration {REF_ITERATION}) of the Building model, "
            f"converted by python -m switch_nerf_torch.convert_torch_ckpt")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m",
                        "switch_nerf_torch.convert_torch_ckpt",
                        *BUILDING_EVAL_FLAGS,
                        "--exp_name", str(tmp / "conv"),
                        "--dataset_path", str(tmp / "scene"),
                        "--torch_ckpt", str(tmp / "ref.pt"),
                        "--out_ckpt", str(tmp / "ckpt")], check=True,
                       timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        out["convert_s"] = time.perf_counter() - t0
        ckpt = tmp / "ckpt" / str(REF_ITERATION)
        got = dict(flat_leaves(_msgpack.unpackb(
            (ckpt / "state.msgpack").read_bytes())["params"]))
        want = dict(flat_leaves(bridge.export_jax_state(model, bg)))
        same = sorted(got) == sorted(want) and all(
            np.array_equal(got[k], want[k]) for k in want)
        log(f"  converted in {out['convert_s']:.2f} s (the CLI process, "
            f"start to end); {len(want)} leaves bit-equal to the .pt's "
            f"weights: {same}")
        if not same:
            raise AssertionError("the converted checkpoint differs from the "
                                 ".pt's weights")

        # eval_image on it (padded, K1)
        expert_kernel.launches = rc.ragged_launches = 0
        means = Runner(hp("eval", ckpt_path=str(ckpt))).eval_image()
        k1_served = expert_kernel.launches
        log(f"  eval_image: psnr {means['psnr']:.4f} ssim "
            f"{means['ssim']:.4f}, K1 {k1_served}")
        if not (all(np.isfinite(v) for v in means.values()) and k1_served):
            raise AssertionError("eval_image on the converted checkpoint")

        # eval_points with the published flags, no-drop dispatch (K1R)
        hpts = points_hparams(tmp, "points", ckpt, SCENE_VAL)
        calls, req_s, req_t0, first = [], [], [], {}

        def recorded(real):
            def run(x, counts_, ws, bs, skips):
                calls.append(x.shape[0])
                if not first:       # the first call's routing and weights
                    first.update(counts=counts_.clone(), ws=ws, bs=bs,
                                 skips=tuple(skips), dtype=x.dtype)
                return real(x, counts_, ws, bs, skips)
            return run

        def timed_program(real):
            def make(self, state):
                program = real(self, state)

                def run(batch):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    req_t0.append(t)
                    res = program(batch)
                    torch.cuda.synchronize()
                    req_s.append(time.perf_counter() - t)
                    return res
                return run
            return make

        with wrapped(rc, "ragged_chain_fwd", recorded), \
                wrapped(Runner, "_make_points_program", timed_program):
            runner = Runner(hpts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            expert_kernel.launches = rc.ragged_launches = 0
            t0 = time.perf_counter()
            written = runner.eval_points()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            out["points_s"] = t_end - t0
            # an image: its one request and its PLY writes
            out["image_s"] = [round(b - a, 4) for a, b in
                              zip(req_t0, req_t0[1:] + [t_end])]
            k1r, k1_pts = rc.ragged_launches, expert_kernel.launches
            out["points_peak_bytes"] = torch.cuda.max_memory_allocated()
        md = runner.val_items[0]
        n_rays = md.W * md.H
        n_pts = n_rays * len(range(0, hpts.coarse_samples, 4))
        per_call = trunner.POINTS_CALL_ROWS
        want_calls = SCENE_VAL * -(-POINTS_N // per_call)
        names = sorted(p.name for p in written)
        want_names = sorted(
            f"{i:03d}_coarse_pts_rgba{s}.ply" for i in range(SCENE_VAL)
            for s in [""] + [f"_top_0_exp_{e}" for e in range(8)])
        root = tmp / "points" / "0" / "eval_points"
        sizes = [read_ply_points(root / "0" / f"000_coarse_pts_rgba_top_0_"
                                 f"exp_{e}.ply")[0].shape[0] for e in range(8)]
        total = read_ply_points(root / "0" / "000_coarse_pts_rgba.ply")[0]
        first["counts"] = first["counts"].tolist()
        out.update(points_per_image=int(total.shape[0]), k1r=k1r,
                   rows_per_call=sorted(set(calls)), k1r_inputs=first,
                   request_s=[round(x, 4) for x in req_s],
                   expert_points=sizes)
        log(f"  eval_points (no-drop, --image_pixel_batch_size 65536, "
            f"--render_test_points_sample_skip 4, {SCENE_VAL} images): "
            f"{len(names)} PLY files, {total.shape[0]} points an image "
            f"(expected {n_pts}), per expert {sizes}; K1R launches {k1r} "
            f"(expected {want_calls}), rows a launch {sorted(set(calls))}, "
            f"the first call's rows an expert {first['counts']}, "
            f"K1 {k1_pts}; request seconds {out['request_s']}, seconds an "
            f"image with its PLY writes {out['image_s']}, "
            f"{out['points_s']:.2f} s in all; max_memory_allocated "
            f"{out['points_peak_bytes']} B")
        if not (names == want_names and total.shape[0] == n_pts
                and sum(sizes) == n_pts and sum(x > 0 for x in sizes) > 1
                and np.isfinite(total).all() and k1r == want_calls
                and calls == [per_call] * want_calls and k1_pts == 0):
            raise AssertionError("eval_points failed its checks")

        # its gates against a CPU run on the first rays of val image 0
        rays = get_rays(get_ray_directions(
            md.W, md.H, *md.intrinsics, hpts.center_pixels), md.c2w,
            runner.near, runner.far, runner.ray_altitude_range
        ).reshape(-1, 8)[:256]
        gates = []
        for dev, r in (("cuda", runner), ("cpu", Runner(
                hp("cpu", ckpt_path=str(ckpt), moe_test_batch=False),
                set_experiment_path=False, device="cpu"))):
            r._with_gate_returns()
            prog = r._make_points_program(r._load_eval_state())
            res = prog({"rays": torch.from_numpy(rays).to(dev),
                        "image_indices": torch.full(
                            (len(rays),), float(md.image_index), device=dev)})
            gates.append(res["moe_gates_coarse"].cpu().numpy())
        agree = float(np.mean(gates[0] == gates[1]))
        out["gate_agreement"] = agree
        log(f"  gates of {gates[0].size} points (256 rays of val image 0) "
            f"on the card against the CPU (bf16 both): {agree:.6f} equal "
            f"(limit 0.995)")
        if not agree >= 0.995:
            raise AssertionError("eval_points' gates differ from the CPU's")

        # eval_points with --moe_test_batch: one padded MoE call a request
        hpad = hp("points_padded", ckpt_path=str(ckpt), moe_test_batch=True,
                  render_test_points_image_num=1,
                  render_test_points_sample_skip=4,
                  image_pixel_batch_size=POINTS_PADDED_BATCH)
        runner = Runner(hpad)
        expert_kernel.launches = rc.ragged_launches = 0
        t0 = time.perf_counter()
        written = runner.eval_points()
        torch.cuda.synchronize()
        out["padded_s"] = time.perf_counter() - t0
        k1_pad, k1r_pad = expert_kernel.launches, rc.ragged_launches
        want_k1 = -(-n_rays // POINTS_PADDED_BATCH)
        total = read_ply_points(tmp / "points_padded" / "0" / "eval_points"
                                / "0" / "000_coarse_pts_rgba.ply")[0]
        log(f"  eval_points --moe_test_batch ({POINTS_PADDED_BATCH}-ray "
            f"requests, one image): {len(written)} files, "
            f"{total.shape[0]} points, K1 {k1_pad} (expected {want_k1}), "
            f"K1R {k1r_pad}, {out['padded_s']:.2f} s")
        if not (len(written) == 9 and total.shape[0] == n_pts
                and k1_pad == want_k1 and k1r_pad == 0):
            raise AssertionError("padded eval_points failed its checks")

        # eval_ckpt, a container round trip and --container_path eval
        state = Runner(hp("ckpt_eval", ckpt_path=str(ckpt)),
                       set_experiment_path=False).eval_ckpt()
        n_params = sum(p.numel() for p in state.parameters())
        want_n = sum(p.numel() for m in (model, bg) for p in m.parameters())
        convert_to_container_moe.main(hp("pack", ckpt_path=str(ckpt),
                                         container_out=str(tmp / "c")))
        expert_kernel.launches = 0
        means_c = Runner(hp("eval_c", container_path=str(tmp / "c"))
                         ).eval_image()
        k1_served += expert_kernel.launches
        d = max(abs(means_c[k] - means[k]) for k in ("psnr", "ssim"))
        log(f"  eval_ckpt: step {state.step}, {n_params} parameters "
            f"(expected {want_n}); container eval_image psnr "
            f"{means_c['psnr']:.4f} ssim {means_c['ssim']:.4f}, |d| against "
            f"the checkpoint's {d:.3e} (limit 1e-6)")
        if not (state.step == REF_ITERATION and n_params == want_n
                and d <= 1e-6):
            raise AssertionError("eval_ckpt or the container failed")
    counts["K1R eval_points"] = k1r
    counts["K1 eval_points padded"] = k1_pad
    counts["K1 serving"] = k1_served
    return out


def points_path_kernel(peaks, inputs) -> dict:
    """eval_points' K1R at the size and routing its path gave it: the rows
    an expert of the first no-drop call and the model's expert weights
    (serving_phase records them), on seeded inputs."""
    counts_host = inputs["counts"]
    n, m = sum(counts_host), inputs["ws"].shape[-1]
    x = torch.empty(n, m, dtype=inputs["dtype"], device="cuda")
    cg = torch.Generator(device="cuda").manual_seed(7)
    for lo in range(0, n, 1 << 22):
        x[lo:lo + (1 << 22)].normal_(generator=cg)
    log(f"[kernels eval_points] K1R {inputs['dtype']}: N {n} rows, rows an "
        f"expert {counts_host} (eval_points' first call), the model's "
        f"expert weights {tuple(inputs['ws'].shape)}")
    return k1r_at_rows(f"N{n} (eval_points' routing)", x, counts_host,
                       inputs["ws"], inputs["bs"], inputs["skips"], peaks)


def chunk_arithmetic() -> dict:
    """The published runs' model chunks at 8 ranks (32,768 points, the
    ranks' passes on JAX's global grid): chunks a rank and a pass, and how
    many span ranks (parallel/chunks.py)."""
    from switch_nerf_torch.parallel.chunks import RankGrid, plan
    passes = {"Building coarse": 1024 * 256, "Building fine": 1024 * 512,
              "Building bg coarse": 1024 * 128, "Building bg fine": 1024 * 256,
              "Mission Bay coarse / fine": 1664 * 512}
    out = {}
    for name, points in passes.items():
        cut = [plan(points, 32768, RankGrid(r, 8))[0] for r in range(8)]
        out[name] = {"points a rank": points, "chunks a rank": len(cut[0]),
                     "shared": sum(p.share is not None for c in cut
                                   for p in c)}
    log(f"[data_parallel] the published runs at 8 ranks, 32,768-point "
        f"chunks: {out}")
    if any(v["shared"] for v in out.values()):
        raise AssertionError("a published run shares a chunk across ranks")
    return out


# ------------------------------------------- data parallel: 2 ranks ----
DP_RANKS = 2
DP_BATCH = 2048               # global: 1,024 a rank, 8,192's share of a card
DP_STEPS, DP_SAVE = 10, 5     # the 2-rank run's schedule
DP_NCCL_STEPS = 5             # the one-rank NCCL run's


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_worker(spec_path: str) -> int:
    """One rank of the data-parallel phase (``chip_smoke.py --dp-worker
    SPEC``): join the group the spec names (gloo over tcp, several ranks on
    card 0; or NCCL through parallel.init_distributed from torchrun's
    variables), then train.main through run_training, a resume, the timed
    gradient all-reduce, the drop-free first step's averaged gradient and
    eval_image, as the spec asks; the results go to the spec's JSON file."""
    import pickle
    from pathlib import Path

    import torch.distributed as dist

    from switch_nerf_torch import eval_image, parallel
    from switch_nerf_torch.ops import expert_kernel, ragged_chain

    spec = pickle.loads(Path(spec_path).read_bytes())
    rank, world = spec["rank"], spec["world"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(spec.get("local_rank", 0)),
                      MASTER_ADDR="localhost", MASTER_PORT=str(spec["port"]))
    if spec["backend"] == "gloo":
        # several ranks on one card: NCCL refuses a card twice; gloo runs
        # all_reduce and broadcast on CUDA tensors, all the port needs
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{spec['port']}",
            rank=rank, world_size=world)
        device = "cuda:0"
    else:
        parallel.init_distributed(world_size=world)
        device = None
    out = {"rank": rank, "backend": dist.get_backend()}
    keys = ("loss", "photo", "finite", "t_end", "launches", "step", "wall_s",
            "hashes", "write_s", "digests", "exchange")
    rec = run_training(spec["train"], device=device)
    out["train"] = {k: rec[k] for k in keys}
    if "resume" in spec:
        out["resume"] = {k: v for k, v in run_training(
            spec["resume"], device=device).items() if k in keys}

    # the gradient all-reduce of the trainer: one flat fp32 buffer of the
    # parameters' size, timed alone
    buf = torch.ones(rec["n_params"], device="cuda")
    for _ in range(3):
        dist.all_reduce(buf)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["allreduce"] = {"bytes": buf.numel() * 4,
                        "ms": 1e3 * float(np.median(times))}
    del buf

    if "dropfree" in spec:
        hp = spec["dropfree"]
        state, step = dp_setup(hp, "cuda:0")
        share = DP_BATCH // world
        batch = {k: v[rank * share:(rank + 1) * share]
                 for k, v in dp_batch("cuda:0").items()}
        m, g = step.loss_and_grads(state, batch)
        m, g = step.average_across_ranks(m, g)
        out["dropfree_loss"] = float(m["all_loss"])
        if rank == 0:
            np.save(spec["grad_path"], flat(g).numpy())
        del state, step, g

    if "straddle" in spec:
        # the published routing with a model chunk that spans the ranks:
        # this rank's half of the fixed batch, its pieces routed with the
        # other rank's (parallel/chunks.py); the dropped tokens, the
        # averaged gradient, then the step's update. First the same step
        # with each piece routed alone (the per-rank routing JAX's global
        # routing replaced), to show the checks tell the two apart
        from switch_nerf_torch.models import moe as tmoe
        from switch_nerf_torch.parallel import chunks
        state, step = dp_setup(spec["straddle"], "cuda:0")
        share = DP_BATCH // world
        batch = {k: v[rank * share:(rank + 1) * share]
                 for k, v in dp_batch("cuda:0").items()}
        shared = []

        def tally(real):
            def plan(*a, **k):
                cut = real(*a, **k)
                shared.append(sum(p.share is not None for p in cut[0]))
                return cut
            return plan
        with drop_masks() as alone, wrapped(tmoe, "current_share",
                                            lambda real: lambda: None):
            m0, g0 = step.loss_and_grads(state, batch)
        m0, g0 = step.average_across_ranks(m0, g0)
        del g0
        with wrapped(chunks, "plan", tally):
            expert_kernel.launches = expert_kernel.bwd_launches = 0
            with drop_masks() as routed:
                m, g = step.loss_and_grads(state, batch)
            m, g = step.average_across_ranks(m, g)
            step_s = []
            for _ in range(2):          # the update, then one more step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m2 = step(state, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            launches = {"K1": expert_kernel.launches,
                        "K2": expert_kernel.bwd_launches}
        if rank == 0:
            np.save(spec["straddle_grad_path"], flat(g).numpy())
        for tag, masks in (("routed", routed), ("alone", alone)):
            np.save(f"{spec['straddle_drops']}_{tag}_{rank}.npy",
                    np.concatenate(masks))
        out["straddle"] = {"loss": float(m["all_loss"]),
                           "gate_loss": float(m["gate_loss"]),
                           "alone_loss": float(m0["all_loss"]),
                           "alone_gate_loss": float(m0["gate_loss"]),
                           "shared": shared, "launches": launches,
                           "hash": param_hash(state), "step_s": step_s,
                           "finite": float(m2["finite"])}
        del state, step, g

    if "ep_first" in spec:
        out["ep_first"] = ep_first_step(spec, rank, world)
    if "exchange" in spec:
        out["exchange"] = exchange_check()

    if "eval" in spec:
        ragged_chain.ragged_launches = expert_kernel.launches = 0
        t0 = time.perf_counter()
        means = eval_image.main(spec["eval"], device=device)
        out["eval"] = {"means": means, "s": time.perf_counter() - t0,
                       "K1R": ragged_chain.ragged_launches,
                       "K1": expert_kernel.launches}
    parallel.barrier("dp worker done")
    Path(spec["out"]).write_text(json.dumps(out))
    parallel.destroy()
    return 0


def dp_setup(hp, device):
    """A Building train state from seeds (as the train phase's) and its
    train step on `device`."""
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
    from switch_nerf_torch.profile_eval import SCENE
    from switch_nerf_torch.trainer import (create_train_state,
                                           make_train_step,
                                           render_config_from_hparams)
    state = create_train_state(
        hp, get_nerf(hp, 8, device=device, seed=0),
        get_bg_nerf(hp, 8, device=device, seed=1), device=device, seed=0)
    return state, make_train_step(hp, render_config_from_hparams(hp), SCENE,
                                  device=device)


def dp_batch(device) -> dict:
    from switch_nerf_torch.profile_eval import ray_batch
    return ray_batch(DP_BATCH, 0, device, rgbs=True)


def run_workers(specs, tmp, timeout: float = 900.0) -> list:
    """Start one ``--dp-worker`` process per spec, all at once; wait for
    every one (and kill them all if one hangs); their JSON results."""
    import pickle
    paths = []
    for i, spec in enumerate(specs):
        paths.append(tmp / f"spec_{spec['backend']}_{i}.pkl")
        paths[-1].write_bytes(pickle.dumps(spec))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-worker", str(p)]) for p in paths]
    try:
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"data-parallel workers exited "
                             f"{[p.returncode for p in procs]}")
    return [json.loads(open(s["out"]).read()) for s in specs]


def dp_train_hparams(tmp, batch: int, steps: int, save: int):
    """building_train_hparams on the chunked dataset of make_scene's scene
    in `tmp` (the train runner phase's settings), `batch` global rays."""
    from switch_nerf_torch.profile_eval import building_train_hparams
    h = building_train_hparams()
    h.dataset_path = str(tmp / "scene")
    h.exp_name = str(tmp / "exp")
    h.dataset_type = "filesystem"
    h.chunk_paths = [str(tmp / "chunks")]
    h.train_scale_factor = 4
    h.num_chunks = RUN_CHUNKS
    h.batch_size = batch
    h.train_iterations = steps
    h.ckpt_interval = save
    h.i_print = save
    h.val_interval = steps + 1
    return h


def scaling(cards: int) -> int:
    """``chip_smoke.py --dp-cards N``: the published Building training
    data-parallel over N cards of one host (NCCL, one process a card,
    1,024 rays a card) against one card, on the runner phase's scene: 20
    steps each, then eval_image (no-drop) over the N cards; then the same
    N-card training expert-parallel (--mesh_shape 1 N and 2 N/2), with
    the token exchange's form check, milliseconds and bytes. Prints seconds
    a step per rank, global train rays/s through Runner.train, the NCCL
    gradient all-reduce over N cards, the eval seconds; checks the ranks'
    parameter hashes, finite metrics and K1/K2 launches. Not part of the
    one-card run."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch.ops import _build
    from switch_nerf_torch.profile_eval import building_eval_hparams
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"[scaling] {cards} of {torch.cuda.device_count()} cards: {smi}")
    _build.build()
    steps, window = 20, 10
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scaling_") as tmp:
        tmp = Path(tmp)
        make_scene(tmp / "scene", seed=0)
        results = {}
        for n in (1, cards):
            h = dp_train_hparams(tmp, 1024 * n, steps, window)
            h.exp_name = str(tmp / f"exp{n}")
            if n == cards:
                ep_runs = {f"{d}x{cards // d}": ep_hparams(h, d, cards // d)
                           for d in (1, 2) if cards % (2 * d) == 0}
            he = building_eval_hparams()
            he.dataset_path = str(tmp / "scene")
            he.ckpt_path = str(tmp / f"exp{n}" / "0" / "models" / str(steps))
            he.moe_test_batch = False
            he.exp_name = str(tmp / f"eval{n}")
            port = free_port()
            t0 = time.perf_counter()
            outs = run_workers([{
                "rank": r, "world": n, "local_rank": r, "port": port,
                "backend": "nccl", "train": h, "eval": he,
                "out": str(tmp / f"scale{n}_{r}.json")} for r in range(n)],
                tmp)
            wall = time.perf_counter() - t0
            trains = [o["train"] for o in outs]
            step_s = [float(np.mean(np.diff(t["t_end"][window:])))
                      for t in trains]
            chunks = 24 * steps
            ok = (len({json.dumps(t["hashes"], sort_keys=True)
                       for t in trains}) == 1
                  and all(all(t["finite"]) and t["step"] == steps
                          and t["launches"]["K1"] == t["launches"]["K2"]
                          == chunks for t in trains)
                  and all(o["backend"] == "nccl" for o in outs))
            results[n] = {"step_s": step_s, "rays_per_s": 1024 * n
                          / max(step_s), "allreduce": [
                              o["allreduce"] for o in outs],
                          "eval_s": [o["eval"]["s"] for o in outs],
                          "psnr": outs[0]["eval"]["means"]["psnr"],
                          "wall_s": wall, "ok": ok}
            log(f"[scaling] {n} card(s): {results[n]} on {smi}")
            if not ok:
                raise AssertionError(f"{n}-card run failed its checks")
        for tag, he_ in ep_runs.items():
            he_.exp_name = str(tmp / f"ep{tag}")
            port = free_port()
            t0 = time.perf_counter()
            outs = run_workers([{
                "rank": r, "world": cards, "local_rank": r, "port": port,
                "backend": "nccl", "train": he_, "exchange": True,
                "out": str(tmp / f"ep{tag}_{r}.json")}
                for r in range(cards)], tmp)
            wall = time.perf_counter() - t0
            trains = [o["train"] for o in outs]
            step_s = [float(np.mean(np.diff(t["t_end"][window:])))
                      for t in trains]
            chunks = 24 * steps
            ok = (len({json.dumps(t["hashes"], sort_keys=True)
                       for t in trains}) == 1
                  and all(all(t["finite"]) and t["step"] == steps
                          and t["launches"]["K1"] == t["launches"]["K2"]
                          == chunks and t["exchange"]["exchanges"] > 0
                          for t in trains)
                  and all(o["backend"] == "nccl" and o["exchange"]["equal"]
                          for o in outs))
            results[f"ep {tag}"] = {
                "step_s": step_s, "rays_per_s": 1024 * cards / max(step_s),
                "exchange": [o["exchange"] for o in outs],
                "train_exchanges": [t["exchange"] for t in trains],
                "wall_s": wall, "ok": ok}
            log(f"[scaling] {cards} cards, --expert_parallel --mesh_shape "
                f"{tag.replace('x', ' ')}: {results[f'ep {tag}']} on {smi}")
            if not ok:
                raise AssertionError(f"the expert-parallel {tag} run failed "
                                     "its checks")
    log(f"[scaling] global train rays/s {results[1]['rays_per_s']:.1f} on "
        f"1 card, {results[cards]['rays_per_s']:.1f} on {cards} "
        f"({results[cards]['rays_per_s'] / results[1]['rays_per_s']:.3f}x)"
        + "".join(f"; expert-parallel {k[3:]} "
                  f"{v['rays_per_s']:.1f}" for k, v in results.items()
                  if str(k).startswith("ep ")))
    print(json.dumps({"scaling": results}))
    return 0


def data_parallel_phase(counts: dict) -> dict:
    """Train and serve Building data-parallel: the checks of the module
    docstring's phase 9. Returns its numbers."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch import eval_image
    from switch_nerf_torch.profile_eval import (building_eval_hparams,
                                                building_train_hparams)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        tmp = Path(tmp)
        make_scene(tmp / "scene", seed=0)
        h = dp_train_hparams(tmp, DP_BATCH, DP_STEPS, DP_SAVE)
        resumed = copy.copy(h)
        resumed.exp_name = str(tmp / "resumed")
        resumed.ckpt_path = str(tmp / "exp" / "0" / "models" / str(DP_SAVE))
        dropfree = building_train_hparams()
        dropfree.moe_capacity_factor = float(dropfree.moe_expert_num)
        dropfree.moe_l_aux_wt = 0.0
        dropfree.use_sigma_noise = False
        dropfree.perturb = 0.0
        straddle = building_train_hparams()     # the published routing
        straddle.use_sigma_noise = False
        straddle.perturb = 0.0
        straddle.model_chunk_size = STRADDLE_CHUNK
        he = building_eval_hparams()
        he.dataset_path = str(tmp / "scene")
        he.ckpt_path = str(tmp / "exp" / "0" / "models" / str(DP_STEPS))
        he.moe_test_batch = False          # no-drop eval: K1R
        he2, he1 = copy.copy(he), copy.copy(he)
        he2.exp_name, he1.exp_name = str(tmp / "eval2"), str(tmp / "eval1")
        per_rank = DP_BATCH // DP_RANKS
        chunks = (-(-per_rank * h.coarse_samples // h.model_chunk_size)
                  + -(-per_rank * h.fine_samples // h.model_chunk_size))
        log(f"[data_parallel] {DP_RANKS} ranks on one card over gloo: "
            f"train.main on the synthetic {SCENE_W}x{SCENE_H} scene, "
            f"{DP_STEPS} steps of {DP_BATCH} rays ({per_rank} a rank), a "
            f"save at {DP_SAVE} and a resume from it; the drop-free first "
            f"step; eval_image (no-drop)")
        torch.cuda.empty_cache()
        port = free_port()
        specs = [{"rank": r, "world": DP_RANKS, "port": port,
                  "backend": "gloo", "train": h, "resume": resumed,
                  "dropfree": dropfree, "eval": he2,
                  "grad_path": str(tmp / "grad.npy"),
                  "straddle": straddle,
                  "straddle_grad_path": str(tmp / "straddle_grad.npy"),
                  "straddle_drops": str(tmp / "drops"),
                  "out": str(tmp / f"rank{r}.json")}
                 for r in range(DP_RANKS)]
        t0 = time.perf_counter()
        outs = run_workers(specs, tmp)
        wall = time.perf_counter() - t0

        trains = [o["train"] for o in outs]
        n = [t["launches"] for t in trains]
        log(f"  launches per rank {n} (expected K1, K2 {chunks * DP_STEPS} "
            f"each: {chunks} a step at {per_rank} rays)")
        if not all(t["step"] == DP_STEPS and l["K1"] == l["K2"]
                   == chunks * DP_STEPS and l["K3"] == l["K4"] == 0
                   for t, l in zip(trains, n)):
            raise AssertionError("a rank did not run K1 and K2 on every "
                                 "chunk of every step")
        hashes = [t["hashes"] for t in trains]
        log(f"  parameter hashes at the saves, rank 0 {hashes[0]}, rank 1 "
            f"{hashes[1]}")
        if not (hashes[0] == hashes[1]
                and sorted(map(int, hashes[0])) == [DP_SAVE, DP_STEPS]):
            raise AssertionError("the ranks' parameters differ")
        if not all(all(t["finite"]) for t in trains):
            raise AssertionError("a non-finite metric in the 2-rank run")
        if trains[0]["digests"] == trains[1]["digests"]:
            raise AssertionError("the ranks trained on the same rays")
        rel = [[abs(a - b) / abs(b) for a, b in zip(
            o["resume"]["loss"], o["train"]["loss"][DP_SAVE:])]
            for o in outs]
        same = all(o["resume"]["digests"] == o["train"]["digests"][DP_SAVE:]
                   for o in outs)
        log(f"  resumed from step {DP_SAVE}: batches equal {same}; loss "
            f"relative difference per rank {[[f'{x:.2e}' for x in r_] for r_ in rel]}")
        if not (same and all(r_[0] <= 1e-3 for r_ in rel)
                and all(o["resume"]["hashes"].get(str(DP_STEPS))
                        for o in outs)):
            raise AssertionError("the 2-rank resume does not repeat the run")

        # the drop-free first step against one process on the whole batch
        state, step = dp_setup(dropfree, "cuda")
        m1, g1 = step.loss_and_grads(state, dp_batch("cuda"))
        l1, l2 = float(m1["all_loss"]), outs[0]["dropfree_loss"]
        cos = cosine(torch.from_numpy(np.load(tmp / "grad.npy")), flat(g1))
        del state, step, g1
        log(f"  drop-free first step: all_loss 2 ranks {l2:.6f}, 1 process "
            f"{l1:.6f} (relative {abs(l2 - l1) / abs(l1):.3e}, limit 1e-3); "
            f"averaged gradient cosine {cos:.6f} (limit 0.999)")
        if not (abs(l2 - l1) <= 1e-3 * abs(l1) and cos >= 0.999
                and outs[1]["dropfree_loss"] == l2):
            raise AssertionError("the 2-rank step disagrees with one "
                                 "process")

        # the published routing with a chunk that spans the ranks against
        # one process routing the whole batch
        st = [o["straddle"] for o in outs]
        state, step = dp_setup(straddle, "cuda")
        with drop_masks() as one:
            m1, g1 = step.loss_and_grads(state, dp_batch("cuda"))
        one = np.concatenate(one)
        sl1, sl2 = float(m1["all_loss"]), st[0]["loss"]
        gl1 = float(m1["gate_loss"])
        s_cos = cosine(torch.from_numpy(np.load(tmp / "straddle_grad.npy")),
                       flat(g1))
        del state, step, g1

        def global_drops(tag):
            # each rank's masks are its coarse pass then its fine pass; the
            # global batch's are rank 0's coarse, rank 1's, then the fine
            part = [np.load(f"{tmp / 'drops'}_{tag}_{r}.npy")
                    for r in range(DP_RANKS)]
            pc = per_rank * straddle.coarse_samples
            if any(x.size != per_rank * (straddle.coarse_samples
                                         + straddle.fine_samples)
                   for x in part):
                raise AssertionError("a rank routed another point count")
            return np.concatenate([x[:pc] for x in part]
                                  + [x[pc:] for x in part])
        routed, alone = global_drops("routed"), global_drops("alone")
        d_routed = int((routed != one).sum())
        d_alone = int((alone != one).sum())
        g_rel = abs(st[0]["gate_loss"] - gl1) / abs(gl1)
        g_alone = abs(st[0]["alone_gate_loss"] - gl1) / abs(gl1)
        log(f"  published routing, {STRADDLE_CHUNK}-point chunks: shared "
            f"chunks per pass and rank {[x['shared'] for x in st]}; dropped "
            f"tokens 1 process {int(one.sum())} of {one.size}, 2 ranks "
            f"{int(routed.sum())}, tokens whose drop differs {d_routed} "
            f"(limit 0); all_loss 2 ranks {sl2:.6f}, 1 process {sl1:.6f} "
            f"(relative {abs(sl2 - sl1) / abs(sl1):.3e}, limit 1e-3), "
            f"gate_loss 2 ranks {st[0]['gate_loss']:.9f}, 1 process "
            f"{gl1:.9f} (relative {g_rel:.3e}, limit 1e-5); averaged "
            f"gradient cosine {s_cos:.6f} (limit 0.999); K1, K2 per rank "
            f"{[x['launches'] for x in st]}; parameter hashes after two "
            f"steps {[x['hash'][:12] for x in st]}; seconds a step per rank "
            f"{[[round(t, 4) for t in x['step_s']] for x in st]}")
        log(f"  the same step with each rank's pieces routed alone: "
            f"dropped {int(alone.sum())}, tokens whose drop differs from "
            f"1 process {d_alone} (must be > 0), all_loss "
            f"{st[0]['alone_loss']:.6f}, gate_loss relative {g_alone:.3e}")
        if not (d_alone > 0 and one.sum() > 0):
            raise AssertionError("the drop check cannot tell per-rank "
                                 "routing from global routing")
        if not (abs(sl2 - sl1) <= 1e-3 * abs(sl1) and s_cos >= 0.999
                and d_routed == 0 and g_rel <= 1e-5
                and st[0]["hash"] == st[1]["hash"]
                and all(sum(x["shared"]) > 0 and x["finite"] == 1.0
                        and x["launches"]["K1"] > 0
                        and x["launches"]["K2"] > 0 for x in st)):
            raise AssertionError("the straddling 2-rank step disagrees with "
                                 "one process")

        # eval: the 2-rank files and means against one process's
        means1 = eval_image.main(he1)
        ev = [o["eval"] for o in outs]
        e2, e1 = tmp / "eval2" / "0", tmp / "eval1" / "0"
        files = [sorted(str(p.relative_to(d)) for p in d.rglob("*")
                        if p.is_file() and p.relative_to(d).parts[0] != "tb")
                 for d in (e2, e1)]
        d_means = {k: abs(ev[0]["means"][k] - means1[k])
                   for k in ("psnr", "ssim")}
        log(f"  eval_image: 2 ranks {ev[0]['means']}, K1R per rank "
            f"{[e['K1R'] for e in ev]}; 1 process {means1}; |d psnr| "
            f"{d_means['psnr']:.3e}, |d ssim| {d_means['ssim']:.3e} (limit "
            f"1e-4); same files {files[0] == files[1]}")
        if not (files[0] == files[1] and max(d_means.values()) <= 1e-4
                and all(e["K1R"] > 0 and e["K1"] == 0 for e in ev)
                and ev[0]["means"] == ev[1]["means"]):
            raise AssertionError("the 2-rank eval differs from one "
                                 "process's")

        # one rank with torchrun's variables: init_distributed takes NCCL
        hn = copy.copy(h)
        hn.exp_name = str(tmp / "nccl")
        hn.batch_size = per_rank
        hn.train_iterations = DP_NCCL_STEPS
        hn.ckpt_interval = DP_NCCL_STEPS
        (nccl,) = run_workers([{"rank": 0, "world": 1, "port": free_port(),
                                "backend": "nccl", "train": hn,
                                "out": str(tmp / "nccl.json")}], tmp)
        nt = nccl["train"]
        log(f"  one rank over {nccl['backend']}: {nt['step']} steps, "
            f"launches {nt['launches']}, all-reduce {nccl['allreduce']}")
        if not (nccl["backend"] == "nccl" and nt["step"] == DP_NCCL_STEPS
                and all(nt["finite"]) and nt["launches"]["K1"]
                == nt["launches"]["K2"] == chunks * DP_NCCL_STEPS):
            raise AssertionError("the NCCL run failed its checks")

    counts["K1 data-parallel"] = sum(l["K1"] for l in n)
    counts["K2 data-parallel"] = sum(l["K2"] for l in n)
    counts["K1R data-parallel"] = sum(e["K1R"] for e in ev)
    counts["K1 straddle"] = sum(x["launches"]["K1"] for x in st)
    counts["K2 straddle"] = sum(x["launches"]["K2"] for x in st)
    step_s = [float(np.mean(np.diff(t["t_end"][1:]))) for t in trains]
    return {"step_s": step_s, "rays_per_s": DP_BATCH / max(step_s),
            "allreduce": [o["allreduce"] for o in outs],
            "nccl_allreduce": nccl["allreduce"], "wall_s": wall,
            "write_s": [t["write_s"] for t in trains],
            "eval_s": [e["s"] for e in ev], "cosine": cos,
            "loss_rel": abs(l2 - l1) / abs(l1),
            "straddle": {"shared": [x["shared"] for x in st],
                         "loss_rel": abs(sl2 - sl1) / abs(sl1),
                         "gate_loss_rel": g_rel,
                         "dropped": int(one.sum()),
                         "drops_differ": d_routed,
                         "alone_drops_differ": d_alone,
                         "cosine": s_cos,
                         "step_s": [x["step_s"] for x in st]},
            "arithmetic": chunk_arithmetic()}


EP_E_LOCAL = (4, 2)           # a rank's experts: 8 over an axis of 2 or 4


def ep_kernel_phase(peaks, building) -> dict:
    """K1 and K2 at an expert-parallel rank's shapes: E_loc of the 8
    experts on [E_loc, E_axis x 4,096, 256] bf16 (the owner's rows of a
    32,768-point chunk from each member of its expert group), against
    their plain versions (K2 twice, bit-identical), timed against bound,
    plain and library as kernel_phase does."""
    from switch_nerf_torch.ops import expert_kernel

    m, layers, skips = building["width"], building["layers"], building["skips"]
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(12)
    rows = {}
    for e_loc in EP_E_LOCAL:
        c = building["experts"] // e_loc * (building["chunk"]
                                            // building["experts"])
        log(f"[kernels EP] E_loc {e_loc} of {building['experts']}: K1, K2 "
            f"at E{e_loc} C{c} M{m} L{layers} bf16")
        ws, bs = chain_weights(e_loc, m, layers, dtype, gen)
        x = torch.randn(e_loc, c, m, generator=gen).to("cuda", dtype)
        g = torch.randn(e_loc, c, m, generator=gen).to("cuda", dtype)
        err1 = check_close(f"K1 E{e_loc} C{c}",
                           expert_kernel.expert_mlp_chain(x, ws, bs, skips),
                           expert_kernel.expert_mlp_chain_plain(x, ws, bs,
                                                                skips))
        err2 = check_bwd(f"K2 E{e_loc} C{c}",
                         expert_kernel.expert_mlp_chain_bwd(x, ws, bs, g,
                                                            skips),
                         expert_kernel.expert_mlp_chain_bwd_plain(
                             x, ws, bs, g, skips))
        check_deterministic(f"K2 E{e_loc}", lambda: expert_kernel
                            .expert_mlp_chain_bwd(x, ws, bs, g, skips))
        flops = 2 * e_loc * c * m * m * layers
        bound_ms, bound_by = chain_bound(flops, nbytes(x, ws, bs) + nbytes(x),
                                         dtype, peaks)
        t = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain(
                 x, ws, bs, skips)),
             "plain_ms": cuda_ms(lambda: expert_kernel
                                 .expert_mlp_chain_plain(x, ws, bs, skips)),
             "library_ms": cuda_ms(lambda: bmm_chain(x, ws, bs, skips))}
        rows[f"K1 E{e_loc}"] = dict(max_abs_err=err1, bound_ms=bound_ms,
                                    bound_by=bound_by, e=e_loc, c=c, **t)
        bflops = 2 * flops
        out_bytes = nbytes(x) + 4 * (ws.numel() + bs.numel())
        b_ms, b_by = chain_bound(bflops, nbytes(x, g, ws, bs) + out_bytes,
                                 dtype, peaks)
        leaves = [t_.clone().requires_grad_() for t_ in (x, ws, bs)]
        lib_out = bmm_chain(*leaves, skips)
        t2 = {"ms": cuda_ms(lambda: expert_kernel.expert_mlp_chain_bwd(
                  x, ws, bs, g, skips), iters=20),
              "plain_ms": cuda_ms(lambda: expert_kernel
                                  .expert_mlp_chain_bwd_plain(
                                      x, ws, bs, g, skips), iters=20),
              "library_ms": autograd_ms(lib_out, leaves, g)}
        del lib_out
        passes = device_ms_by_kernel(
            lambda: expert_kernel.expert_mlp_chain_bwd(x, ws, bs, g, skips),
            {"pass 1": "chain_bwd_sm90", "pass 2": "chain_dw_sm90"})
        rows[f"K2 E{e_loc}"] = dict(max_abs_err=err2, bound_ms=b_ms,
                                    bound_by=b_by, e=e_loc, c=c, **t2)
        for key in (f"K1 E{e_loc}", f"K2 E{e_loc}"):
            r = rows[key]
            log(f"  {key} C{c}: kernel {r['ms']:.4f} ms "
                f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound), "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e}")
        log(f"  K2 E{e_loc} profiled pass 1 {passes['pass 1']:.4f} ms, "
            f"pass 2 (dW) {passes['pass 2']:.4f} ms")
    return rows


def orbax_phase(counts: dict) -> dict:
    """Serve the committed orbax fixture on the card: phase 11 of the
    module docstring. Returns its numbers."""
    import gzip
    import tempfile
    from pathlib import Path

    from switch_nerf_torch import bridge
    from switch_nerf_torch.checkpoints import load_checkpoint
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
    from switch_nerf_torch.ops import expert_kernel
    from switch_nerf_torch.profile_eval import SCENE, ray_batch
    from switch_nerf_torch.trainer import (create_train_state,
                                           make_eval_step,
                                           render_config_from_hparams)

    fx = Path(__file__).resolve().parent / "tests/data/orbax_ep_fixture"
    h = Namespace(**json.loads((fx / "hparams.json").read_text()))
    log(f"[orbax] {fx.name}: E{h.moe_expert_num} M"
        f"{h.model['layers']['0']['out_ch']}, written by JAX on mesh "
        f"{h.mesh_shape} (expert-sharded); served from orbax and from its "
        "msgpack twin")
    out, rgb, trees = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as tmp:
        twin = Path(tmp) / "3"
        twin.mkdir()
        (twin / "state.msgpack").write_bytes(gzip.decompress(
            (fx / "msgpack/3/state.msgpack.gz").read_bytes()))
        (twin / "extra.json").write_bytes((fx / "msgpack/3/extra.json")
                                          .read_bytes())
        batch = ray_batch(3072, 5, "cuda")
        for name, step_dir in (("orbax", fx / "orbax" / "3"),
                               ("msgpack", twin)):
            model = get_nerf(h, 8, device="cuda")
            bg = get_bg_nerf(h, 8, device="cuda")
            state = create_train_state(h, model, bg, device="cuda",
                                       for_training=False)
            t0 = time.perf_counter()
            load_checkpoint(step_dir, state, restore_rng_states=False)
            out[f"{name}_read_s"] = time.perf_counter() - t0
            trees[name] = bridge.export_jax_train_state(state, state.rng)
            step = make_eval_step(model, bg, h, render_config_from_hparams(h),
                                  SCENE, device="cuda")
            expert_kernel.launches = 0
            res = step(batch)
            torch.cuda.synchronize()
            counts[f"K1 orbax {name}"] = expert_kernel.launches
            rgb[name] = res["rgb_fine"].float().cpu()
            if name == "orbax":
                # K1 at the fixture's shape against its plain version
                ws, bs = model.layer_0.experts.stacked(torch.float32)
                gen = torch.Generator().manual_seed(3)
                x = torch.randn(ws.shape[1], 512, ws.shape[2],
                                generator=gen).to("cuda")
                skips = model.layer_0.experts.skips
                out["k1_err"] = check_close(
                    "K1 fixture shape",
                    expert_kernel.expert_mlp_chain(x, ws, bs, skips),
                    expert_kernel.expert_mlp_chain_plain(x, ws, bs, skips))
    same_tree = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for (pa, a), (pb, b) in zip(flat_leaves(trees["orbax"]),
                                                flat_leaves(trees["msgpack"]))
                    if pa == pb and pa != ("rng",)) and [
        p for p, _ in flat_leaves(trees["orbax"])] == [
        p for p, _ in flat_leaves(trees["msgpack"])]
    out.update(rgb_equal=bool(torch.equal(rgb["orbax"], rgb["msgpack"])),
               finite=bool(torch.isfinite(rgb["orbax"]).all()),
               shape=list(rgb["orbax"].shape), same_tree=bool(same_tree),
               k1=counts["K1 orbax orbax"])
    log(f"  read seconds orbax {out['orbax_read_s']:.3f}, msgpack "
        f"{out['msgpack_read_s']:.3f}; leaves equal {same_tree}; rgb "
        f"{out['shape']} equal {out['rgb_equal']}, finite {out['finite']}; "
        f"K1 launches {out['k1']}")
    if not (out["rgb_equal"] and out["finite"] and same_tree
            and out["shape"] == [3072, 3] and out["k1"] > 0):
        raise AssertionError("the orbax fixture does not serve as its "
                             "msgpack twin")
    return out


def ep_first_step(spec, rank: int, world: int) -> dict:
    """The drop-free first step under expert parallelism: this rank's
    half of the fixed batch; the averaged gradient with the experts'
    gathered whole (rank 0 saves it)."""
    from switch_nerf_torch import parallel
    from switch_nerf_torch.ops import expert_kernel
    from switch_nerf_torch.parallel import experts as ep_ops
    hp = spec["ep_first"]
    parallel.setup_mesh(hp, world, rank)
    state, step = dp_setup(hp, "cuda:0")
    share = DP_BATCH // world
    batch = {k: v[rank * share:(rank + 1) * share]
             for k, v in dp_batch("cuda:0").items()}
    expert_kernel.launches = expert_kernel.bwd_launches = 0
    m, g = step.loss_and_grads(state, batch)
    m, g = step.average_across_ranks(m, g, state)
    whole = [ep_ops.gather_whole([gi], p.expert_mesh)[0]
             if getattr(p, "expert_mesh", None) is not None else gi
             for p, gi in zip(state.parameters(), g)]
    if rank == 0:
        np.save(spec["ep_grad_path"], flat(whole).numpy())
    return {"loss": float(m["all_loss"]),
            "local_experts": [tuple(p.shape) for p in state.parameters()
                              if getattr(p, "expert_mesh", None)
                              is not None][:1],
            "launches": {"K1": expert_kernel.launches,
                         "K2": expert_kernel.bwd_launches}}


def exchange_check() -> dict:
    """The token exchange of the current expert-parallel mesh on a
    [8, 4,096, 256] bf16 dispatch buffer: the form the backend and device
    pick held bit-equal to the other form (gloo on CUDA tensors: the
    all_to_all on CPU copies; NCCL: the zero-filled all_reduce), then its
    milliseconds (median of 10) and the bytes a rank sends."""
    from switch_nerf_torch.parallel import experts as ep_ops
    from switch_nerf_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.current()
    gen = torch.Generator().manual_seed(mesh.rank)
    x = torch.randn(8, 4096, 256, generator=gen).to("cuda", torch.bfloat16)
    caps = [4096] * mesh.expert
    form = ep_ops.form(x)
    y = ep_ops._to_owners(x, mesh, caps)
    if form == "all_reduce":
        other, y2 = "all_to_all (CPU copies)", ep_ops._to_owners(
            x.cpu(), mesh, caps)
    else:
        other, y2 = "all_reduce", ep_ops._to_owners(x, mesh, caps,
                                                    how="all_reduce")
    equal = bool(torch.equal(y.cpu(), y2.cpu()))
    before = ep_ops.STATS["bytes"]
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep_ops._to_owners(x, mesh, caps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"form": form, "other": other, "equal": equal,
            "ms": 1e3 * float(np.median(times)),
            "bytes": (ep_ops.STATS["bytes"] - before) // 10}


def ep_hparams(h, d: int, e: int):
    """`h` under expert parallelism on a (d, e) mesh."""
    h = copy.copy(h)
    h.no_expert_parallel = False
    h.mesh_shape = [d, e]
    return h


def expert_parallel_phase(counts: dict) -> dict:
    """Train Building expert-parallel on the card: phase 12 of the module
    docstring (the 2 gloo ranks). Returns its numbers."""
    import tempfile
    from pathlib import Path

    from switch_nerf_torch.profile_eval import building_train_hparams

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        tmp = Path(tmp)
        make_scene(tmp / "scene", seed=0)
        h = ep_hparams(dp_train_hparams(tmp, DP_BATCH, DP_STEPS, DP_SAVE),
                       1, DP_RANKS)
        resumed = copy.copy(h)
        resumed.exp_name = str(tmp / "resumed")
        resumed.ckpt_path = str(tmp / "exp" / "0" / "models" / str(DP_SAVE))
        dropfree = building_train_hparams()
        dropfree.moe_capacity_factor = float(dropfree.moe_expert_num)
        dropfree.moe_l_aux_wt = 0.0
        dropfree.use_sigma_noise = False
        dropfree.perturb = 0.0
        per_rank = DP_BATCH // DP_RANKS
        chunks = (-(-per_rank * h.coarse_samples // h.model_chunk_size)
                  + -(-per_rank * h.fine_samples // h.model_chunk_size))
        log(f"[expert_parallel] {DP_RANKS} ranks on one card over gloo, "
            f"--expert_parallel --mesh_shape 1 {DP_RANKS}: train.main on the"
            f" synthetic scene, {DP_STEPS} steps of {DP_BATCH} rays, a save "
            f"at {DP_SAVE} and a resume from it; the drop-free first step; "
            "the token exchange")
        torch.cuda.empty_cache()
        port = free_port()
        specs = [{"rank": r, "world": DP_RANKS, "port": port,
                  "backend": "gloo", "train": h, "resume": resumed,
                  "ep_first": ep_hparams(dropfree, 1, DP_RANKS),
                  "ep_grad_path": str(tmp / "ep_grad.npy"),
                  "exchange": True, "out": str(tmp / f"ep{r}.json")}
                 for r in range(DP_RANKS)]
        t0 = time.perf_counter()
        outs = run_workers(specs, tmp)
        wall = time.perf_counter() - t0
        trains = [o["train"] for o in outs]
        n = [t["launches"] for t in trains]
        hashes = [t["hashes"] for t in trains]
        log(f"  launches per rank {n} (expected K1, K2 {chunks * DP_STEPS} "
            f"each); exchanges per rank "
            f"{[t['exchange'] for t in trains]}; non-expert parameter "
            f"hashes at the saves {hashes}")
        if not all(t["step"] == DP_STEPS and l["K1"] == l["K2"]
                   == chunks * DP_STEPS and l["K3"] == l["K4"] == 0
                   and t["exchange"]["exchanges"] > 0
                   for t, l in zip(trains, n)):
            raise AssertionError("an expert-parallel rank did not run K1 "
                                 "and K2 on every chunk of every step")
        if not (hashes[0] == hashes[1]
                and sorted(map(int, hashes[0])) == [DP_SAVE, DP_STEPS]
                and all(all(t["finite"]) for t in trains)):
            raise AssertionError("the ranks' replicated parameters differ "
                                 "or a metric is not finite")
        rel = [[abs(a - b) / abs(b) for a, b in zip(
            o["resume"]["loss"], o["train"]["loss"][DP_SAVE:])]
            for o in outs]
        if not all(r_[0] <= 1e-3 and o["resume"]["digests"]
                   == o["train"]["digests"][DP_SAVE:]
                   for r_, o in zip(rel, outs)):
            raise AssertionError("the expert-parallel resume does not "
                                 "repeat the run")
        state, step = dp_setup(dropfree, "cuda")
        m1, g1 = step.loss_and_grads(state, dp_batch("cuda"))
        l1, l2 = float(m1["all_loss"]), outs[0]["ep_first"]["loss"]
        cos = cosine(torch.from_numpy(np.load(tmp / "ep_grad.npy")),
                     flat(g1))
        del state, step, g1
        ex = [o["exchange"] for o in outs]
        log(f"  drop-free first step: all_loss 2 ranks {l2:.6f}, 1 process "
            f"{l1:.6f} (relative {abs(l2 - l1) / abs(l1):.3e}, limit 1e-3);"
            f" averaged gradient (experts gathered) cosine {cos:.6f} (limit "
            f"0.999); local experts {outs[0]['ep_first']['local_experts']}; "
            f"exchange {ex}; resume loss relative "
            f"{[[f'{x:.2e}' for x in r_] for r_ in rel]}")
        if not (abs(l2 - l1) <= 1e-3 * abs(l1) and cos >= 0.999
                and outs[1]["ep_first"]["loss"] == l2
                and all(e["equal"] for e in ex)):
            raise AssertionError("the expert-parallel step disagrees with "
                                 "one process, or the exchange forms differ")
    counts["K1 expert-parallel"] = sum(l["K1"] for l in n)
    counts["K2 expert-parallel"] = sum(l["K2"] for l in n)
    step_s = [float(np.mean(np.diff(t["t_end"][1:]))) for t in trains]
    return {"step_s": step_s, "rays_per_s": DP_BATCH / max(step_s),
            "exchange": ex, "train_exchanges": [t["exchange"]
                                                for t in trains],
            "loss_rel": abs(l2 - l1) / abs(l1), "cosine": cos,
            "wall_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--dp-cards"]:
        return scaling(int(sys.argv[2]))
    if sys.argv[1:2] == ["--points-unsplit"]:
        from switch_nerf_torch.ops import _build
        _build.build()
        return points_unsplit()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    peaks = card_peaks(name)

    from switch_nerf_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per source "
        f"{ {k: round(v, 1) for k, v in built.items()} }")
    build_report()

    from switch_nerf_torch.profile_eval import building_eval_hparams
    h = building_eval_hparams()
    moe = h.model["layers"]["0"]
    building = {"experts": h.moe_expert_num, "width": moe["out_ch"],
                "layers": moe["num"], "skips": tuple(moe["skips"]),
                "chunk": h.model_chunk_size}
    rows = kernel_phase(peaks, building)
    rows.update(bwd_kernel_phase(peaks, building))
    building["bungee_e"] = 4            # bungee.yaml with --moe_expert_num 4
    rows.update(ragged_kernel_phase(peaks, building))
    wide = wide_kernel_phase(peaks, {**building, "width": 512})
    pts_rows = points_kernel_phase(peaks, building)
    ep_rows = ep_kernel_phase(peaks, building)
    nodrop_padded_phase(building)
    eval_counts = {}
    rays_per_s = slice_phase(h, eval_counts)
    log(f"[slice] eval launches per {N_REQUESTS} requests: {eval_counts}")
    counts = {}                   # the train path's (main path's) launches
    train = train_phase(counts)
    runner = runner_phase()
    train_runner = train_runner_phase(train["rays_per_s"])
    bungee = bungee_phase(counts)
    mission_bay = mission_bay_phase(counts)
    serving = serving_phase(counts)
    pts_rows["K1R eval_points"] = points_path_kernel(
        peaks, serving.pop("k1r_inputs"))
    dp = data_parallel_phase(counts)
    orbax = orbax_phase(counts)
    ep = expert_parallel_phase(counts)

    meta = {
        "K1": ("expert_chain", "switch_nerf_torch/csrc/expert_chain.cu",
               "switch_nerf_tpu/ops/expert_kernel.py:132"),
        "K2": ("expert_chain_bwd",
               "switch_nerf_torch/csrc/expert_chain_bwd.cu",
               "switch_nerf_tpu/ops/expert_kernel.py:155"),
        "K3": ("fused_dispatch", "switch_nerf_torch/csrc/fused_dispatch.cu",
               "switch_nerf_tpu/ops/fused_dispatch.py:179"),
        "K4": ("fused_dispatch_bwd",
               "switch_nerf_torch/csrc/fused_dispatch_bwd.cu",
               "switch_nerf_tpu/ops/fused_dispatch.py:210"),
        # no Pallas counterpart: JAX's ExpertMLP.ragged runs
        # jax.lax.ragged_dot, whose autograd K2R replaces
        "K1R": ("ragged_chain", "switch_nerf_torch/csrc/ragged_chain.cu",
                "switch_nerf_tpu/models/experts.py:79"),
        "K2R": ("ragged_chain_bwd",
                "switch_nerf_torch/csrc/ragged_chain_bwd.cu",
                "switch_nerf_tpu/models/experts.py:79"),
    }
    kernels = []
    for key, (kname, source, replaces) in meta.items():
        # K1R / K2R: the Bungee training path's shape (fp32, E4); K1 also
        # serves the converted checkpoint and its container (phase 10) at
        # the same shape
        r = rows[key + " Bungee" if key.endswith("R") else key]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[key] + counts.get(f"{key} serving", 0)
            + counts.get(f"{key} orbax orbax", 0)
            + counts.get(f"{key} orbax msgpack", 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the Mission Bay path's kernels at M = 512 (its run's launches: K1 and
    # K2 training, K1R serving)
    for key, row, (kname, source, replaces) in (
            ("K1", "K1", meta["K1"]), ("K2", "K2", meta["K2"]),
            ("K1R", "K1R skewed", meta["K1R"])):
        r = wide[row]
        kernels.append({
            "name": f"{kname} (M512, Mission Bay)", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": counts[f"{key} Mission Bay"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the data-parallel path's kernels at Building's shapes (every rank's
    # launches: K1 and K2 training, with the step whose chunks span the
    # ranks, and K1R serving); the times are the kernel phase's at the same
    # shapes
    for key, row, extra in (("K1", "K1", "K1 straddle"),
                            ("K2", "K2", "K2 straddle"),
                            ("K1R", "K1R Building", None)):
        kname, source, replaces = meta[key]
        r = rows[row]
        kernels.append({
            "name": f"{kname} (data-parallel, {DP_RANKS} ranks)",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[f"{key} data-parallel"]
            + (counts[extra] if extra else 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the expert-parallel path's K1 and K2 (phase 12): a rank's experts
    # (E_loc 4 of 8) on its expert group's rows, C 8,192
    e_loc = EP_E_LOCAL[0]
    for key in ("K1", "K2"):
        kname, source, replaces = meta[key]
        r = ep_rows[f"{key} E{e_loc}"]
        kernels.append({
            "name": f"{kname} (expert-parallel, E_loc {e_loc}, C {r['c']:,})",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[f"{key} expert-parallel"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # eval_points (phase 10): K1R (no-drop) held and timed at its first
    # call's rows and routing, K1 (--moe_test_batch) at its capacity
    for key, row, count_key in (
            ("K1R", "K1R eval_points", "K1R eval_points"),
            ("K1", "K1 eval_points", "K1 eval_points padded")):
        kname, source, replaces = meta[key]
        r = pts_rows[row]
        label = (f"eval_points, N={r['n']:,} a call" if key == "K1R"
                 else "eval_points --moe_test_batch, C=262,144")
        kernels.append({
            "name": f"{kname} ({label})", "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[count_key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[slice] eval rays/s {rays_per_s:.1f} on {smi}")
    log(f"[train] train rays/s {train['rays_per_s']:.1f}, step "
        f"{train['step_s']:.4f} s, max_memory_allocated "
        f"{train['peak_bytes']} B on {smi}")
    log(f"[runner] {runner} on {smi}")
    log(f"[train_runner] {train_runner} on {smi}")
    log(f"[bungee] {bungee} on {smi}")
    log(f"[mission_bay] {mission_bay} on {smi}")
    ar = dp["allreduce"][0]
    log(f"[data_parallel] {DP_RANKS} ranks on one card over gloo: seconds a "
        f"step per rank {[round(x, 4) for x in dp['step_s']]}, train rays/s "
        f"through Runner.train {dp['rays_per_s']:.1f} (global, {DP_BATCH} a "
        f"step); gradient all-reduce {ar['ms']:.3f} ms for {ar['bytes']} B "
        f"(gloo, ranks {[round(a['ms'], 3) for a in dp['allreduce']]}), one "
        f"rank over NCCL {dp['nccl_allreduce']['ms']:.3f} ms; chunk write "
        f"seconds {dp['write_s']}; eval seconds per rank "
        f"{[round(x, 2) for x in dp['eval_s']]}; drop-free first step "
        f"all_loss relative {dp['loss_rel']:.3e}, gradient cosine "
        f"{dp['cosine']:.6f}; phase {dp['wall_s']:.1f} s wall for the 2-rank"
        f" workers, on {smi}")
    log(f"[serving] converter {serving['convert_s']:.2f} s; eval_points "
        f"{serving['points_per_image']} points an image, request seconds "
        f"{serving['request_s']} ({POINTS_N} points, 65,536 rays a request; "
        f"rays/s {[round(65536 / x, 1) for x in serving['request_s']]}), "
        f"seconds an image with its PLY writes {serving['image_s']}, "
        f"{serving['points_s']:.2f} s for {SCENE_VAL} images with the "
        f"checkpoint load, max_memory_allocated "
        f"{serving['points_peak_bytes']} B, "
        f"K1R {serving['k1r']} launches of {serving['rows_per_call']} rows; "
        f"gates equal to the CPU's {serving['gate_agreement']:.6f}; padded "
        f"eval_points {serving['padded_s']:.2f} s, on {smi}")
    log(f"[orbax] fixture read seconds orbax {orbax['orbax_read_s']:.3f},"
        f" msgpack twin {orbax['msgpack_read_s']:.3f}; served rgb equal "
        f"{orbax['rgb_equal']}, on {smi}")
    log(f"[expert_parallel] {DP_RANKS} ranks on one card over gloo, mesh "
        f"(1, {DP_RANKS}): seconds a step per rank "
        f"{[round(x, 4) for x in ep['step_s']]}, train rays/s through "
        f"Runner.train {ep['rays_per_s']:.1f} (global, {DP_BATCH} a step; "
        f"pure data parallel {dp['rays_per_s']:.1f}); exchange of an "
        f"[8, 4096, 256] bf16 buffer {[round(x['ms'], 3) for x in ep['exchange']]}"
        f" ms, {ep['exchange'][0]['bytes']} B a rank, form "
        f"{ep['exchange'][0]['form']} (equal to {ep['exchange'][0]['other']}"
        f": {ep['exchange'][0]['equal']}); exchanges in the run "
        f"{ep['train_exchanges']}; drop-free first step all_loss relative "
        f"{ep['loss_rel']:.3e}, cosine {ep['cosine']:.6f}; phase "
        f"{ep['wall_s']:.1f} s wall, on {smi}")
    for key, r in ep_rows.items():
        log(f"[kernels EP] {key} C{r['c']} (bf16): {r['ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e} on {smi}")
    log(f"[data_parallel] straddling chunk: {dp['straddle']}; published "
        f"runs at 8 ranks: {dp['arithmetic']}")
    for key in ("K1R eval_points", "K1R 64-bit offsets", "K1 eval_points"):
        r = pts_rows[key]
        log(f"[kernels eval_points] {key} (bf16): {r['ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e} on {smi}")
    for key in ("K1R Building", "K2R Building"):
        r = rows[key]
        log(f"[kernels] {key} (bf16): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e} on {smi}")
    for key, r in wide.items():
        log(f"[kernels M512] {key} (bf16): {r['ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e} on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    # the script drives one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
