"""Where one full-width Building eval request, one Building train step or
one Mission Bay train step spends its time on the card.

    python -m switch_nerf_torch.profile_eval [--rays 4096] [--trace DIR]
    python -m switch_nerf_torch.profile_eval --train [--rays 1024]
    python -m switch_nerf_torch.profile_eval --mission_bay [--rays 1664]
    python -m switch_nerf_torch.profile_eval --state_bytes
    python -m switch_nerf_torch.profile_eval --embedding

Defines the Building workloads that this script and chip_smoke.py drive
(building.yaml + the production flags, bf16, bg NeRF, 256 + 512 samples,
32768-point chunks, seeded random weights, rays from inside the unit
sphere): the eval request (padded eval dispatch) and the train step (the
published training recipe: padded train dispatch, sigma noise, l_aux
weight 5e-4, perturb 1.0, Adam). With --mission_bay, the Block-NeRF
Mission Bay train step (mission_bay.yaml + the README's flags: 8 experts x
7 x 512, appearance_dim 48, mip, 513 + 513 samples, bf16, padded train
dispatch, 1,664 rays) on rays from inside the unit sphere with near 1, far
10 and mip radii 1e-3. Runs one warm-up, then one request or
step under torch.profiler, and prints its wall time, the summed time of
the device kernels, device time by kernel family, and the top kernels
(the program's ``snerf.*`` spans, ``utils/spans.py``, are in the trace
and counted as no kernel). With --steps N, first times N
unprofiled runs (host clock around work that ends in a synchronize). With
--trace, writes a Chrome trace there. --state_bytes needs no card: it
reckons, from the leaves' shapes on the CPU, each rank's bytes of the
Building train state's parameters and Adam moments under each layout of
8 GPUs (``bridge.local_tree``, the rule the layout tests hold against
JAX's shardings). --embedding times the appearance embedding's backward
(``ops/embedding.embedding_bwd``) on EMB_CASES: CUDA events a call, the
device kernels a call and their device ms (torch.profiler), whether it
gives its plain version's bits, and F.embedding's backward on the same
inputs. Run as a file with another checkout first on PYTHONPATH, it
times that checkout's package with this script:

    PYTHONPATH=OTHER python switch_nerf_torch/profile_eval.py --embedding
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from switch_nerf_torch.config import get_opts, parse_args
from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
from switch_nerf_torch.trainer import (
    SceneInfo, create_train_state, make_eval_step, make_train_step,
    render_config_from_hparams)

REPO = Path(__file__).resolve().parent.parent

# kernel-name substrings -> family (first match wins)
FAMILIES = (
    ("K2/K4 chain backward", ("chain_bwd_", "chain_dw_")),
    ("K1/K3 chain kernel", ("chain_fwd_sm90", "chain_fwd_tf32")),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_")),
    ("embedding backward", ("embedding_bwd",)),
    ("sort", ("sort", "radix")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("reduction / scan", ("reduce", "scan", "cumsum", "cumprod")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / cat", ("copy", "cat", "fill")),
)


def building_eval_hparams():
    """building.yaml plus the published production flags, with padded eval
    dispatch, 256 + 512 samples and 32768-point chunks."""
    return parse_args(get_opts(), [
        "--config_file", str(REPO / "configs/switch_nerf/building.yaml"),
        "--exp_name", "building_eval", "--dataset_path", str(REPO),
        "--use_moe", "--use_moe_external_gate", "--use_gate_input_norm",
        "--batch_prioritized_routing", "--moe_capacity_factor", "1.0",
        "--moe_expert_num", "8", "--appearance_dim", "48",
        "--moe_test_batch", "--coarse_samples", "256",
        "--fine_samples", "512", "--model_chunk_size", "32768"])


def building_train_hparams():
    """The eval workload's hparams plus the published training recipe
    (bench.py:164-174 and the README's Building command): padded train
    dispatch, sigma noise, l_aux weight 5e-4, 1024-ray batches."""
    h = building_eval_hparams()
    h.moe_train_batch = True
    h.use_sigma_noise = True
    h.moe_l_aux_wt = 5e-4
    h.batch_size = 1024
    return h


def ray_batch(n: int, seed: int, device, rgbs: bool = False) -> dict:
    """n rays from inside the unit sphere (the graft entry's _make_batch
    recipe): origins N(0, 0.1), unit directions, near 0.5, far 2.5, and
    appearance indices in [0, 8); with `rgbs`, target colours in [0, 1)."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g) * 0.1
    d = torch.randn(n, 3, generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.full((n, 1), 0.5),
                      torch.full((n, 1), 2.5)], -1)
    idx = torch.randint(0, 8, (n,), generator=g).float()
    batch = {"rays": rays.to(device), "image_indices": idx.to(device)}
    if rgbs:
        batch["rgbs"] = torch.rand(n, 3, generator=g).to(device)
    return batch


def mission_bay_train_hparams():
    """mission_bay.yaml with the README's Block-NeRF training flags and
    1,664 rays a card (the README's 13,312 over 8 GPUs)."""
    return parse_args(get_opts(), [
        "--config_file", str(REPO / "configs/switch_nerf/mission_bay.yaml"),
        "--exp_name", "mission_bay", "--dataset_path", str(REPO),
        "--batch_size", "1664", "--moe_train_batch",
        "--use_moe_external_gate", "--use_gate_input_norm",
        "--batch_prioritized_routing", "--moe_capacity_factor", "1.0",
        "--moe_l_aux_wt", "0.0005"])


SCENE = SceneInfo(np.zeros(3, np.float32), np.ones(3, np.float32))


def _eval_run(n: int):
    h = building_eval_hparams()
    step = make_eval_step(get_nerf(h, 8, seed=0), get_bg_nerf(h, 8, seed=1),
                          h, render_config_from_hparams(h), SCENE)
    batch = ray_batch(n, 0, "cuda")
    return "request", lambda: step(batch)


def _train_run(n: int):
    h = building_train_hparams()
    state = create_train_state(h, get_nerf(h, 8, seed=0),
                               get_bg_nerf(h, 8, seed=1))
    step = make_train_step(h, render_config_from_hparams(h), SCENE)
    batch = ray_batch(n, 0, "cuda", rgbs=True)
    return "train step", lambda: step(state, batch)


def _mission_bay_run(n: int):
    h = mission_bay_train_hparams()
    state = create_train_state(h, get_nerf(h, 8, seed=0), None)
    step = make_train_step(h, render_config_from_hparams(h),
                           SceneInfo(None, None), mip=True)
    batch = ray_batch(n, 0, "cuda", rgbs=True)
    batch["rays"][:, 6:] = torch.tensor([1.0, 10.0], device="cuda")
    batch["radii"] = torch.full((n, 1), 1e-3, device="cuda")
    return "Mission Bay train step", lambda: step(state, batch)


# the embedding backward's inputs: phase 4a's chunk of chip_smoke.py (64
# rays x 512 samples, a random table row a ray, F 48) over Building's
# 1,920-row table ("runs"), the same over a 65,536-row table ("wide
# table"), one table row for every row ("one index"), the chunk's rows in
# a random order ("unsorted") and two table rows in turn ("alternating"):
# in the last two nearly every row is a run of its own
EMB_RAYS, EMB_SAMPLES, EMB_FEATS = 64, 512, 48
EMB_CASES = {"runs": 1920, "one index": 1920, "wide table": 65536,
             "unsorted": 1920, "alternating": 1920}


def embedding_case(case: str, seed: int = 11):
    """(indices [32768] int64, gradient [32768, 48] fp32, table rows) on
    the card for one of EMB_CASES."""
    num = EMB_CASES[case]
    gen = torch.Generator().manual_seed(seed)
    rays = torch.randint(0, num, (EMB_RAYS,), generator=gen)
    if case == "one index":
        rays[:] = rays[0]
    idx = rays.repeat_interleave(EMB_SAMPLES)
    g = torch.randn(idx.numel(), EMB_FEATS, generator=gen)
    if case == "unsorted":
        idx = idx[torch.randperm(idx.numel(), generator=gen)]
    elif case == "alternating":
        idx = torch.arange(idx.numel()) % 2 * (num // 2)
    return idx.cuda(), g.cuda(), num


def kernel_label(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    name = name.split("(anonymous namespace)::")[-1]
    return name.split("<")[0].split("(")[0].replace("void ", "")[:60]


def device_kernels(fn, iters: int = 20):
    """(device kernels a call, their device ms a call, {kernel_label: its
    device ms a call}) over `iters` calls of fn() under torch.profiler. A
    trace can miss launches, so the counts are a floor."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_kernel = {}
    for e in kernels:
        label = kernel_label(e.key)
        by_kernel[label] = (by_kernel.get(label, 0.0)
                            + e.self_device_time_total / 1e3 / iters)
    return (sum(e.count for e in kernels) / iters, sum(by_kernel.values()),
            by_kernel)


def event_ms(fn, iters: int = 50, warmup: int = 10) -> float:
    """Mean ms a call of fn() from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def embedding_times() -> dict:
    """{case: {ms, device_ms, kernels, by_kernel, library_ms, bit_equal}} of
    embedding_bwd on each of EMB_CASES (library: F.embedding's backward,
    aten.embedding_dense_backward)."""
    from switch_nerf_torch.ops import embedding
    out = {}
    for case in EMB_CASES:
        idx, g, num = embedding_case(case)

        def call():
            return embedding.embedding_bwd(idx, g, num)
        same = torch.equal(call().cpu(),
                           embedding.embedding_bwd_plain(idx, g, num).cpu())
        kernels, device_ms, by_kernel = device_kernels(call)
        out[case] = {
            "ms": event_ms(call), "device_ms": device_ms,
            "kernels": kernels, "by_kernel": by_kernel,
            "library_ms": event_ms(
                lambda: torch.ops.aten.embedding_dense_backward(
                    g, idx, num, -1, False)),
            "bit_equal": same}
    return out


# (label, D, E, --expert_parallel, --expert_weight_parallel,
#  --shard_optimizer_states): the layouts --state_bytes reckons
LAYOUTS = (("data parallel", 8, 1, False, False, False),
           ("weight parallel", 8, 1, False, True, False),
           ("ZeRO-1", 8, 1, False, False, True),
           ("weight parallel + ZeRO-1", 8, 1, False, True, True),
           ("expert parallel", 2, 4, True, False, False),
           ("expert + weight parallel + ZeRO-1", 2, 4, True, True, True),
           ("expert parallel", 1, 8, True, False, False),
           ("expert + weight parallel + ZeRO-1", 1, 8, True, True, True))


def state_bytes() -> list:
    """Each layout's per-rank bytes of the Building train state's fp32
    parameters and Adam moments (mu, nu), reckoned from shapes on the
    CPU: (label, D, E, [bytes of each rank])."""
    from switch_nerf_torch import bridge
    from switch_nerf_torch.parallel.mesh import Mesh
    h = building_train_hparams()
    shapes = bridge.jax_state_shapes(get_nerf(h, 8, device="cpu"),
                                     get_bg_nerf(h, 8, device="cpu"))
    tree = {"params": shapes,
            "opt_state": {"0": {"mu": shapes, "nu": shapes}}}
    out = []
    for label, d, e, ep, wp, zero in LAYOUTS:
        ranks = []
        for r in range(d * e):
            part = bridge.local_tree(tree, Mesh(
                d, e, r, None, None, None, expert_parallel=ep,
                weight_parallel=wp, zero=zero), h.moe_expert_num)
            ranks.append(sum(4 * a.size for a in
                             bridge._flatten(part).values()))
        out.append((label, d, e, ranks))
    return out


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of an eval request")
    ap.add_argument("--mission_bay", action="store_true",
                    help="profile a Mission Bay train step")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays per request (4096) or train batch (1024; "
                    "Mission Bay 1664)")
    ap.add_argument("--steps", type=int, default=0,
                    help="unprofiled runs to time before the profiled one")
    ap.add_argument("--trace", type=str, default=None)
    ap.add_argument("--embedding", action="store_true",
                    help="time the embedding's backward on EMB_CASES, and "
                    "stop")
    ap.add_argument("--state_bytes", action="store_true",
                    help="reckon each rank's train-state bytes under each "
                    "layout of 8 GPUs on the CPU, and stop")
    args = ap.parse_args(argv)
    if args.state_bytes:
        for label, d, e, ranks in state_bytes():
            print(f"{label}, --mesh_shape {d} {e}: per-rank parameter + "
                  f"Adam moment bytes {sorted(set(ranks))} (reckoned from "
                  "shapes on the CPU, not measured)")
        return 0
    if args.embedding:
        rows = embedding_times()
        for case, r in rows.items():
            print(f"embedding backward, {case} ({EMB_CASES[case]} table "
                  f"rows): {r['ms']:.4f} ms a call (events), "
                  f"{r['kernels']:g} device kernels a call, "
                  f"{r['device_ms']:.4f} ms in them, F.embedding's backward "
                  f"{r['library_ms']:.4f} ms, bit-equal to the plain "
                  f"version {r['bit_equal']}; device ms a call by kernel "
                  f"{r['by_kernel']}")
        print(json.dumps({"embedding": rows,
                          "device": torch.cuda.get_device_name(0)}))
        return 0

    if args.mission_bay:
        n = args.rays or 1664
        what, run = _mission_bay_run(n)
    else:
        n = args.rays or (1024 if args.train else 4096)
        what, run = (_train_run if args.train else _eval_run)(n)
    run()                                          # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if times:
        print(f"{what}: {args.steps} unprofiled runs, seconds "
              f"{[round(t, 4) for t in times]}, mean "
              f"{sum(times) / len(times):.4f} s, "
              f"{n * len(times) / sum(times):.1f} rays/s")
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(
            Path(args.trace) / f"{what.replace(' ', '_')}.json"))

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    by_family = {}
    for e in kernels:
        f = by_family.setdefault(family(e.key), [0.0, 0])
        f[0] += e.self_device_time_total / 1e3
        f[1] += e.count
    print(f"{what}: {n} rays, wall {wall * 1e3:.1f} ms, device kernels "
          f"{device_us / 1e3:.1f} ms, {launches} kernel launches")
    for fam, (ms, cnt) in sorted(by_family.items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:28s} {ms:9.2f} ms  {cnt:7d} launches")
    print("top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  "
              f"{e.key[:100]}")
    print(json.dumps({
        "what": what, "rays": n, "wall_ms": wall * 1e3,
        "unprofiled_s": times,
        "device_kernel_ms": device_us / 1e3, "kernel_launches": launches,
        "device_ms_by_family": {k: v[0] for k, v in by_family.items()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
