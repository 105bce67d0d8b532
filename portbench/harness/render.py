"""A rendering cell: whole requests of the traffic's ray count through the
program's eval step as ``Runner._batched_collective_fn`` calls it (rays
padded into one request shape, copied in, the results copied to the
host), cycling over the validation cameras' rays in order, in a closed
loop of one client.

The answers of every completed request are kept; once the window has
closed, a sample of each one's rays, drawn from the seed, goes through
the plain reference, and each request's median colour gap is compared.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from reference import nets, steps as ref_steps

from . import core
from .trace import profiled, span
from .train import reference_scene, scene_paths

# a ray whose colour gap passes this is wrong: at the cell's size the
# program's bf16 left none of ~9,000 sampled rays past it (their 99th
# percentile at most 3.5e-3), the fp8 control more than half of them
RAY_TOLERANCE = 0.01


def build(cell: dict, seed: int, dev) -> dict:
    from switch_nerf_torch.datasets.ray_utils import (get_ray_directions,
                                                      get_rays)
    from switch_nerf_torch.runner import Runner
    from switch_nerf_torch.trainer import (SceneInfo, make_eval_step,
                                           render_config_from_hparams)
    cfg, traffic = cell["config"], cell["traffic"]
    sd = core.seeds(seed)
    sc = scene_paths(traffic, cfg)
    h = core.port_hparams(cfg, sc["flags"] + [
        "--exp_name", str(core.CACHE / "runs" / cell["workload"]["name"]),
        "--val_scale_factor", str(traffic["val_scale_factor"]),
        "--image_pixel_batch_size", str(traffic["request_rays"])])
    runner = Runner(h, set_experiment_path=False, device=dev)
    n_app = runner.appearance_count
    gen = torch.Generator(device=dev).manual_seed(sd["weights"])
    core.load_weights(runner.nerf, nets.draw_weights(
        nets.moe_spec(cfg, n_app), gen, dev))
    if runner.bg_nerf is not None:
        core.load_weights(runner.bg_nerf, nets.draw_weights(
            nets.bg_spec(cfg, n_app), gen, dev))
    step = make_eval_step(runner.nerf, runner.bg_nerf, h,
                          render_config_from_hparams(h),
                          SceneInfo(runner.sphere_center,
                                    runner.sphere_radius),
                          mip=runner.mip, device=dev)

    def image_rays(item) -> np.ndarray:
        d = get_ray_directions(item.W, item.H, item.intrinsics[0],
                               item.intrinsics[1], item.intrinsics[2],
                               item.intrinsics[3], h.center_pixels)
        return get_rays(d, item.c2w, runner.near, runner.far,
                        runner.ray_altitude_range).reshape(-1, 8)
    return {"runner": runner, "step": step, "image_rays": image_rays,
            "items": list(runner.val_items), "scene_dir": sc["dir"],
            "appearance": n_app}


class Requests:
    """Request k: rays [k R, (k + 1) R) of the validation images' rays in
    order, wrapping around; each image's rays built when its first
    request comes (the host work ``Runner.render_image`` does)."""

    def __init__(self, b: dict, rays_per_request: int):
        self.b, self.r = b, rays_per_request
        self.items = b["items"]
        self.cache = {}

    def rays(self, k: int):
        r = self.r
        sizes = [it.W * it.H for it in self.items]
        total = sum(sizes)
        lo = (k * r) % total
        out, idx = [], []
        while sum(len(o) for o in out) < r:
            i, off = 0, lo
            while off >= sizes[i]:
                off -= sizes[i]
                i += 1
            if i not in self.cache:
                self.cache = {i: self.b["image_rays"](self.items[i])}
            take = min(sizes[i] - off, r - sum(len(o) for o in out))
            out.append(self.cache[i][off:off + take])
            idx.append(np.full(take, float(self.items[i].image_index),
                               np.float32))
            lo = (lo + take) % total
        return np.concatenate(out), np.concatenate(idx)


def serve(b: dict, req: Requests, k: int, keep: bool, times: dict):
    """Request k through the runner's batched path: the rays and their
    appearance index, padded to the request shape, in; results out."""
    runner, step = b["runner"], b["step"]
    t0 = core.Clock()
    with span("rays"):
        rays, idx = req.rays(k)
    prog = {"s": 0.0}

    def program(batch):
        batch["image_indices"] = torch.as_tensor(idx, device=batch[
            "rays"].device)
        c = core.Clock()
        with span("program"):
            out = step(batch)
            if batch["rays"].device.type == "cuda":
                torch.cuda.synchronize()
        prog["s"] += c()
        return out
    render_chunks = runner._batched_collective_fn(program)
    res = render_chunks(rays, 0.0)
    total = t0()
    times["host_io_s"] += total - prog["s"]
    if keep:
        return {"rays": rays, "idx": idx, "rgb": res["rgb_fine"],
                "depth": res["depth_fine"]}
    return None


def run(cell: dict, seed: int, seconds: float, trace: bool, dev,
        clock: core.Clock, hooks=None) -> dict:
    hooks = hooks or {}
    cfg, traffic = cell["config"], cell["traffic"]
    t_build = clock()
    b = build(cell, seed, dev)
    t_built = clock()
    req = Requests(b, traffic["request_rays"])
    times = {"host_io_s": 0.0}
    for k in range(traffic["warm_requests"]):
        serve(b, req, k, False, times)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = clock()
    phases = {"to_build": t_build, "build": t_built - t_build,
              "warm": setup_s - t_built}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = {"host_io_s": 0.0}
    answers: List[Dict] = []
    w = core.Clock()
    k = 0
    while True:
        with span("request"):
            answers.append(serve(b, req, k, True, times))
        k += 1
        if w() >= seconds:
            break
    window_s = w()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rays = k * traffic["request_rays"]
    host_io = times["host_io_s"]

    tr = None
    if trace:
        def stretch():
            for j in range(traffic["trace_requests"]):
                with span("request"):
                    serve(b, req, k + j, False, {"host_io_s": 0.0})
            return traffic["trace_requests"]
        tr = profiled(stretch)

    scene_dir, n_app = b["scene_dir"], b["appearance"]
    del b, req
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell, seed, answers, scene_dir, n_app, dev,
                     bool(hooks.get("control")))
    return {"kind": "render", "attempted": k, "failed": 0,
            "setup_s": setup_s, "window_s": window_s, "units": k,
            "rays": rays, "rays_per_s": rays / window_s,
            "host_io_ms_per_unit": 1e3 * host_io / k, "peak": peak,
            "trace": tr, "checks": checks, "setup_phases": phases}


def compare(cell: dict, seed: int, answers: List[Dict], scene_dir, n_app,
            dev, control: bool = False) -> Dict[str, dict]:
    """For each completed request, `sample_rays` of its rays (drawn from
    the seed) through the reference, each ray's gap the largest channel's
    absolute colour gap. Three numbers, each the worst request's: the
    median ray's gap (a ray whose token took another expert at a near tie
    reads far off; the median does not follow those), the mean ray's gap,
    which a minority of wrong rays moves (an eighth of the rays off by
    0.03 adds 3.75e-3), and the share of rays past RAY_TOLERANCE, which a
    twentieth of the rays off by more than it fails. The 99th percentile
    and the share past 0.05 are readings. With `control`, the same numbers
    for the reference at fp8 in the program's place (``_control``)."""
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    sd = core.seeds(seed)
    gen = torch.Generator(device=dev).manual_seed(sd["weights"])
    fg = nets.draw_weights(nets.moe_spec(cfg, n_app), gen, dev)
    bg = (nets.draw_weights(nets.bg_spec(cfg, n_app), gen, dev)
          if cfg.get("bg_model") else None)
    geo = reference_scene(scene_dir, cfg)
    scene_t = (None if geo is None else
               tuple(torch.as_tensor(g, device=dev) for g in geo))
    rng = np.random.default_rng(sd["sample"])
    gaps = {"program": [], "control": []}
    means = {"program": [], "control": []}
    shares = {"program": [], "control": []}
    tails = {"program": [], "control": []}
    depth = []
    for a in answers:
        pick = rng.choice(len(a["rays"]), traffic["sample_rays"],
                          replace=False)
        batch = {"rays": torch.as_tensor(a["rays"][pick], device=dev),
                 "image_indices": torch.as_tensor(a["idx"][pick],
                                                  device=dev)}
        ref = ref_steps.render(cfg, fg, bg, batch, scene_t)
        answers_of = {"program": torch.as_tensor(a["rgb"][pick], device=dev)}
        if control:
            answers_of["control"] = ref_steps.render(
                cfg, fg, bg, batch, scene_t, nets.Prec("fp8"))["rgb_fine"]
        for who, rgb in answers_of.items():
            err = torch.abs(rgb - ref["rgb_fine"]).amax(dim=-1)
            gaps[who].append(float(torch.median(err)))
            means[who].append(float(torch.mean(err)))
            shares[who].append(float(torch.mean(
                (err > RAY_TOLERANCE).float())))
            tails[who].append([float(torch.quantile(err, 0.99)),
                               float(torch.mean((err > 0.05).float()))])
        d_ref = ref["depth_fine"]
        d = torch.as_tensor(a["depth"][pick], device=dev)
        depth.append(float(torch.median(torch.abs(d - d_ref)
                                        / d_ref.abs().clamp(min=1e-6))))

    def judged(who):
        out = {}
        for key, per_request in (("rgb_gap", gaps[who]),
                                 ("rgb_mean_gap", means[who]),
                                 ("rgb_share_wrong", shares[who])):
            worst = int(np.argmax(per_request))
            out[key] = {"value": per_request[worst], "limit": limits[key],
                        "request": worst}
        out["_readings"] = {
            "rgb_gap_per_request": gaps[who],
            "rgb_mean_gap_per_request": means[who],
            "rgb_q99_share_past_0.05_per_request": tails[who]}
        return out
    out = judged("program")
    out["_readings"]["depth_rel_median_per_request"] = depth
    if control:
        out["_control"] = judged("control")
    return out
