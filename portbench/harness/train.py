"""A training cell: the program's chunked dataset feeds its train step in
``Runner._train_loop``'s order (fetch a batch, ``Runner._put_batch``,
``TrainStep.__call__``) for a window of whole steps.

The chunks are written once per checkout from the traffic's fixed
``data_seed``, so every checkout holds the same rows; ``--seed`` then
picks the chunk the run starts at and the order of its batches (the
dataset's resume cursor, ``set_state``).

Set-up builds one training state from the seed and drives it through the
traffic's ``record_steps`` first steps (the warm-up), keeping what the
comparison needs: each step's loss, every leaf's gradient norm as Adam got
it (its first moment after one step over 1 - beta1), every leaf's change
after the last of them, and the batches. The window then runs on the same
state. Once it has closed and the peak memory is read, the program's state
is freed and the plain reference trains the same weights, on the same
batches, from a generator in the same state.
"""
from __future__ import annotations

import gc
import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from reference import nets, scene as ref_scene, steps as ref_steps

from . import core, scenes
from .trace import profiled, span


def scene_paths(traffic: dict, cfg: dict) -> Dict[str, object]:
    """The traffic's synthetic scene, written once, and the program's
    flags that point at it (its chunk directory beside it)."""
    s = traffic["scene"]
    if s["layout"] != "mega":
        raise core.CellError(f"scene layout {s['layout']!r}")
    d = scenes.cached(core.CACHE / "scenes", "mega", s, scenes.mega_scene)
    return {"dir": d, "flags": ["--dataset_path", str(d)]}


def reference_scene(runner_scene: Path, cfg: dict):
    """The foreground ellipsoid worked out from the scene's own camera
    files (None for a configuration without one)."""
    g = cfg.get("scene_geometry")
    if not g:
        return None
    coord = torch.load(runner_scene / "coordinates.pt", weights_only=False)
    cams = [torch.load(p, weights_only=False)["c2w"][:, 3].numpy()
            for split in ("train", "val")
            for p in sorted((runner_scene / split / "metadata").glob("*.pt"))]
    return ref_scene.ellipse(np.stack(cams), tuple(g["altitude_range"]),
                             float(coord["origin_drb"][0]),
                             float(coord["pose_scale_factor"]),
                             g["ellipse_scale_factor"])


def wrong_rows(scene_dir: Path, cfg: dict, batches: List[Dict]) -> int:
    """Rows of the recorded batches that disagree with the scene the
    harness wrote (Mega-NeRF layout): each row's ray must start at its
    image's camera and its colour must be that image's pixel where the
    ray's direction falls (pixel centres, the image decoded here).
    Returns the count."""
    from PIL import Image
    metas = sorted((p for split in ("train", "val")
                    for p in (scene_dir / split / "metadata").glob("*.pt")),
                   key=lambda p: p.name)
    cams, imgs = [], []
    for p in metas:
        md = torch.load(p, weights_only=False)
        cams.append((md["c2w"].numpy().astype(np.float64),
                     md["intrinsics"].numpy().astype(np.float64)))
        imgs.append(np.asarray(Image.open(
            p.parent.parent / "rgbs" / f"{p.stem}.jpg").convert("RGB")))
    wrong = 0
    for bt in batches:
        rays, rgbs = bt["rays"].astype(np.float64), bt["rgbs"]
        idx = bt["image_indices"].astype(np.int64)
        for i in np.unique(idx):
            rows = idx == i
            c2w, (fx, fy, cx, cy) = cams[i]
            d = rays[rows, 3:6] @ c2w[:, :3]             # camera frame
            u = np.rint(d[:, 0] / -d[:, 2] * fx + cx - 0.5).astype(int)
            v = np.rint(-d[:, 1] / -d[:, 2] * fy + cy - 0.5).astype(int)
            img = imgs[i]
            inside = ((u >= 0) & (u < img.shape[1]) & (v >= 0)
                      & (v < img.shape[0]))
            pix = img[np.clip(v, 0, img.shape[0] - 1),
                      np.clip(u, 0, img.shape[1] - 1)] / 255.0
            ok = (inside
                  & np.all(np.abs(pix - rgbs[rows]) < 1e-6, axis=1)
                  & np.all(np.abs(rays[rows, :3] - c2w[:, 3]) < 1e-6,
                           axis=1))
            wrong += int((~ok).sum())
    return wrong


def build(cell: dict, seed: int, dev, extra_flags=()) -> dict:
    """The program's runner, models, state, step and dataset for the cell,
    with the benchmark's weights."""
    from switch_nerf_torch.runner import Runner
    from switch_nerf_torch.trainer import (SceneInfo, create_train_state,
                                           make_train_step,
                                           render_config_from_hparams)
    cfg, traffic = cell["config"], cell["traffic"]
    marks = core.Marks(dev)
    sd = core.seeds(seed)
    sc = scene_paths(traffic, cfg)
    marks("scene")
    run_dir = core.CACHE / "runs" / cell["workload"]["name"]
    key = f"{traffic['scene']['layout']}-{traffic['num_chunks']}-" \
          f"{traffic.get('train_scale_factor', 1)}-{sc['dir'].name}"
    h = core.port_hparams(cfg, sc["flags"] + [
        "--exp_name", str(run_dir),
        "--dataset_type", "filesystem",
        "--chunk_paths", str(core.CACHE / "chunks" / key),
        "--num_chunks", str(traffic["num_chunks"]),
        "--train_scale_factor", str(traffic.get("train_scale_factor", 1)),
        "--batch_size", str(traffic["batch"]),
        "--random_seed", str(traffic["data_seed"])] + list(extra_flags))
    marks("import")
    runner = Runner(h, set_experiment_path=False, device=dev)
    marks("runner")
    n_app = runner.appearance_count
    gen = torch.Generator(device=dev).manual_seed(sd["weights"])
    fg_w = nets.draw_weights(nets.moe_spec(cfg, n_app), gen, dev)
    core.load_weights(runner.nerf, fg_w)
    if runner.bg_nerf is not None:
        bg_w = nets.draw_weights(nets.bg_spec(cfg, n_app), gen, dev)
        core.load_weights(runner.bg_nerf, bg_w)
    del fg_w
    marks("weights")
    state = create_train_state(h, runner.nerf, runner.bg_nerf, device=dev,
                               seed=sd["generator"])
    step = make_train_step(
        h, render_config_from_hparams(h),
        SceneInfo(runner.sphere_center, runner.sphere_radius),
        mip=runner.mip, device=dev)
    marks("state_step")
    dataset = runner._make_dataset(None)
    # the seed's start chunk and batch order, through the resume cursor
    batch_rng = np.random.default_rng([sd["data"], 2]).bit_generator.state
    dataset.set_state(json.dumps({"chunk": sd["data"] % traffic["num_chunks"],
                                  "batch_rng": batch_rng}))
    marks("dataset")
    return {"h": h, "runner": runner, "state": state, "step": step,
            "dataset": dataset, "scene_dir": sc["dir"], "seeds": sd,
            "appearance": n_app, "phases": marks.phases}


class Feed:
    """The dataset's batches in ``Runner._train_loop``'s order: a chunk
    loaded, its batches, the next chunk."""

    def __init__(self, dataset, batch: int):
        self.dataset, self.batch = dataset, batch
        self.it = None

    def next(self) -> Dict[str, np.ndarray]:
        while True:
            if self.it is None:
                self.dataset.load_chunk()
                self.it = iter(self.dataset.sample_batches(self.batch))
            try:
                return next(self.it)
            except StopIteration:
                self.it = None


def settle(dataset) -> None:
    """Wait until the dataset's prefetch of its next chunk has landed, so
    that the window's steps do not share the host with it. A window is
    far shorter than one chunk's batches, so no chunk is read inside it."""
    pending = getattr(dataset, "_next_chunk", None)
    if pending is not None and not pending.cancelled():
        pending.result()


def leaf_names(state) -> List[str]:
    names = [f"fg.{k}" for k, _ in state.model.named_parameters()]
    if state.bg_model is not None:
        names += [f"bg.{k}" for k, _ in state.bg_model.named_parameters()]
    return names


def run(cell: dict, seed: int, seconds: float, trace: bool, dev,
        clock: core.Clock, hooks=None) -> dict:
    """One run of a training cell. hooks: "control": also judge the
    reference at fp8 against it (``_control`` in the checks) and the
    faults planted in the reference (``_faults``)."""
    hooks = hooks or {}
    cfg, traffic = cell["config"], cell["traffic"]
    t_build = clock()
    b = build(cell, seed, dev)
    t_built = clock()
    runner, state, step = b["runner"], b["state"], b["step"]
    feed = Feed(b["dataset"], traffic["batch"])
    names = leaf_names(state)
    params = state.parameters()
    start = [p.detach().clone() for p in params]
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    record: Dict = {"loss": [], "grad": {}, "change": {}, "batches": []}
    failed = 0
    marks = core.Marks(dev)
    for i in range(traffic["record_steps"]):
        batch = feed.next()
        if i == 0:
            marks("first_chunk")
        record["batches"].append({k: np.array(v) for k, v in batch.items()})
        state, m = step(state, runner._put_batch(batch))
        record["loss"].append(float(m["all_loss"]))
        failed += int(float(m.get("finite", 1.0)) == 0.0)
        if i == 0:
            record["grad"] = {
                n: float(torch.linalg.vector_norm(
                    state.optimizer.state[p]["exp_avg"].float()) / (1 - beta1))
                if p in state.optimizer.state else 0.0
                for n, p in zip(names, params)}
    record["change"] = {n: float(torch.linalg.vector_norm(
        p.detach().float() - s)) for n, p, s in zip(names, params, start)}
    del start
    marks("record_steps")
    settle(b["dataset"])
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    marks("settle")
    setup_s = clock()
    phases = {"to_build": t_build, "build": t_built - t_build,
              "warm": setup_s - t_built,
              "build_parts": b["phases"], "warm_parts": marks.phases,
              "host": core.host_reading()}

    # the window: whole steps until `seconds` have passed; the set-up's
    # objects are left out of the collector's passes inside it
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()
    steps, data_s, ends = 0, 0.0, []
    w = core.Clock()
    while True:
        t = w()
        batch = runner._put_batch(feed.next())
        data_s += w() - t
        state, m = step(state, batch)
        failed += int(float(m.get("finite", 1.0)) == 0.0)
        steps += 1
        ends.append(w())
        if ends[-1] >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = w()
    gc.unfreeze()
    # each step's host time (the step's finite check syncs the host): how
    # much one run's steps vary, beside how much runs vary
    phases["window_step_s_quartiles"] = [
        float(q) for q in np.percentile(np.diff([0.0] + ends),
                                        [0, 25, 50, 75, 100])]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rays = steps * traffic["batch"]

    tr = None
    if trace:
        def stretch():
            nonlocal state
            for _ in range(traffic["trace_steps"]):
                with span("fetch"):
                    batch = feed.next()
                with span("put_batch"):
                    batch = runner._put_batch(batch)
                with span("step"):
                    state, _ = step(state, batch)
            return traffic["trace_steps"]
        tr = profiled(stretch)

    # the program's state goes before the reference runs
    dataset = b["dataset"]
    if hasattr(dataset, "close"):
        dataset.close()
    scene_dir, n_app = b["scene_dir"], b["appearance"]
    del b, state, step, runner, feed, params, dataset, m, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_record(cell, seed, record["batches"], scene_dir, n_app,
                           dev)
    checks = judge(cell, record, ref)
    checks["wrong_rows"] = {
        "value": float(wrong_rows(scene_dir, cfg, record["batches"])),
        "limit": cell["limits"]["wrong_rows"]}
    if hooks.get("control"):
        # the control: the reference one precision down in the program's
        # place, judged against the same float32 reference
        ctrl = reference_record(cell, seed, record["batches"], scene_dir,
                                n_app, dev, nets.Prec("fp8"))
        checks["_control"] = judge(cell, ctrl, ref)
        # the faults, planted in the reference put in the program's place
        # (a state left unchanged reads 1 on the change by definition)
        checks["_faults"] = {
            f: judge(cell, reference_record(cell, seed, record["batches"],
                                            scene_dir, n_app, dev, fault=f),
                     ref) for f in ("half", "colours")}
    return {"kind": "train", "attempted": steps, "failed": failed,
            "setup_s": setup_s, "window_s": window_s, "units": steps,
            "rays": rays, "rays_per_s": rays / window_s,
            "data_ms_per_unit": 1e3 * data_s / steps, "peak": peak,
            "trace": tr, "checks": checks, "setup_phases": phases}


def reference_record(cell: dict, seed: int, batches: List[Dict],
                     scene_dir: Path, n_app: int, dev,
                     prec: nets.Prec = nets.FP32, fault: str = "") -> Dict:
    """The plain reference's first steps on `batches` from the seed's
    weights and generator: the same record the program's steps give
    (losses, first gradient and change norms by leaf). `fault` plants one
    of the faults the limits are read against: "half" (each batch's second
    half left out, the mean over the rest) or "colours" (a tenth of the
    rays' colours altered by 0.05)."""
    cfg = cell["config"]
    if fault == "half":
        batches = [{k: v[:len(v) // 2] for k, v in bt.items()}
                   for bt in batches]
    sd = core.seeds(seed)
    gen = torch.Generator(device=dev).manual_seed(sd["weights"])
    fg = nets.draw_weights(nets.moe_spec(cfg, n_app), gen, dev)
    bg = (nets.draw_weights(nets.bg_spec(cfg, n_app), gen, dev)
          if cfg.get("bg_model") else None)
    geo = reference_scene(scene_dir, cfg)
    scene_t = (None if geo is None else
               tuple(torch.as_tensor(g, device=dev) for g in geo))
    batches = [{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in bt.items()} for bt in batches]
    gen = torch.Generator(device=dev).manual_seed(sd["generator"])
    ref = ref_steps.train_steps(cfg, fg, bg, batches, gen, scene_t, prec,
                                0.05 if fault == "colours" else 0.0)
    return {"loss": ref["loss"],
            "grad": {k: float(torch.linalg.vector_norm(v))
                     for k, v in ref["grad"].items()},
            "change": {k: float(torch.linalg.vector_norm(v))
                       for k, v in ref["change"].items()}}


def judge(cell: dict, record: Dict, ref: Dict) -> Dict[str, dict]:
    """The numbers compared, each beside its limit: the largest relative
    loss gap of the recorded steps; the worst leaf's gap of first gradient
    norms; the median leaf's gap of change norms (each leaf's against the
    larger of its reference norm and the median leaf's). The worst leaf's
    change swings from seed to seed with Adam's steps on the leaves that
    the gradient barely moves, so it is a reading, not a number compared."""
    limits = cell["limits"]
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out by a rule on the reference's gradient
    med = float(np.median(list(ref["grad"].values())))
    keep = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    loss_gap = max(core.gap(p, r) for p, r in
                   zip(record["loss"], ref["loss"]))
    grads = core.leaf_gaps(record["grad"], ref["grad"], keep)
    changes = core.leaf_gaps(record["change"], ref["change"], keep)
    worst_g = max(grads, key=grads.get)
    worst_c = max(changes, key=changes.get)
    return {
        "loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
        "grad_gap": {"value": grads[worst_g], "limit": limits["grad_gap"],
                     "leaf": worst_g},
        "change_gap_median": {
            "value": float(np.median(list(changes.values()))),
            "limit": limits["change_gap_median"]},
        "_readings": {
            "program_loss": record["loss"], "reference_loss": ref["loss"],
            "grad_gap_median_leaf": float(np.median(list(grads.values()))),
            "change_gap_worst_leaf": [worst_c, changes[worst_c]],
            "leaves_left_out": sorted(set(ref["grad"]) - set(keep)),
            "finite": all(math.isfinite(x) for x in
                          record["loss"] + ref["loss"])}}
