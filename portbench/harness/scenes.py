"""Synthetic scenes in the published layouts, written once per checkout.

``mega_scene`` writes a Mega-NeRF scene (coordinates.pt; train/ and val/
with metadata/<name>.pt and rgbs/<name>.jpg) of cameras looking straight
down over the scene's altitude range. It takes its numbers from the
traffic mix's "scene" entry and is keyed by them: ``cached`` writes a scene into a temporary directory beside
its place and renames it there when complete, so a run that is cut off
leaves nothing that a later run would take for whole.
"""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Callable

import numpy as np
import torch


def cached(root: Path, kind: str, params: dict,
           write: Callable[[Path, dict], None]) -> Path:
    """The directory of the scene `params` under root, written by `write`
    unless a complete one is there."""
    key = hashlib.sha256(json.dumps([kind, params], sort_keys=True)
                         .encode()).hexdigest()[:16]
    final = root / f"{kind}-{key}"
    if (final / "complete").exists():
        return final
    tmp = root / f"{kind}-{key}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(final, ignore_errors=True)
    tmp.mkdir(parents=True)
    write(tmp, params)
    (tmp / "complete").write_text(json.dumps(params, sort_keys=True))
    tmp.rename(final)
    return final


def mega_scene(root: Path, p: dict) -> None:
    """p: width, height, train, val (image counts), focal, seed. Cameras
    0.8 above the origin of the pose-normalised frame (drb: +x is down),
    looking down, at a random place in [-0.4, 0.4]^2; smooth random JPEG
    images. The origin and scale put the altitude range [8, 50] of
    building.yaml at x in [-0.44, 0.4]."""
    from PIL import Image
    rng = np.random.default_rng(p["seed"])
    w, h = p["width"], p["height"]
    torch.save({"origin_drb": torch.tensor([30.0, 0.0, 0.0]),
                "pose_scale_factor": 50.0}, root / "coordinates.pt")
    look_down = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], np.float32)
    n = p["train"] + p["val"]
    val = set(range(1, n, max(n // max(p["val"], 1), 1))[:p["val"]])
    for i in range(n):
        split = root / ("val" if i in val else "train")
        (split / "metadata").mkdir(parents=True, exist_ok=True)
        (split / "rgbs").mkdir(parents=True, exist_ok=True)
        c2w = np.concatenate([look_down, np.array(
            [[-0.8], rng.uniform(-0.4, 0.4, [1]),
             rng.uniform(-0.4, 0.4, [1])], np.float32)], 1)
        torch.save({"c2w": torch.from_numpy(c2w), "W": w, "H": h,
                    "intrinsics": torch.tensor(
                        [p["focal"], p["focal"], w / 2, h / 2])},
                   split / "metadata" / f"{i:06d}.pt")
        coarse = rng.uniform(0, 255, (h // 16, w // 16, 3))
        Image.fromarray(coarse.astype(np.uint8)).resize(
            (w, h), Image.BICUBIC).save(split / "rgbs" / f"{i:06d}.jpg")
