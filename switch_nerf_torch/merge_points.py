"""Merge per-image per-expert point clouds into scene-level expert clouds:
the port's own copy of ``scripts/merge_points.py``, on the port's PLY
module.

    python -m switch_nerf_torch.merge_points --data_path <exp>/eval_points \
        --merge_save_dir merged --down_scale 0.03 --moe_expert_num 8

The reference's command surface (`--merge_all --image_num=N
--model_type=switch -r=0.2`, README "Visualization"): select image ids,
sample each image's PLY by `sample_ratio`, and write one merged PLY per
expert (`{data_type}_pts_rgba_exp_{e}.ply`) when expert_num > 0, else the
merged all-points cloud (`{data_type}_pts_rgba.ply`). Input layout matches
eval_points: `<data_path>/<image_id>/{id:03d}_{typ}_pts_rgba_top_{k}_exp_
{e}.ply` (model_type switch/nerf) or `..._exp_{e}.ply` (mega).
`--merge_save_dir` redirects the outputs (default: data_path); `--seed`
makes the downsample reproducible.
"""
import argparse
from pathlib import Path

import numpy as np

from switch_nerf_torch.utils.ply import read_ply_points, write_ply_points


def _resolve_image_ids(data_path: Path, image_ids, merge_all: bool,
                       image_num: int, model_type: str):
    if merge_all:
        if model_type == "nerf":
            # reference :40-43: scan for NNN_*.ply and collect ids
            ids = {p.name.split("_")[0] for p in data_path.glob("**/*.ply")
                   if p.name.split("_")[0].isdigit()}
            return sorted(ids, key=int)
        if image_num > 0:
            # explicit --image_num keeps the reference's range semantics
            return [str(i) for i in range(image_num)]
        # auto-discovery: use the numeric dir names themselves, not a
        # synthesized range — eval_points subsets may be non-contiguous
        # or non-zero-based
        return sorted((p.name for p in data_path.iterdir()
                       if p.is_dir() and p.name.isdigit()), key=int)
    return list(image_ids or [])


def _ply_name(image_id: str, typ: str, topk: int, expert_id, model_type):
    if expert_id is None:
        return f"{int(image_id):03d}_{typ}_pts_rgba.ply"
    if model_type == "mega":
        return f"{int(image_id):03d}_{typ}_pts_rgba_exp_{expert_id}.ply"
    return (f"{int(image_id):03d}_{typ}_pts_rgba_top_{topk:01d}"
            f"_exp_{expert_id}.ply")


def _merge_one(data_path: Path, save_dir: Path, image_ids, typ, topk,
               expert_id, model_type, sample_ratio, rng):
    xyzs, rgbas = [], []
    for image_id in image_ids:
        ply = data_path / image_id / _ply_name(image_id, typ, topk,
                                               expert_id, model_type)
        xyz, rgba = read_ply_points(ply)
        n = xyz.shape[0]
        keep_n = int(n * sample_ratio)
        if keep_n == 0:
            continue
        keep = rng.choice(n, size=keep_n, replace=False)  # ref random.sample
        xyzs.append(xyz[keep])
        rgbas.append(rgba[keep])
    out_name = f"{typ}_pts_rgba.ply" if expert_id is None \
        else f"{typ}_pts_rgba_exp_{expert_id}.ply"
    out = save_dir / out_name
    if not xyzs:
        # every image's cloud sampled to zero points (tiny cloud × small
        # ratio) — the reference crashes on the empty concatenate here;
        # write an empty cloud instead so the merge completes
        print(f"{out}: 0 points (all sampled away)")
        write_ply_points(out, np.zeros((0, 3), np.float32),
                         np.zeros((0, 4), np.uint8))
        return
    xyz = np.concatenate(xyzs)
    rgba = np.concatenate(rgbas)
    write_ply_points(out, xyz, rgba)
    print(f"{out}: {xyz.shape[0]} points")


def merge(data_path: Path, save_dir=None, down_scale: float = 1.0,
          expert_num: int = 8, typ: str = "coarse", seed: int = 0,
          topk: int = 0, image_ids=None, merge_all: bool = True,
          image_num: int = 0, model_type: str = "switch"):
    """Reference merge semantics (see module docstring). `down_scale` is
    the reference's `sample_ratio`; when `merge_all` and image_num == 0,
    ids are discovered from the numeric image dirs."""
    data_path = Path(data_path)
    save_dir = data_path if save_dir is None else Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    ids = _resolve_image_ids(data_path, image_ids, merge_all, image_num,
                             model_type)
    if not ids:
        raise FileNotFoundError(
            f"no per-image point clouds found under {data_path} — expected "
            "numeric per-image subdirectories (eval_points output) or "
            "NNN_*.ply files for model_type=nerf")
    rng = np.random.default_rng(seed)
    if expert_num > 0:
        for e in range(expert_num):
            _merge_one(data_path, save_dir, ids, typ, topk, e, model_type,
                       down_scale, rng)
    else:
        _merge_one(data_path, save_dir, ids, typ, topk, None, model_type,
                   down_scale, rng)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True,
                   help="eval_points output directory (per-image subdirs)")
    p.add_argument("--image_ids", type=str, nargs="+", default=None)
    p.add_argument("--merge_all", action="store_true", default=False)
    p.add_argument("--image_num", type=int, default=0)
    p.add_argument("--expert_num", "--moe_expert_num", dest="expert_num",
                   type=int, default=8)
    p.add_argument("--model_type", type=str, default="switch",
                   choices=["switch", "mega", "nerf"])
    p.add_argument("--data_type", "--typ", dest="data_type", type=str,
                   default="coarse")
    p.add_argument("--topk", type=int, default=0,
                   help="gate slot to merge (reference --topk)")
    p.add_argument("-r", "--sample_ratio", "--down_scale",
                   dest="sample_ratio", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--merge_save_dir", type=str, default=None,
                   help="output dir (default: data_path, like the "
                        "reference)")
    args = p.parse_args()
    merge(Path(args.data_path),
          Path(args.merge_save_dir) if args.merge_save_dir else None,
          args.sample_ratio, args.expert_num, args.data_type, args.seed,
          topk=args.topk, image_ids=args.image_ids,
          merge_all=args.merge_all or args.image_ids is None,
          image_num=args.image_num, model_type=args.model_type)


if __name__ == "__main__":
    main()
