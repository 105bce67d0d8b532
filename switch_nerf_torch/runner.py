"""The runner of the port: train and serve a Mega-NeRF or a Bungee scene.

Port of the Mega-NeRF and classic-NeRF sides of
``switch_nerf_tpu/runner.py``. A ``Runner``:

  * resolves scene geometry (coordinates.pt origin/scale, near/far scaling,
    the ray-altitude transform, the ellipse foreground bounds),
  * discovers image metadata (train/val split, masks),
  * builds the models on its device,
  * trains them (``train``): rays from the chunked ``FilesystemDataset`` or
    the ``MemoryDataset``, ``trainer.make_train_step`` on every batch (the
    MoE expert chain runs the K1 and K2 kernels on a card; K3 and K4 with
    SWITCH_NERF_FUSED_DISPATCH=1), logs every --i_print steps, saves a
    checkpoint every --ckpt_interval steps and at the end, validates every
    --val_interval steps, and on SIGTERM saves a resumable checkpoint and
    returns; a run resumed from any of its checkpoints replays the same
    batches and random draws,
  * serves them (``eval_image``, ``eval``): loads a checkpoint
    (``checkpoints.py``), renders every val image in fixed
    --image_pixel_batch_size requests through ``trainer.make_eval_step``,
    scores the right half of each image (PSNR/SSIM/LPIPS, ``metrics.py``)
    and writes the JAX package's file set: experiment_path/metrics.txt,
    images/metrics_{i}.txt with the gt/pred/depth panel crops (+ _bg/_fg
    sets with the background NeRF) and val_images/{i}.jpg triptychs,
  * trains and serves a classic-NeRF (Bungee) scene with --data_type nerf
    (``train_nerf``, ``eval_nerf``): rays and mip radii from
    ``datasets/nerf_data``, the mip renderer, epoch batches from a
    per-epoch permutation, interval and SIGTERM checkpoints with exact
    resume, and full-image PSNR/SSIM/LPIPS of the test split,
  * trains and serves a Block-NeRF (Waymo Mission Bay) scene with
    --data_type block_nerf: ``train`` on the chunked
    ``BlockFilesystemDataset`` (GZIP tfrecords read without TensorFlow)
    through the mip train step, and ``eval_image_blocknerf``: each val
    record's images rendered whole, right-half PSNR/SSIM (masked by the
    moving-object masks too) and LPIPS, per-image records that make a
    rerun resume, and the 'Average val/...' summary.

Without --moe_test_batch (--moe_train_batch) the MoE layers evaluate
(train) in no-drop dispatch, on the K1R/K2R kernels on a card. A process
runs on one device (``cuda`` unless the caller passes ``device="cpu"``).

Under ``torchrun`` the Runner is data-parallel (``parallel/``), one process
per card: parameters replicated, --batch_size the global batch, each rank
training on its share (the chunked datasets stride their rows, the other
loops slice the global batch) and the gradients averaged over the ranks
(``trainer.TrainStep``); the MoE layers route on the global batch's model
chunks, as JAX does (``parallel/chunks.py``). With --expert_parallel
and --mesh_shape D E each rank holds its block of the experts and their
Adam moments, the padded training passes exchange tokens with the
experts' owners (``parallel/experts.py``), and every eval runs the whole
model, its experts gathered from their owners. Rank 0 picks the
experiment dir and writes the logs, TensorBoard and checkpoints; SIGTERM
is agreed every 10 steps, so every rank saves at the same step. In eval an
image belongs to rank ``i % W``, which renders it whole, with the requests
of one process, and writes its files; the metrics are gathered.
``eval_points`` / ``eval_points_nerf`` export per-expert point clouds
(PLY) of the val images, ``eval_ckpt`` loads a checkpoint and counts its
parameters, and every eval serves a packaged container
(``container.py``) given --container_path instead of --ckpt_path.
"""
from __future__ import annotations

import functools
import itertools
import json
import random
import shutil
import signal
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from switch_nerf_torch import bridge
from switch_nerf_torch import metrics as M
from switch_nerf_torch import parallel, resolve_device
from switch_nerf_torch.checkpoints import load_checkpoint, save_checkpoint
from switch_nerf_torch.config import get_nerf_dataset_args
from switch_nerf_torch.datasets.block_filesystem_dataset import (
    BlockFilesystemDataset, load_tfrecord, record_id_map)
from switch_nerf_torch.datasets.filesystem_dataset import FilesystemDataset
from switch_nerf_torch.datasets.image_metadata import ImageMetadata
from switch_nerf_torch.datasets.memory_dataset import MemoryDataset
from switch_nerf_torch.datasets.ray_utils import get_ray_directions, get_rays
from switch_nerf_torch.models.experts import gathered, hold_whole
from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
from switch_nerf_torch.trainer import (SceneInfo, TrainState,
                                       create_train_state, make_eval_step,
                                       make_train_step,
                                       render_config_from_hparams)
from switch_nerf_torch.utils.logger import main_log, setup_logger
from switch_nerf_torch.utils.meters import DictAverageMeter, allgather_json
from switch_nerf_torch.utils.visualize import visualize_scalars


def _install_term_latch() -> dict:
    """Latch SIGTERM so the train loop can finish its step, save a
    resumable checkpoint and return (a preempted job keeps its progress).
    Outside the main thread no handler can be installed; the latch then
    never fires."""
    latch = {"requested": False, "prev": None, "installed": False}

    def _on_term(signum, frame):
        latch["requested"] = True

    try:
        latch["prev"] = signal.signal(signal.SIGTERM, _on_term)
        latch["installed"] = True
    except ValueError:          # not the main thread
        pass
    return latch


def _release_term_latch(latch: dict) -> None:
    if latch["installed"]:
        signal.signal(signal.SIGTERM, latch["prev"])
        latch["installed"] = False


# the most points of one no-drop model call of eval_points (its published
# 65,536-ray requests hold 16.8M points a pass)
POINTS_CALL_ROWS = 1 << 22

# the chunked datasets: a cursor to save, a prefetch worker to stop
_CHUNKED = (FilesystemDataset, BlockFilesystemDataset)


def _to_host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _whole_model(method: Callable) -> Callable:
    """Run an eval method ``method(self, state, ...)`` with the whole
    model: under expert parallelism each rank gathers the experts from
    their owners first (every rank then renders its own images alone)."""
    @functools.wraps(method)
    def run(self, state, *args, **kwargs):
        with gathered(state.model):
            return method(self, state, *args, **kwargs)
    return run


def _param_count(state: TrainState) -> int:
    """The whole model's parameter count (a rank of an expert-parallel
    run holds part of the experts)."""
    tree = bridge.jax_state_shapes(state.model, state.bg_model)

    def count(t):
        return (sum(count(v) for v in t.values()) if isinstance(t, dict)
                else int(np.prod(t.shape)))
    return count(tree)


class Runner:
    def __init__(self, hparams: Namespace, set_experiment_path: bool = True,
                 *, device=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.data_type = getattr(hparams, "data_type", "mega_nerf")
        self.rank, self.world = parallel.rank(), parallel.world_size()
        # under expert parallelism the models built below hold this rank's
        # block of experts (models/model_utils.get_nerf)
        self.mesh = parallel.setup_mesh(hparams, self.world, self.rank)

        np.random.seed(hparams.random_seed)
        random.seed(hparams.random_seed)

        # fail fast on LPIPS misconfiguration (set-but-missing env path or
        # malformed weights npz), not at the first val image
        M.validate_lpips_setup()
        self._audit_flag_semantics()

        self._eval_step = None
        if self.data_type == "nerf":
            self._init_nerf(set_experiment_path)
        elif self.data_type == "block_nerf":
            self._init_block(set_experiment_path)
        else:
            self._init_mega(set_experiment_path)

    # ------------------------------------------------------------ init ---
    def _audit_flag_semantics(self) -> None:
        """No reference flag may silently change nothing: a name flag that
        disagrees with the structural selection is a configuration error,
        and flags whose reference job is unnecessary here note so once."""
        h = self.hparams

        if self.data_type == "nerf":
            structural_step = ("_training_step_nerf_mip" if h.use_mip
                               else "_training_step_nerf")
        else:
            structural_step = ("_training_step_mip" if h.use_mip
                               else "_training_step")
        flag = getattr(h, "training_step_fn", None)
        if flag is not None and flag != structural_step:
            raise ValueError(
                f"--training_step_fn {flag!r} conflicts with the "
                f"structural selection {structural_step!r} (from "
                f"data_type={self.data_type!r}, use_mip={bool(h.use_mip)})."
                " This framework derives the training step from those "
                "flags; pass --use_mip / the matching data_type instead.")

        if self.data_type == "block_nerf":
            structural_render = "render_image_blocknerf"
        elif self.data_type == "nerf":
            structural_render = ("render_image_nerf_mip" if h.use_mip
                                 else "render_image_nerf")
        else:
            structural_render = "render_image"
        flag = getattr(h, "render_image_fn_name", None)
        if flag is not None and flag != structural_render:
            raise ValueError(
                f"--render_image_fn_name {flag!r} conflicts with the "
                f"structural selection {structural_render!r} (from "
                f"data_type={self.data_type!r}, use_mip={bool(h.use_mip)}).")

        # flags whose reference job is unnecessary by design (stacked
        # expert parameters need no checkpoint reshape; no DDP/DataLoader;
        # --set_timeout is read where the process group starts,
        # utils/crash.cli_entry)
        if getattr(h, "expertmlp2seqexperts", False):
            main_log("NOTE: --expertmlp2seqexperts is unnecessary by "
                     "design (stacked expert params serve train and eval);"
                     " ignored, checkpoints load directly.")
        elif (getattr(h, "moe_layer_num", 1) != 1
                or getattr(h, "moe_layer_ids", None) is not None):
            main_log("NOTE: --moe_layer_num/--moe_layer_ids only steer the "
                     "reference's expertmlp2seqexperts checkpoint reshape, "
                     "which is unnecessary by design here; ignored.")
        if getattr(h, "find_unused_parameters", False):
            main_log("NOTE: --find_unused_parameters configures torch DDP, "
                     "which the port does not use (a parameter with no "
                     "gradient averages zeros); ignored.")
        if getattr(h, "data_loader_num_workers", 1) != 1:
            main_log("NOTE: --data_loader_num_workers sizes the torch "
                     "DataLoader pool of training; ignored by eval.")

        if h.use_moe and not getattr(h, "moe_test_batch", False):
            main_log("NOTE: eval dispatch = nodrop (no --moe_test_batch), "
                     "the reference default; every published eval command "
                     "passes --moe_test_batch (padded dispatch, measured "
                     "~1.5x faster at identical metrics).")

    def _setup_dirs(self, set_experiment_path: bool):
        """The experiment dir, the same on every rank; its files, the log
        file and TensorBoard are rank 0's."""
        self.writer = None
        if set_experiment_path:
            self.experiment_path = self._get_experiment_path()
            self.model_path = self.experiment_path / "models"
            self.logger = setup_logger(None, self.experiment_path)
            if not parallel.is_main():
                return
            self.model_path.mkdir(parents=True, exist_ok=True)
            from switch_nerf_torch.utils.tb import SummaryWriter
            self.writer = SummaryWriter(self.experiment_path / "tb")
            (self.experiment_path / "hparams.txt").write_text(
                str(vars(self.hparams)))
            (self.experiment_path / "command.txt").write_text(
                " ".join(sys.argv))
            if self.hparams.config_file is not None and \
                    Path(self.hparams.config_file).exists():
                shutil.copy(self.hparams.config_file, self.experiment_path)
            self._write_git_info()
        else:
            self.experiment_path = None
            self.model_path = None
            self.logger = setup_logger(None, None)

    def _write_git_info(self) -> None:
        """git provenance, best-effort: the install may not be a checkout."""
        cwd = Path(__file__).resolve().parent
        try:
            commit, branch = (subprocess.run(
                ["git", *args], capture_output=True, text=True, timeout=10,
                cwd=cwd).stdout.strip()
                for args in (["rev-parse", "HEAD"],
                             ["rev-parse", "--abbrev-ref", "HEAD"]))
        except (OSError, subprocess.SubprocessError):
            return
        if commit:
            (self.experiment_path / "git_info.txt").write_text(
                f"commit: {commit}\nbranch: {branch}\n")

    def _get_experiment_path(self) -> Path:
        """The next versioned experiment dir: rank 0 picks it and sends it
        to the others (ranks scanning one filesystem at once could claim
        different versions)."""
        chosen = str(self._next_version_dir()) if parallel.is_main() else ""
        return Path(parallel.broadcast_str(chosen))

    def _next_version_dir(self) -> Path:
        exp_dir = Path(self.hparams.exp_name)
        exp_dir.mkdir(parents=True, exist_ok=True)
        existing = [int(p.name) for p in exp_dir.iterdir()
                    if p.is_dir() and p.name.isdigit()]
        version = max(existing) + 1 if existing else 0
        path = exp_dir / str(version)
        path.mkdir(parents=True, exist_ok=True)
        return path

    def _init_mega(self, set_experiment_path: bool):
        h = self.hparams
        self._setup_dirs(set_experiment_path)

        coord = torch.load(Path(h.dataset_path) / "coordinates.pt",
                           map_location="cpu", weights_only=False)
        self.origin_drb = np.asarray(coord["origin_drb"], np.float32)
        self.pose_scale_factor = float(coord["pose_scale_factor"])
        main_log(f"Origin: {self.origin_drb}, scale factor: "
                 f"{self.pose_scale_factor}")

        self.near = h.near / self.pose_scale_factor
        if h.far is not None:
            self.far = h.far / self.pose_scale_factor
        elif h.bg_nerf:
            self.far = 1e5
        else:
            self.far = 2.0

        self.ray_altitude_range = (
            [(x - self.origin_drb[0]) / self.pose_scale_factor
             for x in h.ray_altitude_range]
            if h.ray_altitude_range is not None else None)
        alt = self.ray_altitude_range
        if alt is not None and not alt[0] < alt[1]:
            raise ValueError(f"--ray_altitude_range {h.ray_altitude_range} "
                             "must be increasing")

        self.train_items, self.val_items = self._get_image_metadata()
        main_log(f"Using {len(self.train_items)} train images and "
                 f"{len(self.val_items)} val images")

        cams = np.stack([x.c2w[:3, 3] for x in
                         self.train_items + self.val_items])
        min_pos, max_pos = cams.min(0), cams.max(0)

        self.nerf = get_nerf(h, len(self.train_items), device=self.device)
        self.bg_nerf = (get_bg_nerf(h, len(self.train_items),
                                    device=self.device)
                        if h.bg_nerf else None)

        # ellipse foreground bounds
        if self.bg_nerf is not None and h.ellipse_bounds:
            if h.ray_altitude_range is None:
                raise ValueError("--ellipse_bounds needs --ray_altitude_range")
            ground = cams.copy()
            ground[:, 0] = self.ray_altitude_range[1]
            air = cams.copy()
            air[:, 0] = self.ray_altitude_range[0]
            used = np.concatenate([cams, air, ground])
            max_pos = max_pos.copy()
            max_pos[0] = self.ray_altitude_range[1]
            center = (max_pos + min_pos) * 0.5
            radius = (max_pos - min_pos) * 0.5
            scale = np.linalg.norm((used - center) / radius, axis=-1).max()
            radius = radius * scale * h.ellipse_scale_factor
            self.sphere_center = np.asarray(center, np.float32)
            self.sphere_radius = np.asarray(radius, np.float32)
        else:
            self.sphere_center = None
            self.sphere_radius = None

        self.mip = bool(h.use_mip)
        self.appearance_count = len(self.train_items)

    def _init_block(self, set_experiment_path: bool):
        """A Block-NeRF scene: literal near/far, no background model, no
        scene sphere, mip rendering, one appearance embedding per id of the
        hash -> id map."""
        h = self.hparams
        self._setup_dirs(set_experiment_path)
        self.near = h.near
        self.far = h.far if h.far is not None else 10.0
        self.ray_altitude_range = None
        self.origin_drb = None
        self.pose_scale_factor = 1.0
        self.train_items, self.val_items = [], []
        with open(h.block_image_hash_id_map_path) as f:
            self.image_hash_id_map = json.load(f)

        def _max_id(obj):
            if isinstance(obj, dict):
                return max((_max_id(v) for v in obj.values()), default=-1)
            return int(obj)
        self.appearance_count = _max_id(self.image_hash_id_map) + 1 or 1
        self.nerf = get_nerf(h, self.appearance_count, device=self.device)
        self.bg_nerf = None
        self.sphere_center = None
        self.sphere_radius = None
        self.mip = True

    def _init_nerf(self, set_experiment_path: bool):
        """A classic-NeRF scene (the Bungee loader; the others raise): all
        rays in host memory, no background model, no scene sphere."""
        from switch_nerf_torch.datasets.nerf_data import (
            NeRFDataset, NeRFDatasetTest, NeRFDatasetTrain, NeRFDatasetVal)
        h = self.hparams
        self._setup_dirs(set_experiment_path)
        self.nerf_dataset = NeRFDataset(get_nerf_dataset_args(h))
        self.train_set = NeRFDatasetTrain(self.nerf_dataset,
                                          seed=h.random_seed)
        self.val_set = NeRFDatasetVal(self.nerf_dataset)
        self.test_set = NeRFDatasetTest(self.nerf_dataset)
        self.near = self.nerf_dataset.near
        self.far = self.nerf_dataset.far
        self.ray_altitude_range = None
        self.appearance_count = max(len(self.nerf_dataset.poses), 1)
        self.nerf = get_nerf(h, self.appearance_count, device=self.device)
        self.bg_nerf = None
        self.sphere_center = None
        self.sphere_radius = None
        self.mip = bool(h.use_mip)

    def _get_image_metadata(self) -> Tuple[List[ImageMetadata],
                                           List[ImageMetadata]]:
        """Mega-NeRF dataset layout discovery."""
        h = self.hparams
        dataset_path = Path(h.dataset_path)
        train_candidates = sorted(
            (dataset_path / "train" / "metadata").iterdir())
        train_paths = [train_candidates[i] for i in
                       range(0, len(train_candidates), h.train_every)]
        val_paths = sorted((dataset_path / "val" / "metadata").iterdir())
        train_paths += val_paths
        train_paths.sort(key=lambda x: x.name)
        val_set = set(val_paths)
        image_indices = {p.name: i for i, p in enumerate(train_paths)}
        train_items = [self._get_metadata_item(
            x, image_indices[x.name], h.train_scale_factor, x in val_set)
            for x in train_paths]
        if self.experiment_path is not None and parallel.is_main():
            # the reference's '{index},{rgb filename}' record
            (self.experiment_path / "image_indices.txt").write_text(
                "".join(f"{it.image_index},{it.image_path.name}\n"
                        for it in train_items))
        val_items = [self._get_metadata_item(
            x, image_indices[x.name], h.val_scale_factor, True)
            for x in val_paths]
        return train_items, val_items

    def _get_metadata_item(self, metadata_path: Path, image_index: int,
                           scale_factor: int, is_val: bool) -> ImageMetadata:
        h = self.hparams
        image_path = None
        for ext in (".jpg", ".JPG", ".png", ".PNG"):
            candidate = (metadata_path.parent.parent / "rgbs"
                         / f"{metadata_path.stem}{ext}")
            if candidate.exists():
                image_path = candidate
                break
        if image_path is None:
            raise FileNotFoundError(f"no rgbs/{metadata_path.stem}.(jpg|png) "
                                    f"beside {metadata_path}")
        md = torch.load(metadata_path, map_location="cpu", weights_only=False)
        intrinsics = np.asarray(md["intrinsics"], np.float32) / scale_factor
        if md["W"] % scale_factor or md["H"] % scale_factor:
            raise ValueError(f"{metadata_path}: {md['W']}x{md['H']} is not "
                             f"divisible by the scale factor {scale_factor}")

        dataset_mask = (metadata_path.parent.parent.parent / "masks"
                        / metadata_path.name)
        if h.cluster_mask_path is not None:
            mask_path = Path(h.cluster_mask_path) / metadata_path.name
        elif dataset_mask.exists():
            mask_path = dataset_mask
        else:
            mask_path = None
        return ImageMetadata(
            image_path, np.asarray(md["c2w"], np.float32),
            md["W"] // scale_factor, md["H"] // scale_factor, intrinsics,
            image_index, None if (is_val and h.all_val) else mask_path,
            is_val)

    # ------------------------------------------------------------- eval ---
    def _load_eval_state(self) -> TrainState:
        h = self.hparams
        if h.ckpt_path is None and getattr(h, "container_path", None):
            # a packaged container (container.py) carries its own model
            # config and parameters; the state's step is 0, as JAX's
            from switch_nerf_torch.container import load_container
            self.nerf, self.bg_nerf, _ = load_container(
                h.container_path, device=self.device)
            self._eval_step = None
            state = create_train_state(h, self.nerf, self.bg_nerf,
                                       device=self.device, for_training=False)
            hold_whole(state.model)
            return state
        if h.ckpt_path is None:
            raise ValueError("--ckpt_path (or --container_path) required "
                             "for eval")
        state = create_train_state(h, self.nerf, self.bg_nerf,
                                   device=self.device, for_training=False)
        state, _ = load_checkpoint(h.ckpt_path, state,
                                   restore_rng_states=False)
        # an eval runs the whole model: the experts gathered once
        hold_whole(state.model)
        return state

    def _make_render_fn(self, state: TrainState) -> Callable:
        # one eval step per Runner: the state's modules are updated in
        # place, so periodic validation reuses it
        if self._eval_step is None:
            self._eval_step = make_eval_step(
                state.model, state.bg_model, self.hparams,
                render_config_from_hparams(self.hparams),
                SceneInfo(self.sphere_center, self.sphere_radius),
                mip=self.mip, device=self.device)
        return self._batched_collective_fn(self._eval_step)

    def _batched_collective_fn(self, program: Callable) -> Callable:
        h = self.hparams
        dev = self.device

        def padded(a: np.ndarray, lo: int, bs: int) -> torch.Tensor:
            """Rows lo .. lo + bs of `a`, padded with copies of its last."""
            r = a[lo:lo + bs]
            if r.shape[0] < bs:
                r = np.concatenate(
                    [r, np.repeat(r[-1:], bs - r.shape[0], 0)], 0)
            return torch.from_numpy(np.ascontiguousarray(r, np.float32)).to(
                dev)

        def render_chunks(rays: np.ndarray, image_index: float,
                          radii: Optional[np.ndarray] = None
                          ) -> Dict[str, np.ndarray]:
            """Render any ray count (with the mip renderer, their radii
            [N, 1]) in requests of image_pixel_batch_size rays (the last
            padded with copies of its last ray, so every request has one
            shape); outputs trimmed to the real rays."""
            n = rays.shape[0]
            bs = h.image_pixel_batch_size
            out: Dict[str, List[np.ndarray]] = {}
            for lo in range(0, n, bs):
                pad = max(lo + bs - n, 0)
                batch = {"rays": padded(rays, lo, bs),
                         "image_indices": torch.full(
                             (bs,), image_index, dtype=torch.float32,
                             device=dev)}
                if radii is not None:
                    batch["radii"] = padded(radii, lo, bs)
                res = program(batch)
                keep = bs - pad
                for k, v in res.items():
                    if v.dim() >= 1 and v.shape[0] == bs:
                        out.setdefault(k, []).append(_to_host(v[:keep]))
            return {k: np.concatenate(v) for k, v in out.items()}
        return render_chunks

    def render_image(self, metadata: ImageMetadata, render_chunks
                     ) -> Dict[str, np.ndarray]:
        """Whole-image render: results reshaped to [H, W, ...]."""
        directions = get_ray_directions(
            metadata.W, metadata.H, metadata.intrinsics[0],
            metadata.intrinsics[1], metadata.intrinsics[2],
            metadata.intrinsics[3], self.hparams.center_pixels)
        rays = get_rays(directions, metadata.c2w, self.near, self.far,
                        self.ray_altitude_range).reshape(-1, 8)
        res = render_chunks(rays, float(metadata.image_index))
        h, w = metadata.H, metadata.W
        return {k: v.reshape(h, w, *v.shape[1:]) for k, v in res.items()}

    def _peak_memory_mib(self) -> float:
        """torch.cuda.max_memory_allocated of the device, MiB (the
        reference's own call); 0.0 on the CPU."""
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.max_memory_allocated(self.device) / 2 ** 20

    def _image_metrics_half(self, pred: np.ndarray, gt: np.ndarray,
                            valid_mask: Optional[np.ndarray] = None
                            ) -> Dict[str, float]:
        """Right-half PSNR/SSIM/LPIPS on the runner's device, in the
        reference's field order: psnr, ssim[, psnr_mask, ssim_mask],
        lpips-*."""
        half = gt.shape[1] // 2
        pred_r = torch.from_numpy(np.ascontiguousarray(pred[:, half:])).to(
            self.device)
        gt_r = torch.from_numpy(np.ascontiguousarray(gt[:, half:])).to(
            self.device)
        out = {"psnr": M.psnr(pred_r, gt_r),
               "ssim": M.ssim(pred_r, gt_r, 1.0)}
        if valid_mask is not None:
            mask_r = valid_mask[:, half:]
            out["psnr_mask"] = M.psnr_mask(pred_r, gt_r, mask_r)
            out["ssim_mask"] = M.ssim_mask(pred_r, gt_r, 1.0, mask_r)
        for k, v in M.lpips(pred_r, gt_r).items():
            if v is not None:
                out[f"lpips-{k}"] = v
        return out

    @staticmethod
    def _agg_key(k: str) -> str:
        """Per-image metric name -> the reference's aggregate metric key
        ('psnr' -> 'val/psnr', 'lpips-vgg' -> 'val/lpips/vgg')."""
        if k.startswith("val/"):
            return k
        if k.startswith("lpips-"):
            return "val/lpips/" + k[len("lpips-"):]
        return f"val/{k}"

    def _write_final_metrics(self, means: Dict[str, float]) -> None:
        """experiment_path/metrics.txt: 'Average val/<metric>: <value>'
        (rank 0)."""
        if self.experiment_path is None or not parallel.is_main():
            return
        with (self.experiment_path / "metrics.txt").open("w") as f:
            for k, v in means.items():
                msg = f"Average {self._agg_key(k)}: {v}"
                main_log(msg)
                f.write(msg + "\n")

    @staticmethod
    def _pred_gt(metadata: ImageMetadata, results):
        """(typ, the clipped prediction, the ground truth in [0, 1])."""
        typ = "fine" if "rgb_fine" in results else "coarse"
        pred = np.clip(results[f"rgb_{typ}"], 0.0, 1.0)
        gt = metadata.load_image().astype(np.float32) / 255.0
        return typ, pred, gt

    def _owns(self, i: int) -> bool:
        """Image i belongs to rank i % W, which renders it whole and writes
        its files (the reference's rank striding)."""
        return i % self.world == self.rank

    def _gather_image_metrics(self, local: Dict[int, Dict[str, float]],
                              what: str = "val") -> Dict[int, Dict[str, float]]:
        """Every rank's per-image metrics, by image, on every rank; logged
        (rank 0) in image order."""
        merged: Dict[int, Dict[str, float]] = {}
        for d in allgather_json({str(k): v for k, v in local.items()}):
            merged.update({int(k): v for k, v in d.items()})
        merged = dict(sorted(merged.items()))
        for i, im in merged.items():
            main_log(f"{what} image {i}: " + " ".join(
                f"{k}={v:.4f}" for k, v in im.items()))
        return merged

    def _log_per_image(self, per_image: Dict[int, Dict[str, float]],
                       step: int) -> None:
        if self.writer is None:
            return
        for i, im in sorted(per_image.items()):
            for k, v in im.items():
                self.writer.add_scalar(f"{self._agg_key(k)}/{i}", v, step)

    @_whole_model
    def _run_validation(self, state: TrainState,
                        train_index: Optional[int] = None
                        ) -> Dict[str, float]:
        """Validation-protocol eval: right-half PSNR/SSIM/LPIPS per val
        image, logged per image as val/<metric>/<i>; returns the means
        under their val/ keys."""
        if train_index is None:
            train_index = int(state.step)
        render_chunks = self._make_render_fn(state)
        meter = DictAverageMeter()
        per_image: Dict[int, Dict[str, float]] = {}
        for i, metadata in enumerate(self.val_items):
            if not self._owns(i):
                continue
            results = self.render_image(metadata, render_chunks)
            _, pred, gt = self._pred_gt(metadata, results)
            img_metrics = self._image_metrics_half(pred, gt)
            meter.update(img_metrics)
            per_image[i] = img_metrics
        self._log_per_image(self._gather_image_metrics(per_image),
                            train_index)
        means = {self._agg_key(k): v
                 for k, v in meter.mean_across_processes().items()}
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(f"{k}/avg", v, train_index)
            self.writer.flush()
        main_log("val means: " + " ".join(f"{k}={v:.4f}"
                                          for k, v in means.items()))
        return means

    @_whole_model
    def _run_validation_image(self, state: TrainState) -> Dict[str, float]:
        """Right-half val-image protocol with per-image time/memory and the
        reference file set: images/metrics_{i}.txt + {i}_gt/_pred/_depth
        panel crops (+ _bg/_fg sets), val_images/{i}.jpg triptychs,
        per-image scalars and the 'Average val/...' metrics.txt."""
        render_chunks = self._make_render_fn(state)
        meter = DictAverageMeter()
        per_image: Dict[int, Dict[str, float]] = {}
        images_dir = val_images_dir = None
        if self.experiment_path is not None:
            images_dir = self.experiment_path / "images"
            val_images_dir = self.experiment_path / "val_images"

        for i, metadata in enumerate(self.val_items):
            if not self._owns(i):
                continue
            t0 = time.time()
            results = self.render_image(metadata, render_chunks)
            render_time = time.time() - t0
            typ, pred, gt = self._pred_gt(metadata, results)

            img_metrics = self._image_metrics_half(pred, gt)
            # the reference's metrics_{i}.txt fields: psnr, ssim, lpips-*,
            # time, memory
            img_metrics["time"] = render_time
            img_metrics["memory"] = self._peak_memory_mib()
            meter.update(img_metrics)
            per_image[i] = img_metrics

            if images_dir is not None:
                self._write_reference_val_files(
                    images_dir, val_images_dir, i, gt, pred, results, typ,
                    img_metrics)

        self._log_per_image(self._gather_image_metrics(per_image),
                            int(state.step))
        if self.writer is not None:
            self.writer.flush()
        means = meter.mean_across_processes()
        main_log("val means: " + " ".join(f"{k}={v:.4f}"
                                          for k, v in means.items()))
        self._write_final_metrics(means)
        return means

    @staticmethod
    def _depth_for_viz(results, typ) -> Optional[np.ndarray]:
        """Depth panel input, clamped at the 0.95 quantile of the
        foreground depth when the render carries one (subsampled by 2
        while > 2^24 values), so background distances don't wash out the
        foreground range."""
        depth = results.get(f"depth_{typ}")
        if depth is None:
            return None
        depth = np.asarray(depth, np.float32)
        fg = results.get(f"fg_depth_{typ}")
        if fg is not None:
            to_use = np.asarray(fg, np.float32).reshape(-1)
            while to_use.shape[0] > 2 ** 24:
                to_use = to_use[::2]
            depth = np.minimum(depth, np.quantile(to_use, 0.95))
        return depth

    @staticmethod
    def _result_image(gt, pred, depth=None, colormap=None) -> np.ndarray:
        """gt | pred | colormapped-depth uint8 triptych."""
        trip = [np.asarray(gt)[..., :3],
                np.clip(np.asarray(pred), 0.0, 1.0)[..., :3]]
        if depth is not None:
            trip.append(visualize_scalars(
                np.asarray(depth),
                colormap=colormap).astype(np.float32) / 255.0)
        img = np.concatenate(trip, axis=1)
        return (img * 255).astype(np.uint8)

    @staticmethod
    def _save_triptych(path: Path, gt, pred, depth=None):
        from PIL import Image
        Image.fromarray(Runner._result_image(gt, pred, depth)).save(path)

    @staticmethod
    def _save_panel_crops(arr: np.ndarray, images_dir: Path, key,
                          suffix: str = ""):
        """{i}_gt/_pred/_depth{suffix}.jpg third-crops of the triptych."""
        from PIL import Image
        img = Image.fromarray(arr)
        w, hgt = img.size
        for ci, suf in enumerate(("gt", "pred", "depth")):
            box = (w // 3 * ci, 0, w // 3 * (ci + 1), hgt)
            img.crop(box).save(images_dir / f"{key}_{suf}{suffix}.jpg")

    def _write_reference_val_files(self, images_dir: Path,
                                   val_images_dir: Path, key,
                                   gt, pred, results, typ,
                                   metrics_txt: Dict[str, float]) -> None:
        """Per-image eval files: metrics_{i}.txt, the triptych, its
        gt/pred/depth third-crops, and the bg/fg decomposition sets when the
        render carries the split."""
        from PIL import Image
        images_dir.mkdir(parents=True, exist_ok=True)
        val_images_dir.mkdir(parents=True, exist_ok=True)
        with (images_dir / f"metrics_{key}.txt").open("w") as f:
            for k, v in metrics_txt.items():
                f.write(f"{k}: {v}\n")
        gt = np.asarray(gt, np.float32)
        arr = self._result_image(gt, pred, self._depth_for_viz(results, typ))
        Image.fromarray(arr).save(val_images_dir / f"{key}.jpg")
        if arr.shape[1] == 3 * gt.shape[1]:     # depth panel present
            self._save_panel_crops(arr, images_dir, key)
        if not getattr(self.hparams, "bg_nerf", False):
            return
        # bg/fg decomposition: a fine render may carry only coarse bg
        # outputs -> fall back to coarse
        bg_typ = typ if f"bg_rgb_{typ}" in results else "coarse"
        if f"bg_rgb_{bg_typ}" not in results:
            return
        for sub, sub_typ in (("bg", bg_typ), ("fg", typ)):
            if f"{sub}_rgb_{sub_typ}" not in results:
                continue
            rgb = np.asarray(
                results[f"{sub}_rgb_{sub_typ}"]).reshape(gt.shape)
            depth = results.get(f"{sub}_depth_{sub_typ}")
            arr = self._result_image(gt, rgb, depth)
            Image.fromarray(arr).save(val_images_dir / f"{key}_{sub}.jpg")
            if depth is not None:
                self._save_panel_crops(arr, images_dir, key, f"_{sub}")

    # ------------------------------------------- public eval entrypoints --
    def eval(self) -> Dict[str, float]:
        """Validation-protocol eval (the reference's eval.py)."""
        state = self._load_eval_state()
        means = self._run_validation(state, 0)
        self._write_final_metrics(means)
        return means

    def eval_image(self) -> Dict[str, float]:
        """The published eval command (the reference's eval_image.py)."""
        state = self._load_eval_state()
        return self._run_validation_image(state)

    # ------------------------------------------------------------ train ---
    def train(self) -> Optional[TrainState]:
        """Mega-NeRF and Block-NeRF chunked training (the JAX package's
        ``Runner.train``); Block-NeRF batches carry the mip radii into the
        mip train step. Returns the final train state (None after
        --generate_chunk, which stops once the chunks are written)."""
        h = self.hparams
        # latched from the start: a SIGTERM during setup still ends in a
        # checkpointed return
        term = _install_term_latch()
        dataset = None
        try:
            state = create_train_state(h, self.nerf, self.bg_nerf,
                                       device=self.device)
            main_log(f"Total parameters number is "
                     f"{_param_count(state) / 1024 / 1024:.4f}"
                     " M")
            main_log(self._mesh_line())
            dataset_state, discard_index, host_iteration = None, -1, None
            if h.ckpt_path is not None:
                state, extra = load_checkpoint(h.ckpt_path, state,
                                               h.resume_ckpt_state)
                if h.resume_ckpt_state:
                    # the cursor is part of exact resume only
                    dataset_state = extra.get("dataset_state")
                    discard_index = extra.get("dataset_index", -1)
                    host_iteration = extra.get("host_iteration")
                main_log(f"Resumed from iteration {state.step}")
            self._broadcast_params(state)
            train_step = make_train_step(
                h, render_config_from_hparams(h),
                SceneInfo(self.sphere_center, self.sphere_radius),
                mip=self.mip, device=self.device)
            dataset = self._make_dataset(dataset_state)
            if h.generate_chunk:
                main_log("Chunk generated")
                return None
            return self._train_loop(state, train_step, dataset, term,
                                    discard_index, host_iteration)
        finally:
            if isinstance(dataset, _CHUNKED):
                dataset.close()
            _release_term_latch(term)

    def _mesh_line(self) -> str:
        if self.mesh is None:
            return f"mesh (data, expert) = ({self.world}, 1): data parallel"
        return (f"mesh (data, expert) = ({self.mesh.data}, "
                f"{self.mesh.expert}): expert parallel, "
                f"{self.hparams.moe_expert_num // self.mesh.expert} experts "
                "a rank")

    def _broadcast_params(self, state: TrainState) -> None:
        """The replicas start from rank 0's parameters; under expert
        parallelism each block of experts from its owner on data row 0."""
        params = state.parameters()
        own = [p for p in params if getattr(p, "expert_mesh", None) is None]
        parallel.broadcast_tensors_(own)
        if self.mesh is not None and self.mesh.data > 1:
            parallel.broadcast_tensors_(
                [p for p in params
                 if getattr(p, "expert_mesh", None) is not None],
                src=self.mesh.e_index, group=self.mesh.data_group)

    def _make_dataset(self, dataset_state: Optional[str]):
        h = self.hparams
        if h.dataset_type == "filesystem":
            if not h.chunk_paths:
                raise ValueError("--dataset_type filesystem needs "
                                 "--chunk_paths")
            if self.data_type == "block_nerf":
                dataset = BlockFilesystemDataset(
                    data_path=h.dataset_path, near=self.near, far=self.far,
                    scale_factor=h.train_scale_factor,
                    list_path=h.block_train_list_path,
                    id_map_path=h.block_image_hash_id_map_path,
                    chunk_paths=[Path(x) for x in sorted(h.chunk_paths)],
                    num_chunks=h.num_chunks,
                    disk_flush_size=h.disk_flush_size,
                    shuffle_chunk=h.shuffle_chunk, seed=h.random_seed)
            else:
                dataset = FilesystemDataset(
                    self.train_items, self.near, self.far,
                    self.ray_altitude_range, h.center_pixels,
                    [Path(x) for x in sorted(h.chunk_paths)], h.num_chunks,
                    h.train_scale_factor, h.disk_flush_size,
                    h.shuffle_chunk, seed=h.random_seed)
            if dataset_state is not None:
                dataset.set_state(dataset_state)
            return dataset
        if h.dataset_type == "memory":
            if self.data_type == "block_nerf":
                raise ValueError("Block-NeRF scenes train from the chunked "
                                 "filesystem dataset (--dataset_type "
                                 "filesystem --chunk_paths DIR)")
            return MemoryDataset(self.train_items, self.near, self.far,
                                 self.ray_altitude_range, h.center_pixels,
                                 seed=h.random_seed)
        raise ValueError(f"Unrecognized dataset type {h.dataset_type}")

    def _feed_size(self, local: bool) -> int:
        """Rows a rank draws a step: the global --batch_size, or its share
        when the dataset strides its rows over the ranks (``local``)."""
        bs = self.hparams.batch_size
        if self.world > 1 and bs % self.world:
            raise ValueError(f"--batch_size {bs} is not divisible by the "
                             f"{self.world} processes")
        return bs // self.world if local else bs

    def _put_batch(self, batch: Dict[str, np.ndarray], local: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """A numpy batch as float32 tensors on the runner's device. In a
        process group a global batch (``local`` False: the same on every
        rank) is cut to this rank's rows [r B / W, (r + 1) B / W); a
        ``local`` one is the rank's share already."""
        if self.world > 1 and not local:
            n = next(iter(batch.values())).shape[0] // self.world
            batch = {k: v[self.rank * n:(self.rank + 1) * n]
                     for k, v in batch.items()}
        return {k: torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
                for k, v in batch.items()}

    def _train_loop(self, state: TrainState, train_step, dataset, term: dict,
                    discard_index: int, host_iteration: Optional[int]
                    ) -> TrainState:
        h = self.hparams
        filesystem = isinstance(dataset, _CHUNKED)
        if not filesystem:
            # memory batches are keyed by the counter: nothing to skip
            discard_index = -1
        # the chunked datasets stride their rows over the ranks and yield a
        # rank's share; the memory dataset yields the global batch
        local = filesystem and self.world > 1
        feed = self._feed_size(local)
        # the batch counter resumes from host_iteration, not state.step: a
        # skipped non-finite step consumes a batch without advancing the
        # step, and the counter keys the memory batches
        it = int(host_iteration) if host_iteration is not None else state.step
        window_start, window_it = time.time(), it
        data_time = 0.0      # batch gathers and host-to-device copies
        prof = None

        def save() -> None:
            save_checkpoint(
                self.model_path, state,
                dataset_state=dataset.get_state() if filesystem else None,
                dataset_index=dataset_index, keep=h.ckpt_keep,
                host_iteration=it)

        while it < h.train_iterations:
            if filesystem:
                t0 = time.time()
                dataset.load_chunk()
                main_log(f"Chunk {dataset.get_state()} loaded in "
                         f"{time.time() - t0:.2f} s")
                batches = enumerate(dataset.sample_batches(feed))
            else:
                batches = enumerate(dataset.get_batch(b, feed)
                                    for b in itertools.count(it))
            while True:
                t_data = time.perf_counter()
                try:
                    dataset_index, batch = next(batches)
                except StopIteration:
                    break
                if dataset_index <= discard_index:
                    continue            # trained before the checkpoint
                discard_index = -1
                batch = self._put_batch(batch, local)
                data_time += time.perf_counter() - t_data
                if h.profile_trace_step is not None:
                    # a three-step trace window
                    if it == h.profile_trace_step:
                        prof = self._start_trace()
                    elif prof is not None \
                            and it == h.profile_trace_step + 3:
                        prof = self._stop_trace(prof)
                state, m = train_step(state, batch)
                it += 1

                if it % h.i_print == 0:
                    self._log_window(it, it - window_it, m,
                                     time.time() - window_start, data_time)
                    data_time = 0.0
                    window_start, window_it = time.time(), it

                if self.model_path is not None and it % h.ckpt_interval == 0:
                    save()
                    main_log(f"Saved checkpoint at {it}")

                if it % h.val_interval == 0:
                    self._run_validation(state, it)

                if self._term_agreed(term, it):
                    # the latch stays installed through the save: a second
                    # SIGTERM must not kill the process mid-checkpoint
                    if prof is not None:
                        prof = self._stop_trace(prof)
                    if self.model_path is not None:
                        save()
                    main_log(f"SIGTERM: checkpoint saved at iteration {it}; "
                             "exiting")
                    return state

                if it >= h.train_iterations:
                    break

        if prof is not None:          # training ended inside the window
            self._stop_trace(prof)
        if self.model_path is not None:
            save_checkpoint(self.model_path, state)
        main_log("Training complete")
        return state

    def _term_agreed(self, term: dict, it: int) -> bool:
        """Whether to save and return on a SIGTERM. In a process group the
        ranks agree by a global OR every 10 steps (a signal reaches them at
        different steps), so every rank saves at the same step."""
        if self.world == 1:
            return term["requested"]
        return it % 10 == 0 and parallel.any_true(term["requested"])

    def _log_window(self, it: int, steps: int,
                    metrics: Dict[str, torch.Tensor], window: float,
                    data_time: float) -> None:
        """The --i_print line and TensorBoard scalars: the step's metrics,
        the mean data and forward/backward seconds per step of the window's
        `steps` steps, rays/s (from the second window on), and with
        --compute_memory the peak device memory (MiB). A window cut short
        by a resume counts its own steps (the JAX package divides by
        --i_print)."""
        h = self.hparams
        m_host = {k: float(v) for k, v in metrics.items()}
        rate = (steps * h.batch_size / max(window, 1e-9)
                if it > h.i_print else 0.0)
        m_host["data_sample_time"] = data_time / steps
        m_host["fwd_bwd_time"] = max(window - data_time, 0.0) / steps
        if h.compute_memory:
            m_host["fwd_bwd_memory"] = self._peak_memory_mib()
        main_log(f"iter {it} " + " ".join(f"{k}={v:.4f}"
                                          for k, v in m_host.items())
                 + (f" rays/s={rate:.0f}" if rate else ""))
        if self.writer is not None:
            for k, v in m_host.items():
                self.writer.add_scalar(f"train/{k}", v, it)
            if rate:
                self.writer.add_scalar("train/rays_per_sec", rate, it)

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof) -> None:
        """End the trace window and write its Chrome trace under
        experiment_path/profile (one a rank in a process group)."""
        prof.stop()
        trace_dir = (self.experiment_path or Path(".")) / "profile"
        trace_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"_rank{self.rank}" if self.world > 1 else ""
        path = trace_dir / (f"train_steps_{self.hparams.profile_trace_step}"
                            f"{suffix}.json")
        prof.export_chrome_trace(str(path))
        main_log(f"profiler trace written to {path}")

    # ----------------------------------------------------- classic NeRF ---
    def train_nerf(self) -> TrainState:
        """Classic-NeRF epoch training (the JAX package's
        ``Runner.train_nerf``): --num_epochs epochs of len(train rays) //
        --batch_size batches, each from the epoch's permutation
        (``NeRFDatasetTrain.get_batch``, keyed by the batch counter); a log
        line every --i_print steps, a checkpoint every --ckpt_interval
        steps and at the end, and on SIGTERM a resumable checkpoint and
        return. A resume (--resume_ckpt_state) restarts at the checkpoint's
        batch counter. No validation runs during training."""
        h = self.hparams
        term = _install_term_latch()
        try:
            state = create_train_state(h, self.nerf, None, device=self.device)
            main_log(f"Total parameters number is "
                     f"{_param_count(state) / 1024 / 1024:.4f}"
                     " M")
            host_iteration = None
            if h.ckpt_path is not None:
                state, extra = load_checkpoint(h.ckpt_path, state,
                                               h.resume_ckpt_state)
                if h.resume_ckpt_state:
                    host_iteration = extra.get("host_iteration")
                main_log(f"Resumed from iteration {state.step}")
            train_step = make_train_step(
                h, render_config_from_hparams(h), SceneInfo(None, None),
                mip=self.mip, device=self.device)
            total = h.num_epochs * max(len(self.train_set) // h.batch_size, 1)
            self._feed_size(False)      # raises unless the ranks share B
            self._broadcast_params(state)
            # the batch counter, not state.step, keys the batches: a
            # skipped non-finite step consumes a batch
            it = int(host_iteration) if host_iteration is not None \
                else state.step
            while it < total:
                batch = self._put_batch(self.train_set.get_batch(
                    it, h.batch_size))
                state, m = train_step(state, batch)
                it += 1
                if it % h.i_print == 0:
                    m_host = {k: float(v) for k, v in m.items()}
                    if h.compute_memory:
                        m_host["fwd_bwd_memory"] = self._peak_memory_mib()
                    main_log(f"iter {it}/{total} " + " ".join(
                        f"{k}={v:.4f}" for k, v in m_host.items()))
                    if self.writer is not None:
                        for k, v in m_host.items():
                            self.writer.add_scalar(f"train/{k}", v, it)
                if self.model_path is not None and it % h.ckpt_interval == 0:
                    save_checkpoint(self.model_path, state, keep=h.ckpt_keep,
                                    host_iteration=it)
                if self._term_agreed(term, it):
                    # the latch stays installed through the save
                    if self.model_path is not None:
                        save_checkpoint(self.model_path, state,
                                        keep=h.ckpt_keep, host_iteration=it)
                    main_log(f"SIGTERM: checkpoint saved at iteration {it}; "
                             "exiting")
                    return state
            if self.model_path is not None:
                save_checkpoint(self.model_path, state)
            main_log("Training complete")
            return state
        finally:
            _release_term_latch(term)

    def eval_nerf(self) -> Dict[str, float]:
        """The classic-NeRF eval CLI: the test split's protocol
        (``_run_validation_nerf`` into test_images_0)."""
        state = self._load_eval_state()
        return self._run_validation_nerf(state, mode="test")

    @_whole_model
    def _run_validation_nerf(self, state: TrainState, mode: str = "val",
                             train_index: int = 0) -> Dict[str, float]:
        """Whole-image PSNR/SSIM/LPIPS of each val or test image, with its
        render seconds and peak memory: {mode}_images_{train_index}/
        metrics_{img_i}.txt with the gt/pred/depth panel crops,
        val_images/{img_i}.jpg triptychs, and the protocol dir's
        metrics.txt ('step {train_index} {mode}', then 'Average
        {mode}/<metric>: <mean>'). Files are keyed by the image's index in
        the whole set."""
        if mode not in ("val", "test"):
            raise ValueError(f"mode {mode!r} is not 'val' or 'test'")
        render_chunks = self._make_render_fn(state)
        meter = DictAverageMeter()
        out_dir = val_images_dir = None
        if self.experiment_path is not None:
            out_dir = self.experiment_path / f"{mode}_images_{train_index}"
            out_dir.mkdir(parents=True, exist_ok=True)
            val_images_dir = self.experiment_path / "val_images"
            val_images_dir.mkdir(parents=True, exist_ok=True)
        colormap = getattr(self.hparams, "colormap", None)
        eval_set = self.val_set if mode == "val" else self.test_set
        per_image: Dict[int, Dict[str, float]] = {}
        for i in range(len(eval_set)):
            if not self._owns(i):
                continue
            sample = eval_set[i]
            img_i = int(sample["img_i"])
            radii = sample.get("radii")
            t0 = time.time()
            res = render_chunks(sample["rays"].reshape(-1, 8), float(img_i),
                                None if radii is None
                                else radii.reshape(-1, 1))
            render_time = time.time() - t0
            typ = "fine" if "rgb_fine" in res else "coarse"
            gt = sample["rgbs"]
            h, w = gt.shape[:2]
            pred = np.clip(res[f"rgb_{typ}"].reshape(h, w, 3), 0.0, 1.0)
            pred_t = torch.from_numpy(np.ascontiguousarray(pred)).to(
                self.device)
            gt_t = torch.from_numpy(np.ascontiguousarray(gt)).to(self.device)
            img_metrics = {"psnr": M.psnr(pred_t, gt_t),
                           "ssim": M.ssim(pred_t, gt_t, 1.0)}
            for k, v in M.lpips(pred_t, gt_t).items():
                if v is not None:
                    img_metrics[f"lpips-{k}"] = v
            img_metrics["time"] = render_time
            img_metrics["memory"] = self._peak_memory_mib()
            meter.update(img_metrics)
            per_image[img_i] = img_metrics
            if out_dir is None:
                continue
            with (out_dir / f"metrics_{img_i}.txt").open("w") as f:
                for k, v in img_metrics.items():
                    f.write(f"{k}: {v}\n")
            res_img = {f"rgb_{typ}": pred}
            if f"depth_{typ}" in res:
                res_img[f"depth_{typ}"] = res[f"depth_{typ}"].reshape(h, w)
            depth = self._depth_for_viz(res_img, typ)
            arr = self._result_image(gt, pred, depth, colormap=colormap)
            from PIL import Image
            Image.fromarray(arr).save(val_images_dir / f"{img_i}.jpg")
            if depth is not None:
                self._save_panel_crops(arr, out_dir, img_i)
        self._gather_image_metrics(per_image, mode)
        means = meter.mean_across_processes()
        main_log(f"{mode} means: " + " ".join(f"{k}={v:.4f}"
                                              for k, v in means.items()))
        if out_dir is not None and parallel.is_main():
            with (out_dir / "metrics.txt").open("w") as f:
                f.write(f"step {train_index} {mode}\n")
                for k, v in means.items():
                    agg = self._agg_key(k).replace("val/", f"{mode}/", 1)
                    f.write(f"Average {agg}: {v}\n")
        return means

    def eval_image_blocknerf(self) -> Dict[str, float]:
        """The Block-NeRF eval protocol over the val tfrecords
        (--block_val_list_path): each image rendered whole (with its mip
        radii), scored on its right half (PSNR, SSIM, their masked
        variants with the moving-object mask, 1 == moving == invalid, and
        LPIPS), with its render seconds and peak memory. Files keyed by
        the image hash under --exp_name: images/metrics_{hash}.txt +
        {hash}_gt/_pred/_depth.jpg crops, val_images/{hash}.jpg
        triptychs, which mark an image done (a rerun skips it), and
        val_metrics/metrics-{hash}.json records; experiment_path/
        metrics.txt 'Average val/...' lines sum every record on disk (this
        pass's and earlier ones') and divide by the id map's val_image_num
        (else the record count), as the JAX package does. Returns this
        pass's means. In a process group image i (in record order) is rank
        i % W's; rank 0 gathers every rank's records of this pass before
        it sums (a rank's files may sit on its own disk)."""
        h = self.hparams
        state = self._load_eval_state()
        render_chunks = self._make_render_fn(state)
        meter = DictAverageMeter()
        base = Path(h.exp_name)
        images_dir = base / "images"
        val_images_dir = base / "val_images"
        metric_dir = base / "val_metrics"
        for d_ in (images_dir, val_images_dir, metric_dir):
            d_.mkdir(parents=True, exist_ok=True)
        this_run: Dict[str, Dict[str, float]] = {}

        names = [ln.strip() for ln in
                 Path(h.block_val_list_path).read_text().splitlines()
                 if ln.strip()]
        img_counter = 0
        for rec_name in names:
            dicts = load_tfrecord(
                Path(h.dataset_path) / rec_name,
                record_id_map(self.image_hash_id_map, rec_name), self.near,
                self.far, load_mask=True)
            for d in dicts:
                key = d.get("image_hash", str(img_counter))
                mine = self._owns(img_counter)
                img_counter += 1
                # the triptych is an image's last file: it marks it done
                if not mine or (val_images_dir / f"{key}.jpg").exists():
                    continue
                t0 = time.time()
                res = render_chunks(d["rays"].reshape(-1, 8),
                                    float(d["image_ids"]),
                                    d["radii"].reshape(-1, 1))
                render_time = time.time() - t0
                typ = "fine" if "rgb_fine" in res else "coarse"
                hh, ww = d["rgbs"].shape[:2]
                pred = np.clip(res[f"rgb_{typ}"].reshape(hh, ww, 3), 0, 1)
                gt = d["rgbs"]
                valid = d["mask"][..., 0] < 0.5
                img_metrics = self._image_metrics_half(pred, gt, valid)
                img_metrics["time"] = render_time
                img_metrics["memory"] = self._peak_memory_mib()
                meter.update(img_metrics)
                this_run[str(key)] = {k: float(v)
                                      for k, v in img_metrics.items()}
                (metric_dir / f"metrics-{key}.json").write_text(json.dumps(
                    this_run[str(key)]))
                res_img = {f"rgb_{typ}": pred}
                for extra in (f"depth_{typ}", f"fg_depth_{typ}",
                              f"bg_depth_{typ}"):
                    if extra in res:
                        res_img[extra] = res[extra].reshape(hh, ww)
                for extra in (f"fg_rgb_{typ}", f"bg_rgb_{typ}"):
                    if extra in res:
                        res_img[extra] = res[extra].reshape(hh, ww, 3)
                self._write_reference_val_files(
                    images_dir, val_images_dir, key, gt, pred, res_img, typ,
                    img_metrics)
        means = meter.mean_across_processes()
        records = {}
        for d in allgather_json(this_run):
            records.update(d)
        for key, rec in records.items():
            main_log(f"blocknerf val image {key}: " + " ".join(
                f"{k}={v:.4f}" for k, v in rec.items()))
        main_log("blocknerf val means: " + " ".join(
            f"{k}={v:.4f}" for k, v in means.items()))
        if parallel.is_main():
            # the other ranks' records of this pass, where their files are
            # not on this disk
            for key, rec in records.items():
                f_ = metric_dir / f"metrics-{key}.json"
                if not f_.exists():
                    f_.write_text(json.dumps(rec))
        if self.experiment_path is not None and parallel.is_main():
            sums: Dict[str, float] = {}
            count = 0
            for f_ in sorted(metric_dir.glob("metrics-*.json")):
                count += 1
                for k, v in json.loads(f_.read_text()).items():
                    ak = self._agg_key(k)
                    sums[ak] = sums.get(ak, 0.0) + float(v)
            image_num = int(self.image_hash_id_map.get(
                "val_image_num", count) or count)
            with (self.experiment_path / "metrics.txt").open("w") as f:
                for k, v in sums.items():
                    msg = f"Average {k}: {v / image_num}"
                    main_log(msg)
                    f.write(msg + "\n")
        return means

    # ------------------------------------------------- point export ----
    def _with_gate_returns(self) -> None:
        """Rebuild the model with its MoE gate returns on (eval_points)."""
        if not self.hparams.use_moe:
            raise ValueError("eval_points needs a MoE model (--use_moe)")
        self.hparams.moe_return_gates = True
        self.nerf = get_nerf(self.hparams, self.appearance_count,
                             device=self.device)

    def eval_points(self) -> List[Path]:
        """Scene decomposition: per-expert coloured point clouds of the
        first --render_test_points_image_num val images (JAX
        ``runner.py:1286``; the reference's eval_points.py with
        --moe_return_gates --return_pts --return_pts_rgb
        --return_pts_alpha). Returns the PLY files this rank wrote."""
        self._with_gate_returns()
        state = self._load_eval_state()
        h = self.hparams

        def ray_sources():
            for i in range(min(len(self.val_items),
                               h.render_test_points_image_num)):
                md = self.val_items[i]
                directions = get_ray_directions(
                    md.W, md.H, md.intrinsics[0], md.intrinsics[1],
                    md.intrinsics[2], md.intrinsics[3], h.center_pixels)
                yield lambda md=md, d=directions: (
                    get_rays(d, md.c2w, self.near, self.far,
                             self.ray_altitude_range).reshape(-1, 8),
                    float(md.image_index))

        return self._export_point_clouds(state, ray_sources())

    def eval_points_nerf(self) -> List[Path]:
        """eval_points over a classic-NeRF scene's val split (JAX
        ``runner.py:1650``)."""
        if self.data_type != "nerf":
            raise ValueError("eval_points_nerf needs --data_type nerf")
        self._with_gate_returns()
        state = self._load_eval_state()

        def ray_sources():
            for i in range(min(len(self.val_set),
                               self.hparams.render_test_points_image_num)):
                yield lambda i=i: (self.val_set[i]["rays"].reshape(-1, 8),
                                   float(self.val_set[i]["img_i"]))

        return self._export_point_clouds(state, ray_sources())

    def _make_points_program(self, state: TrainState) -> Callable:
        """program(batch) -> per --render_test_points_typ ('coarse',
        'fine'): the sample positions pts_{typ} [N, S, 3], their raw
        colours pts_rgb_{typ}, alphas pts_alpha_{typ}, the composited
        rgb_{typ} [N, 3] and the MoE gates moe_gates_{typ} [N, S, L, K]
        (JAX ``runner.py:1320-1410``). The model is evaluated at the eval
        protocol's coarse positions and, for 'fine', at the deterministic
        inverse-CDF resample of the coarse weights.

        With --moe_test_batch (padded dispatch) the model takes the whole
        N x S point set in one call, as JAX's: that grouping sets the
        capacity and so the drops. In no-drop dispatch (the default) every
        token is routed alone, so calls of at most POINTS_CALL_ROWS points
        give the same results; they bound the memory of the published
        65,536-ray requests."""
        from switch_nerf_torch.ops.volume import sample_pdf

        h = self.hparams
        model = state.model
        typs = tuple(h.render_test_points_typ)
        for t in typs:
            if t not in ("coarse", "fine"):
                raise ValueError(f"--render_test_points_typ {t!r} not in "
                                 "('coarse', 'fine')")
        if "fine" in typs and h.fine_samples <= 0:
            raise ValueError("--render_test_points_typ fine requires "
                             "fine_samples > 0")
        rows = None if h.moe_test_batch else POINTS_CALL_ROWS

        def apply(pts_in):
            step = rows or len(pts_in)
            outs = [model(pts_in[lo:lo + step], train=False)
                    for lo in range(0, len(pts_in), step)]
            out = torch.cat([o["outputs"] for o in outs])
            gates = [o["extras"].get("moe_gates") for o in outs]
            if not gates[0]:
                return out, None
            return out, torch.cat([torch.stack(g, dim=1) for g in gates])

        def eval_at(z, d, image_indices, o):
            bs, s = z.shape
            xyz = o[:, None, :] + d[:, None, :] * z[..., None]
            parts = [xyz.reshape(-1, 3)]
            if h.use_mip:
                # mip models take (mean, cov): a tiny fixed covariance
                parts.append(torch.full((bs * s, 3), 1e-6,
                                        dtype=torch.float32, device=z.device))
            if h.pos_dir_dim > 0:
                parts.append(torch.repeat_interleave(d, s, dim=0))
            if h.appearance_dim > 0:
                parts.append(torch.repeat_interleave(
                    image_indices.float(), s)[:, None])
            out, gates = apply(torch.cat(parts, -1).float())
            res = out.reshape(bs, s, -1)
            if gates is not None:                          # [bs*s, L, K]
                gates = gates.reshape(bs, s, *gates.shape[1:])
            return xyz, res[..., :3], res[..., 3], gates

        def alpha_weights(z, sigma):
            deltas = torch.cat([z[:, 1:] - z[:, :-1],
                                torch.full_like(z[:, :1], 1e10)], -1)
            alpha = 1.0 - torch.exp(-deltas * sigma)
            t = torch.cumprod(torch.cat(
                [torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10],
                -1), -1)
            return alpha, alpha * t

        def pack(out, typ, xyz, rgb, alpha, weights, gates):
            out[f"pts_{typ}"] = xyz
            out[f"pts_rgb_{typ}"] = rgb
            out[f"pts_alpha_{typ}"] = alpha
            out[f"rgb_{typ}"] = torch.sum(weights[..., None] * rgb, dim=1)
            if gates is not None:
                out[f"moe_gates_{typ}"] = gates

        # JAX's jnp.linspace(0, 1, S) in float32, as XLA computes it:
        # iota times the float32 reciprocal of S - 1, the last entry 1
        steps = torch.ones(h.coarse_samples, dtype=torch.float32,
                           device=self.device)
        if h.coarse_samples > 1:
            d_ = h.coarse_samples - 1
            steps[:-1] = torch.arange(d_, dtype=torch.float32,
                                      device=self.device) * float(
                                          np.float32(1) / np.float32(d_))

        @torch.no_grad()
        def program(batch):
            rays, img = batch["rays"], batch["image_indices"]
            o, d = rays[:, 0:3], rays[:, 3:6]
            near, far = rays[:, 6:7], rays[:, 7:8]
            z = near + (far - near) * steps[None, :]
            out: Dict[str, torch.Tensor] = {}
            xyz, rgb, sigma, gates = eval_at(z, d, img, o)
            alpha, weights = alpha_weights(z, sigma)
            if "coarse" in typs:
                pack(out, "coarse", xyz, rgb, alpha, weights, gates)
            if "fine" in typs:
                z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
                fine_z = sample_pdf(z_mid, weights[:, 1:-1], h.fine_samples,
                                    det=True)
                xyz_f, rgb_f, sigma_f, gates_f = eval_at(fine_z, d, img, o)
                alpha_f, weights_f = alpha_weights(fine_z, sigma_f)
                pack(out, "fine", xyz_f, rgb_f, alpha_f, weights_f, gates_f)
            return out
        return program

    @_whole_model
    def _export_point_clouds(self, state: TrainState, ray_sources
                             ) -> List[Path]:
        """Per-point expert ids from the MoE gate returns -> the
        all-points, per-expert and segmentation PLYs of each typ, in the
        JAX package's file-name protocol (``runner.py:1412-1502``):
        {i:03d}_{typ}_pts_rgba.ply, its _top_{k}_exp_{e} subsets and, with
        --return_pts_class_seg, the _top_{k}_alpha[_exp_{e}] and
        _top_{k}[_exp_{e}] segmentation sets (palette rows 1..; the plain
        set's last sample painted with the ray's composited colour).

        `ray_sources` yields, per image, a function giving (rays [N, 8],
        image index). Data parallel: image i belongs to rank i % N, which
        renders it whole and writes its files (``_owns``, as eval does;
        JAX renders each image cooperatively over all its chips and its
        owner writes)."""
        from switch_nerf_torch.utils.ply import write_ply_points
        from switch_nerf_torch.utils.visualize import voc_palette

        h = self.hparams
        skip = h.render_test_points_sample_skip
        base_dir = (self.experiment_path or Path(".")) / "eval_points"
        run_chunks = self._batched_collective_fn(
            self._make_points_program(state))

        written: List[Path] = []
        for i, source in enumerate(ray_sources):
            if not self._owns(i):
                continue
            rays, image_index = source()
            out = run_chunks(rays, image_index)
            out_dir = base_dir / str(i)
            out_dir.mkdir(parents=True, exist_ok=True)

            def _write(name, xyz, colors, sel=None):
                if sel is not None:
                    xyz, colors = xyz[sel], colors[sel]
                write_ply_points(out_dir / name, xyz, colors)
                written.append(out_dir / name)

            for typ in h.render_test_points_typ:
                sl = slice(None, None, skip)
                pts = out[f"pts_{typ}"][:, sl]                  # [N, S', 3]
                rgb = np.clip(out[f"pts_rgb_{typ}"][:, sl], 0, 1)
                alpha = np.clip(out[f"pts_alpha_{typ}"][:, sl], 0, 1)
                flat_pts = pts.reshape(-1, 3)
                rgba = (np.concatenate([rgb, alpha[..., None]], -1)
                        * 255).astype(np.uint8).reshape(-1, 4)
                _write(f"{i:03d}_{typ}_pts_rgba.ply", flat_pts, rgba)
                if f"moe_gates_{typ}" not in out:
                    continue                 # dense model: all-points only
                # the first MoE layer's gate slots [N, S', K]
                moe_index = out[f"moe_gates_{typ}"][:, sl, 0, :]
                for k in range(moe_index.shape[-1]):
                    idx_k = moe_index[..., k].reshape(-1)
                    for e in range(h.moe_expert_num):
                        _write(f"{i:03d}_{typ}_pts_rgba_top_{k}_exp_{e}.ply",
                               flat_pts, rgba, sel=idx_k == e)
                if not h.return_pts_class_seg:
                    continue
                palette = voc_palette()[1:]
                render_rgb_u8 = (np.clip(out[f"rgb_{typ}"], 0, 1)
                                 * 255).astype(np.uint8)
                for k in range(moe_index.shape[-1]):
                    idx_k3 = moe_index[..., k]                  # [N, S']
                    seg = palette[idx_k3.astype(np.int64) % palette.shape[0]]
                    idx_flat = idx_k3.reshape(-1)
                    seg_a = np.concatenate(
                        [seg.reshape(-1, 3),
                         (alpha.reshape(-1, 1) * 255).astype(np.uint8)], -1)
                    _write(f"{i:03d}_{typ}_top_{k}_alpha.ply", flat_pts,
                           seg_a)
                    for e in range(h.moe_expert_num):
                        _write(f"{i:03d}_{typ}_top_{k}_alpha_exp_{e}.ply",
                               flat_pts, seg_a, sel=idx_flat == e)
                    seg_p = seg.copy()
                    seg_p[:, -1, :] = render_rgb_u8
                    seg_p = seg_p.reshape(-1, 3)
                    _write(f"{i:03d}_{typ}_top_{k}.ply", flat_pts, seg_p)
                    for e in range(h.moe_expert_num):
                        _write(f"{i:03d}_{typ}_top_{k}_exp_{e}.ply",
                               flat_pts, seg_p, sel=idx_flat == e)
                main_log(f"eval_points image {i} [{typ}]: "
                         f"{flat_pts.shape[0]} points")
        return written

    def eval_ckpt(self) -> TrainState:
        """Checkpoint sanity: load it and log its parameter count (JAX
        ``runner.py:1670``)."""
        state = self._load_eval_state()
        n = _param_count(state)
        main_log(f"Checkpoint at step {int(state.step)}: {n / 1e6:.3f}M "
                 "params")
        return state
