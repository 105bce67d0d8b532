"""Package a trained checkpoint as a self-contained inference container
(``container.py``): the port's counterpart of
``scripts/convert_to_container_moe.py``.

    python -m switch_nerf_torch.convert_to_container_moe \
        --config_file=... --use_moe --exp_name=tmp --dataset_path=... \
        --ckpt_path=<ckpt step dir> --container_out=<out dir>

then serve it with ``--container_path=<out dir>`` in place of
--ckpt_path. After writing, the container is loaded back and evaluated on
8 points of ones, which must come out finite (the reference's self-test).
Runs on ``cuda``; ``main(hparams, device="cpu")`` on the CPU.
"""
import numpy as np
import torch

from switch_nerf_torch.config import get_opts
from switch_nerf_torch.utils.crash import cli_entry


def _parser():
    parser = get_opts()
    parser.add_argument("--container_out", type=str, required=True)
    return parser


@cli_entry(parser=_parser)
def main(hparams=None, device=None):
    """Write the container; returns its directory."""
    from switch_nerf_torch.container import load_container, save_container
    from switch_nerf_torch.runner import Runner

    runner = Runner(hparams, set_experiment_path=False, device=device)
    state = runner._load_eval_state()
    scene = {}
    if getattr(runner, "sphere_center", None) is not None:
        scene = {"sphere_center": np.asarray(runner.sphere_center).tolist(),
                 "sphere_radius": np.asarray(runner.sphere_radius).tolist(),
                 "near": runner.near, "far": runner.far}
    out = save_container(hparams.container_out, hparams, state.model,
                         state.bg_model, runner.appearance_count, scene)
    print(f"wrote container to {out}")

    model, _, _ = load_container(out, device=runner.device)
    d_pts = ((6 if hparams.use_mip else 3)
             + (3 if hparams.pos_dir_dim > 0 else 0)
             + (1 if hparams.appearance_dim > 0 else 0))
    with torch.no_grad():
        res = model(torch.ones((8, d_pts), device=runner.device))
    outp = res["outputs"] if isinstance(res, dict) else res
    if not torch.isfinite(outp).all():
        raise ValueError("container self-test: non-finite forward output")
    print(f"container self-test OK: forward {tuple(outp.shape)}")
    return out


if __name__ == "__main__":
    main()
