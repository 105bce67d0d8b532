"""Mega-NeRF test protocol on the port: load a checkpoint, render each val
image, score PSNR/SSIM/LPIPS on its right half, write metrics.txt.

    python -m switch_nerf_torch.eval_image --config_file \
        configs/switch_nerf/building.yaml --dataset_path DATA \
        --ckpt_path CKPT --exp_name OUT <published flags>

Runs on ``cuda``; ``main(hparams, device="cpu")`` runs the plain versions.
"""
from switch_nerf_torch.config import get_opts, parse_args
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry
def main(hparams=None, device=None):
    if hparams is None:
        hparams = parse_args(get_opts())
    return Runner(hparams, device=device).eval_image()


if __name__ == "__main__":
    main()
