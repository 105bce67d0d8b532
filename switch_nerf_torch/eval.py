"""Validation-protocol eval on the port (the metrics of training-time
validation, means under val/ keys, into metrics.txt).

    python -m switch_nerf_torch.eval --config_file \
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
    return Runner(hparams, device=device).eval()


if __name__ == "__main__":
    main()
