"""Validation-protocol eval on the port (the metrics of training-time
validation, means under val/ keys, into metrics.txt).

    python -m switch_nerf_torch.eval --config_file \
        configs/switch_nerf/building.yaml --dataset_path DATA \
        --ckpt_path CKPT --exp_name OUT <published flags>

Data-parallel, one process per card (val image i is rank i % N's, which
renders it whole; the metrics are gathered):

    torchrun --nproc_per_node=8 -m switch_nerf_torch.eval <the flags above>

Runs on ``cuda`` (``cuda:LOCAL_RANK`` under torchrun);
``main(hparams, device="cpu")`` runs the plain versions.
"""
from switch_nerf_torch.config import get_opts
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts)
def main(hparams=None, device=None):
    return Runner(hparams, device=device).eval()


if __name__ == "__main__":
    main()
