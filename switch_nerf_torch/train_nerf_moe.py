"""Training entry point of the port for classic-NeRF (Bungee) scenes.

    python -m switch_nerf_torch.train_nerf_moe \
        --config_file=configs/switch_nerf/bungee.yaml \
        --exp_name=/out/bungee --dataset_path=/data/transamerica \
        --batch_size=4096 --moe_expert_num=4 --no_amp \
        --use_moe_external_gate --use_gate_input_norm

Without --moe_train_batch the MoE layers train in no-drop dispatch (the
ragged chain, K1R/K2R on a card). Data-parallel, one process per card,
--batch_size the global batch:

    torchrun --nproc_per_node=8 -m switch_nerf_torch.train_nerf_moe \
        --config_file=configs/switch_nerf/bungee.yaml <the flags above>

Runs on ``cuda`` (``cuda:LOCAL_RANK`` under torchrun);
``main(hparams, device="cpu")`` runs the plain versions.
"""
import torch

from switch_nerf_torch.config import get_opts_nerf
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts_nerf)
def main(hparams=None, device=None):
    assert hparams.data_type == "nerf", \
        "train_nerf_moe requires data_type=nerf"
    if hparams.detect_anomalies:
        torch.autograd.set_detect_anomaly(True)
    return Runner(hparams, device=device).train_nerf()


if __name__ == "__main__":
    main()
