"""Training entry point of the port for Mega-NeRF and Block-NeRF scenes.

    python -m switch_nerf_torch.train \
        --config_file=configs/switch_nerf/building.yaml \
        --use_moe --exp_name=/out/building --dataset_path=/data/building \
        --chunk_paths=/scratch/building_chunks \
        --use_moe_external_gate --use_gate_input_norm \
        --moe_expert_type=expertmlp --batch_prioritized_routing \
        --moe_capacity_factor=1.0 --batch_size=8192 --moe_l_aux_wt=0.0005 \
        --moe_train_batch

Block-NeRF Mission Bay (GZIP tfrecords, read without TensorFlow):

    python -m switch_nerf_torch.train \
        --config_file=configs/switch_nerf/mission_bay.yaml \
        --exp_name=/out/mission_bay --dataset_path=/data/v1.0 \
        --chunk_paths=/scratch/mission_bay_chunks --batch_size=1664 \
        --moe_train_batch --use_moe_external_gate --use_gate_input_norm \
        --batch_prioritized_routing --moe_capacity_factor=1.0 \
        --moe_l_aux_wt=0.0005

Runs on ``cuda``; ``main(hparams, device="cpu")`` runs the plain versions.
Classic-NeRF scenes train through ``train_nerf_moe``.
"""
import torch

from switch_nerf_torch.config import get_opts, parse_args
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry
def main(hparams=None, device=None):
    if hparams is None:
        hparams = parse_args(get_opts())
    if hparams.data_type == "nerf":
        raise ValueError("classic-NeRF scenes train through "
                         "switch_nerf_torch.train_nerf_moe")
    if hparams.detect_anomalies:
        torch.autograd.set_detect_anomaly(True)
    return Runner(hparams, device=device).train()


if __name__ == "__main__":
    main()
