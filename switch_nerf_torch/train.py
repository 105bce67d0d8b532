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

Data-parallel over the 8 cards of a host, one process per card, with the
published global batch (1,024 rays a card for Building, 1,664 for Mission
Bay; the MoE layers route on the global batch's model chunks, as JAX's):

    torchrun --nproc_per_node=8 -m switch_nerf_torch.train \
        --config_file=configs/switch_nerf/building.yaml <the flags above> \
        --batch_size=8192
    torchrun --nproc_per_node=8 -m switch_nerf_torch.train \
        --config_file=configs/switch_nerf/mission_bay.yaml \
        <the flags above> --batch_size=13312

Expert-parallel: each rank holds experts / E of the MoE layers' experts
and their Adam moments, on a (D, E) mesh of D x E processes, and the
padded training passes exchange tokens with the experts' owners:

    torchrun --nproc_per_node=8 -m switch_nerf_torch.train \
        --config_file=configs/switch_nerf/building.yaml <the flags above> \
        --batch_size=8192 --expert_parallel --mesh_shape 2 4

Runs on ``cuda`` (``cuda:LOCAL_RANK`` under torchrun);
``main(hparams, device="cpu")`` runs the plain versions (with torchrun's
variables set, in a gloo group). Classic-NeRF scenes train through
``train_nerf_moe``.
"""
import torch

from switch_nerf_torch.config import get_opts
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts)
def main(hparams=None, device=None):
    if hparams.data_type == "nerf":
        raise ValueError("classic-NeRF scenes train through "
                         "switch_nerf_torch.train_nerf_moe")
    if hparams.detect_anomalies:
        torch.autograd.set_detect_anomaly(True)
    return Runner(hparams, device=device).train()


if __name__ == "__main__":
    main()
