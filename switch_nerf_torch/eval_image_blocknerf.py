"""Block-NeRF (Waymo Mission Bay) eval protocol on the port: load a
checkpoint, render every image of the val tfrecords, score right-half
PSNR/SSIM (also masked by the moving-object masks) and LPIPS, write the
per-image files and the metrics.txt averages.

    python -m switch_nerf_torch.eval_image_blocknerf \
        --config_file=configs/switch_nerf/mission_bay.yaml \
        --exp_name=/out/mission_bay_eval --dataset_path=/data/v1.0 \
        --block_val_list_path=/data/val_list.txt \
        --block_image_hash_id_map_path=/data/image_hash_id_map.json \
        --ckpt_path=CKPT --use_moe_external_gate --use_gate_input_norm \
        --batch_prioritized_routing --moe_capacity_factor=1.0

The tfrecords are read without TensorFlow (``datasets/tfrecord.py``).
Data-parallel, one process per card (image i of the val records is rank
i % N's; rank 0 gathers every rank's records before the summary):

    torchrun --nproc_per_node=8 -m switch_nerf_torch.eval_image_blocknerf \
        <the flags above>

Runs on ``cuda`` (``cuda:LOCAL_RANK`` under torchrun);
``main(hparams, device="cpu")`` runs the plain versions.
"""
from switch_nerf_torch.config import get_opts
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts)
def main(hparams=None, device=None):
    if hparams.data_type != "block_nerf":
        raise ValueError("eval_image_blocknerf requires data_type "
                         f"block_nerf, got {hparams.data_type!r}")
    return Runner(hparams, device=device).eval_image_blocknerf()


if __name__ == "__main__":
    main()
