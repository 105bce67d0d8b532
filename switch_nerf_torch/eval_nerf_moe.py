"""Classic-NeRF (Bungee) test protocol on the port: load a checkpoint,
render each test image, score full-image PSNR/SSIM/LPIPS, write
test_images_0/.

    python -m switch_nerf_torch.eval_nerf_moe \
        --config_file=configs/switch_nerf/bungee.yaml \
        --exp_name=/out/bungee_eval --dataset_path=/data/transamerica \
        --ckpt_path=CKPT --moe_expert_num=4 --no_amp \
        --use_moe_external_gate --use_gate_input_norm

Data-parallel, one process per card (test image i is rank i % N's):

    torchrun --nproc_per_node=8 -m switch_nerf_torch.eval_nerf_moe \
        <the flags above>

Runs on ``cuda`` (``cuda:LOCAL_RANK`` under torchrun);
``main(hparams, device="cpu")`` runs the plain versions.
"""
from switch_nerf_torch.config import get_opts_nerf
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts_nerf)
def main(hparams=None, device=None):
    assert hparams.data_type == "nerf", \
        "eval_nerf_moe requires data_type=nerf"
    return Runner(hparams, device=device).eval_nerf()


if __name__ == "__main__":
    main()
