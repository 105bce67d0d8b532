"""Per-expert point clouds of a trained scene (scene decomposition): the
port's counterpart of ``switch_nerf_tpu/eval_points.py``.

    python -m switch_nerf_torch.eval_points <training flags> --ckpt_path=CKPT \
        --render_test_points_image_num=20 --render_test_points_sample_skip=4
    python -m switch_nerf_torch.merge_points --data_path <exp>/eval_points \
        --merge_save_dir merged --down_scale 0.03 --moe_expert_num 8

writes <exp>/eval_points/<i>/{i:03d}_coarse_pts_rgba.ply and its per-expert
subsets for each of the first N val images (``Runner.eval_points``; with
--data_type nerf, ``Runner.eval_points_nerf`` over the val split).
Data-parallel under torchrun, image i is rank i % N's. Runs on ``cuda``;
``main(hparams, device="cpu")`` runs the plain versions.
"""
from switch_nerf_torch.config import get_opts
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts)
def main(hparams=None, device=None):
    runner = Runner(hparams, device=device)
    if runner.data_type == "nerf":
        return runner.eval_points_nerf()
    return runner.eval_points()


if __name__ == "__main__":
    main()
