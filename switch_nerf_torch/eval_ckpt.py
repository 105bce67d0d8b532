"""Checkpoint sanity: load a checkpoint (or --container_path) and log its
parameter count. The port's counterpart of ``switch_nerf_tpu/eval_ckpt.py``.

    python -m switch_nerf_torch.eval_ckpt <training flags> --ckpt_path=CKPT

Runs on ``cuda``; ``main(hparams, device="cpu")`` on the CPU.
"""
from switch_nerf_torch.config import get_opts
from switch_nerf_torch.runner import Runner
from switch_nerf_torch.utils.crash import cli_entry


@cli_entry(parser=get_opts)
def main(hparams=None, device=None):
    return Runner(hparams, set_experiment_path=False,
                  device=device).eval_ckpt()


if __name__ == "__main__":
    main()
