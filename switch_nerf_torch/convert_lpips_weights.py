"""One-time converter: the lpips package's pretrained weights -> the npz
that ``switch_nerf_torch.lpips_torch`` (and the JAX package's LPIPS)
reads. The port's counterpart of ``scripts/convert_lpips_weights.py``.

Run where ``lpips`` and ``torchvision`` are installed (the port needs
neither):

    python -m switch_nerf_torch.convert_lpips_weights --out lpips_weights.npz
    export SWITCH_NERF_LPIPS_WEIGHTS=/path/to/lpips_weights.npz

The npz holds HWIO conv kernels, their biases and the learned lin{i}
weights of vgg, alex and squeeze (layout: ``lpips_torch``'s docstring),
checked against the consumer's layout before it is written, with a
provenance record (converter versions, date, each net's sha256).
"""
import argparse
import datetime
from typing import Dict

import numpy as np
import torch

from switch_nerf_torch import lpips_torch as L


def export_net(lpips_model, net_name: str, out: Dict[str, np.ndarray]
               ) -> None:
    """The backbone's Conv2d layers (OIHW -> HWIO kernels, a zero bias
    where a conv has none) and the learned ``lins`` (each ``model[-1]``'s
    1x1 weight) of an ``lpips.LPIPS`` model, as ``<net>/conv<i>/...`` and
    ``<net>/lin<i>/kernel``."""
    convs = [m for m in lpips_model.net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    for i, conv in enumerate(convs):
        k = conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)
        out[f"{net_name}/conv{i}/kernel"] = k.astype(np.float32)
        bias = (conv.bias.detach().cpu().numpy() if conv.bias is not None
                else np.zeros(k.shape[-1], np.float32))
        out[f"{net_name}/conv{i}/bias"] = bias.astype(np.float32)
    for i, lin in enumerate(lpips_model.lins):
        k = lin.model[-1].weight.detach().cpu().numpy().transpose(2, 3, 1, 0)
        out[f"{net_name}/lin{i}/kernel"] = k.astype(np.float32)


def convert(models: Dict[str, object], out_path: str, meta: Dict) -> str:
    """Write the npz of `models` ({net: lpips.LPIPS model}); returns its
    sha256."""
    nets = {}
    for net, model in models.items():
        out: Dict[str, np.ndarray] = {}
        export_net(model, net, out)
        nets[net] = {k.split("/", 1)[1]: v for k, v in out.items()}
        print(f"exported {net}: {len(out)} tensors")
    return L.write_weights_npz(out_path, nets, meta)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, default="lpips_weights.npz")
    p.add_argument("--nets", type=str, nargs="+",
                   default=["vgg", "alex", "squeeze"])
    args = p.parse_args()

    import lpips

    meta = {"lpips_version": getattr(lpips, "__version__", "unknown"),
            "torch_version": torch.__version__,
            "converted": datetime.datetime.now(
                datetime.timezone.utc).isoformat()}
    file_sha = convert({net: lpips.LPIPS(net=net).eval()
                        for net in args.nets}, args.out, meta)
    print(f"wrote {args.out} (layout validated, provenance embedded)")
    print(f"sha256: {file_sha}")


if __name__ == "__main__":
    main()
