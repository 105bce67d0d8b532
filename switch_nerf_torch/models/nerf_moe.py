"""Config-driven NeRF-MoE layer graph, and its mip variant.

Port of ``switch_nerf_tpu/models/nerf_moe.py:29-274`` with layer types
mlp / normmlp / moe / layernorm / groupnorm / dropout (batchnorm raises,
as in JAX). ``MipNeRFMoE`` (``use_mip``) takes a 6-wide (mean, diagonal
covariance) xyz input through ``mip_encode`` in place of the 3-wide point
through ``freq_encode``; the graph is the same. The YAML "model" dict
names the stem ("xyz"), the trunk tags 0..N-1, the heads ("sigma",
"color"), and the optional external gate MLP and gate-input LayerNorm that
feed every MoE gate. The walk taps sigma at `sigma_tag` (fp32 unless bf16
sigma is asked for; a sigma-only query ends there), appends viewdir PE +
appearance embedding at `dir_tag`, and emits rgb at `color_tag`. With
pos_dir_dim 0 the sigma head emits rgb and sigma and the walk ends at the
tap; with affine_appearance the embedding drives a 3x4 colour transform of
the rgb head's output instead of joining the trunk. The MoE layers take
the layer's k (top-k routing) and h_ch (the ffn experts' hidden width)
and the model's MoE flags; with --moe_return_gate_logits the extras carry
each MoE layer's gate logits (``moe_gate_logits``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from switch_nerf_torch import remat
from switch_nerf_torch.models.common import (Dropout, Embedding, GroupNorm,
                                            LayerNorm, TorchLinear, apply_act)
from switch_nerf_torch.models.mlp import Mlp, NormMlp
from switch_nerf_torch.models.moe import MoELayer
from switch_nerf_torch.ops.encoding import (freq_encode, mip_encode,
                                            shifted_softplus)
from switch_nerf_torch.utils.spans import spanned


class NeRFMoE(nn.Module):
    def __init__(self, layer_cfg: Dict[str, Any], pos_xyz_dim: int = 12,
                 pos_dir_dim: int = 4, appearance_dim: int = 48,
                 affine_appearance: bool = False,
                 appearance_count: int = 0, rgb_dim: int = 3,
                 xyz_dim: int = 3, shifted_softplus_sigma: bool = True,
                 use_mip: bool = False,
                 moe_capacity_factor: float = 1.0,
                 batch_prioritized_routing: bool = False,
                 dispatcher_no_score: bool = False, is_postscore: bool = True,
                 use_moe_external_gate: bool = False,
                 use_gate_input_norm: bool = False,
                 moe_return_gates: bool = False, gate_noise: float = -1.0,
                 use_load_importance_loss: bool = False,
                 compute_balance_loss: bool = False,
                 moe_use_residual: bool = False,
                 moe_return_gate_logits: bool = False,
                 moe_expert_type: str = "expertmlp",
                 train_dispatch: str = "padded", eval_dispatch: str = "padded",
                 sigma_fp32: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_cfg = layer_cfg
        self.pos_xyz_dim, self.pos_dir_dim = pos_xyz_dim, pos_dir_dim
        self.appearance_dim = appearance_dim
        self.affine_appearance = affine_appearance
        self.rgb_dim, self.xyz_dim = rgb_dim, xyz_dim
        self.use_mip = use_mip
        self.shifted_softplus_sigma = shifted_softplus_sigma
        self.use_moe_external_gate = use_moe_external_gate
        self.use_gate_input_norm = use_gate_input_norm
        self.moe_return_gates = moe_return_gates
        self.moe_return_gate_logits = moe_return_gate_logits
        self.sigma_fp32, self.compute_dtype = sigma_fp32, compute_dtype
        moe_kwargs = dict(
            capacity_factor=moe_capacity_factor,
            batch_prioritized_routing=batch_prioritized_routing,
            no_score=dispatcher_no_score, is_postscore=is_postscore,
            return_gates=moe_return_gates, gate_noise=gate_noise,
            use_load_importance_loss=use_load_importance_loss,
            compute_balance_loss=compute_balance_loss,
            use_residual=moe_use_residual,
            return_gate_logits=moe_return_gate_logits,
            train_dispatch=train_dispatch, eval_dispatch=eval_dispatch,
            expert_type=moe_expert_type, generator=generator)
        cfgs = layer_cfg["layers"]
        has_dir, has_app = pos_dir_dim > 0, appearance_dim > 0

        # widths follow the walk in forward(); the YAML's in_ch is not read
        def build(tag: str, width: int) -> int:
            cfg = cfgs[tag]
            typ = cfg["type"]
            if typ == "mlp":
                layer = Mlp(width, cfg["h_ch"], cfg["out_ch"], cfg["num"],
                            cfg.get("skips"), generator=generator)
                width = cfg["out_ch"]
            elif typ == "moe":
                if cfg["in_ch"] != cfg["out_ch"]:
                    raise ValueError(f"moe layer {tag}: in_ch != out_ch")
                layer = MoELayer(
                    model_dim=width,
                    num_experts=cfg.get("expert_num",
                                        layer_cfg.get("expert_num", 8)),
                    layer_num=cfg["num"], skips=cfg.get("skips"),
                    init_factor=cfg.get("init_factor", 1.0),
                    top_k=cfg.get("k", 1),
                    fp32_gate=cfg.get("fp32_gate", True),
                    gate_dim=self._gate_width or width,
                    ffn_hidden_size=cfg.get("h_ch", 0), **moe_kwargs)
            elif typ == "normmlp":
                layer = NormMlp(width, cfg["h_ch"], cfg["out_ch"], cfg["num"],
                                cfg.get("skips"),
                                norm_name=cfg.get("norm_name", "none"),
                                generator=generator)
                width = cfg["out_ch"]
            elif typ == "layernorm":
                layer = LayerNorm(width)
            elif typ == "groupnorm":
                layer = GroupNorm(cfg["group_num"], width)
            elif typ == "dropout":
                layer = Dropout(cfg["prob"])
            elif typ == "batchnorm":
                # as the JAX package: unused by every published config, and
                # its running statistics are ill-defined under chunked
                # inference
                raise NotImplementedError(
                    "graph-level batchnorm is not supported (unused by all "
                    "published Switch-NeRF configs)")
            else:
                raise NotImplementedError(f"layer type {typ!r}")
            self.add_module(f"layer_{tag}", layer)
            return width

        self._gate_width = None
        width = build("xyz", xyz_dim * (1 + 2 * pos_xyz_dim))
        if use_moe_external_gate:
            self._gate_width = build("moe_external_gate", width)
            if use_gate_input_norm:
                build("gate_input_norm", self._gate_width)
        for i in range(layer_cfg["layer_num_main"]):
            tag = str(i)
            width = build(tag, width)
            if tag == str(layer_cfg["sigma_tag"]):
                self.layer_sigma = Mlp(width, cfgs["sigma"]["h_ch"],
                                       cfgs["sigma"]["out_ch"],
                                       cfgs["sigma"]["num"],
                                       cfgs["sigma"].get("skips"),
                                       generator=generator)
                if not has_dir:         # the walk ends at the sigma tap
                    break
            if tag == str(layer_cfg["dir_tag"]) and has_dir:
                width += 3 * (1 + 2 * pos_dir_dim)
                if has_app and not affine_appearance:
                    self.embedding_a = Embedding(appearance_count,
                                                 appearance_dim,
                                                 generator=generator)
                    width += appearance_dim
            if tag == str(layer_cfg["color_tag"]) and has_dir:
                self.layer_color = Mlp(width, cfgs["color"]["h_ch"],
                                       cfgs["color"]["out_ch"],
                                       cfgs["color"]["num"],
                                       cfgs["color"].get("skips"),
                                       generator=generator)
                if affine_appearance and has_app:
                    self.embedding_a = Embedding(appearance_count,
                                                 appearance_dim,
                                                 generator=generator)
                    self.affine = TorchLinear(appearance_dim, 12,
                                              generator=generator)
                break

    @spanned("moe.gate")
    def _gate_features(self, h: torch.Tensor) -> torch.Tensor:
        cfgs = self.layer_cfg["layers"]
        gate_feat = apply_act(cfgs["moe_external_gate"].get("act", "none"),
                              self.layer_moe_external_gate(h))
        if self.use_gate_input_norm:
            gate_feat = self.layer_gate_input_norm(gate_feat)
        return gate_feat

    def _sigma_act(self, sigma: torch.Tensor) -> torch.Tensor:
        return (shifted_softplus(sigma) if self.shifted_softplus_sigma
                else torch.relu(sigma))

    def forward(self, x: torch.Tensor,
                sigma_noise: Optional[torch.Tensor] = None,
                train: bool = False, sigma_only: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """x: [S, 3 (mip: 6) (+3 viewdir) (+1 appearance idx)]; a
        sigma-only query passes the xyz columns alone and gets sigma [S, 1]
        back (with pos_dir_dim 0: rgb and sigma). sigma_noise: [S, 1] added
        to the raw sigma before its activation (training only); `train`
        picks the MoE layers' train dispatch and turns dropout and gate
        noise on, whose draws come from `generator`, layer by layer in the
        walk's order."""
        cfgs = self.layer_cfg["layers"]
        sigma_tag = str(self.layer_cfg["sigma_tag"])
        dir_tag = str(self.layer_cfg["dir_tag"])
        color_tag = str(self.layer_cfg["color_tag"])
        xd = self.xyz_dim * (2 if self.use_mip else 1)
        has_dir, has_app = self.pos_dir_dim > 0, self.appearance_dim > 0
        expected = xd + (0 if sigma_only else
                         (3 if has_dir else 0) + (1 if has_app else 0))
        if x.shape[-1] != expected:
            raise ValueError(f"Unexpected input shape {tuple(x.shape)}: "
                             f"expected last dim {expected}")

        xin = x[:, :xd].to(self.compute_dtype)
        if self.use_mip:
            h = mip_encode(xin, self.pos_xyz_dim, input_dims=self.xyz_dim)
        else:
            h = freq_encode(xin, self.pos_xyz_dim)
        h = apply_act(cfgs["xyz"].get("act", "none"), self.layer_xyz(h))

        gate_feat = None
        if self.use_moe_external_gate:
            # named for the remat save set (off by default; A/B with
            # SWITCH_NERF_REMAT_SAVE=+gate_feat): it feeds every MoE
            # layer's gate
            gate_feat = remat.keep(self._gate_features, h,
                                   name="gate_feat")

        moe_loss, moe_gates, moe_gate_logits = [], [], []
        outputs = sigma = None
        for i in range(self.layer_cfg["layer_num_main"]):
            tag = str(i)
            cfg = cfgs[tag]
            layer = getattr(self, f"layer_{tag}")
            if cfg["type"] == "moe":
                h, l_aux, gate_extras = layer(h, gate_input=gate_feat,
                                              train=train,
                                              generator=generator)
                moe_loss.append(l_aux)
                if self.moe_return_gates:
                    moe_gates.append(gate_extras["gates"])
                if self.moe_return_gate_logits:
                    moe_gate_logits.append(gate_extras["gate_logits"])
            elif cfg["type"] == "dropout":
                h = layer(h, train=train, generator=generator)
            else:
                h = layer(h)
            h = apply_act(cfg.get("act", "none"), h)

            if tag == sigma_tag:
                sigma = self.layer_sigma(h.float() if self.sigma_fp32 else h)
                if not has_dir:
                    # the sigma head emits rgb (3) and sigma (1)
                    rgb, sigma = sigma[:, :3], sigma[:, 3:]
                    if self.rgb_dim == 3:
                        rgb = torch.sigmoid(rgb)
                    if sigma_noise is not None:
                        sigma = sigma + sigma_noise.to(sigma.dtype)
                    sigma = self._sigma_act(sigma)
                    outputs = torch.cat([rgb, sigma.to(rgb.dtype)], dim=-1)
                    break
                if sigma_noise is not None:
                    sigma = sigma + sigma_noise.to(sigma.dtype)
                sigma = self._sigma_act(sigma)
                if sigma_only:
                    outputs = sigma
                    break
            if tag == dir_tag and has_dir:
                parts = [h, freq_encode(x[:, xd:xd + 3].to(self.compute_dtype),
                                        self.pos_dir_dim)]
                if has_app and not self.affine_appearance:
                    parts.append(self.embedding_a(x[:, -1].long())
                                 .to(self.compute_dtype))
                h = torch.cat(parts, dim=-1)
            if tag == color_tag and has_dir:
                rgb = self.layer_color(h)
                if self.affine_appearance and has_app:
                    a = self.embedding_a(x[:, -1].long()).to(
                        self.compute_dtype)
                    affine = self.affine(a).reshape(-1, 3, 4)
                    rgb = (torch.einsum("sij,sj->si", affine[:, :, :3], rgb)
                           + affine[:, :, 3])
                if self.rgb_dim == 3:
                    rgb = torch.sigmoid(rgb)
                outputs = torch.cat([rgb, sigma.to(rgb.dtype)], dim=-1)
                break

        extras = {}
        if self.moe_return_gates:
            extras["moe_gates"] = moe_gates
        if self.moe_return_gate_logits and moe_gate_logits:
            extras["moe_gate_logits"] = moe_gate_logits
        if moe_loss:
            extras["moe_loss"] = torch.stack(moe_loss)
        return {"outputs": outputs, "extras": extras}


def MipNeRFMoE(**kwargs) -> NeRFMoE:
    """The mip variant (JAX ``nerf_moe.py:271``): ``NeRFMoE`` with the
    integrated positional encoding over (mean, diagonal covariance)."""
    return NeRFMoE(use_mip=True, **kwargs)
