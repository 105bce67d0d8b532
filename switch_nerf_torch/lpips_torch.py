"""LPIPS perceptual metric in PyTorch (VGG16 / AlexNet / SqueezeNet-1.1).

Port of ``switch_nerf_tpu/lpips_jax.py``: the same backbones, taps,
scaling layer and f/(||f||+eps) normalization, on ``F.conv2d`` and
``F.max_pool2d`` in fp32 on the images' device, and the same weights
contract. Weights come as the npz that ``scripts/convert_lpips_weights.py``
writes, or as the documented deterministic substitute
(``substitute_weights``), bit-identical to the JAX package's.

npz layout (keys):
    <net>/conv<i>/kernel   [kh, kw, cin, cout]   (HWIO)
    <net>/conv<i>/bias     [cout]
    <net>/lin<i>/kernel    [1, 1, c, 1]          (learned LPIPS weights)
with <net> in {vgg, alex, squeeze}. Kernels are turned into OIHW once,
when a weight set is prepared for a device (``prepare_weights``).
``write_weights_npz`` writes such an npz, layout-checked and with its
provenance record, for ``python -m switch_nerf_torch.convert_lpips_weights``.
"""
from __future__ import annotations

import functools
import hashlib
import json
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# lpips package scaling layer (inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# conv configs: (out_channels, kernel, stride, padding); 'M' = maxpool
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
_VGG_TAPS = (1, 3, 6, 9, 12)     # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

_ALEX = [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_TAPS = (0, 1, 2, 3, 4)

# squeezenet 1.1: conv0 then fire modules (squeeze, expand1x1, expand3x3)
_SQUEEZE_FIRES = [(16, 64, 64), (16, 64, 64), (32, 128, 128),
                  (32, 128, 128), (48, 192, 192), (48, 192, 192),
                  (64, 256, 256), (64, 256, 256)]
_SQUEEZE_POOL_BEFORE = {0, 2, 4}       # maxpool before fires 0, 2, 4
# conv0 (level 0) + fires 1,3,4,5,6,7 (levels 2,4,5,6,7,8): channels
# [64, 128, 256, 384, 384, 512, 512]
_SQUEEZE_TAPS = (0, 2, 4, 5, 6, 7, 8)

NETS = ("vgg", "alex", "squeeze")


def _empty(x: torch.Tensor, channels: int, oh: int, ow: int) -> torch.Tensor:
    return x.new_zeros((x.shape[0], channels, max(oh, 0), max(ow, 0)))


def _conv(x, w, name, stride=1, padding=0):
    """NCHW conv + bias. An input too small for the kernel gives an empty
    map, as the JAX package's conv does (torch would raise)."""
    kernel, bias = w[f"{name}/kernel"], w[f"{name}/bias"]
    oh, ow = ((s + 2 * padding - k) // stride + 1
              for s, k in zip(x.shape[2:], kernel.shape[2:]))
    if x.numel() == 0 or oh <= 0 or ow <= 0:
        return _empty(x, kernel.shape[0], oh, ow)
    return F.conv2d(x, kernel, bias, stride, padding)


def _maxpool(x, k=3, s=2, ceil_mode=False):
    """torch.nn.MaxPool2d semantics. ceil_mode=True (squeezenet1_1's pools)
    includes the partial last window, as right/bottom -inf padding sized so
    every ceil-counted window exists (the JAX package's formulation)."""
    outs, pads = [], []
    for size in x.shape[2:]:
        if ceil_mode:
            out = -((size - k) // -s) + 1
            pads.append(max(0, (out - 1) * s + k - size))
        else:
            out = (size - k) // s + 1
            pads.append(0)
        outs.append(out)
    if x.numel() == 0 or min(outs) <= 0:
        return _empty(x, x.shape[1], *outs)
    if any(pads):
        x = F.pad(x, (0, pads[1], 0, pads[0]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _vgg_features(x, w) -> List[torch.Tensor]:
    feats = []
    ci = 0
    for cfg in _VGG16:
        if cfg == "M":
            x = _maxpool(x, 2, 2)
            continue
        x = torch.relu(_conv(x, w, f"conv{ci}", 1, 1))
        if ci in _VGG_TAPS:
            feats.append(x)
        ci += 1
    return feats


def _alex_features(x, w) -> List[torch.Tensor]:
    feats = []
    ci = 0
    for cfg in _ALEX:
        if cfg == "M":
            x = _maxpool(x, 3, 2)
            continue
        _, _, s, p = cfg
        x = torch.relu(_conv(x, w, f"conv{ci}", s, p))
        if ci in _ALEX_TAPS:
            feats.append(x)
        ci += 1
    return feats


def _squeeze_features(x, w) -> List[torch.Tensor]:
    feats = []
    level = 0
    x = torch.relu(_conv(x, w, "conv0", 2, 0))
    if level in _SQUEEZE_TAPS:
        feats.append(x)
    level += 1
    ci = 1
    for fi in range(len(_SQUEEZE_FIRES)):
        if fi in _SQUEEZE_POOL_BEFORE:
            x = _maxpool(x, 3, 2, ceil_mode=True)
        s = torch.relu(_conv(x, w, f"conv{ci}"))
        a = torch.relu(_conv(s, w, f"conv{ci + 1}"))
        b = torch.relu(_conv(s, w, f"conv{ci + 2}", 1, 1))
        x = torch.cat([a, b], dim=1)
        ci += 3
        if level in _SQUEEZE_TAPS:
            feats.append(x)
        level += 1
    return feats


_EXTRACTORS = {"vgg": _vgg_features, "alex": _alex_features,
               "squeeze": _squeeze_features}


def _unit_normalize(f):
    # exactly lpips.normalize_tensor: eps outside the sqrt (f/(||f||+eps))
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)


def lpips_distance(img0: torch.Tensor, img1: torch.Tensor, net: str,
                   weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """img0/img1: [H, W, 3] in [-1, 1]; weights prepared by
    ``prepare_weights`` on the images' device. Returns the scalar LPIPS
    distance (fp32 0-d tensor)."""
    shift = img0.new_tensor(_SHIFT, dtype=torch.float32)
    scale = img0.new_tensor(_SCALE, dtype=torch.float32)

    def prep(img):
        x = (img.float() - shift) / scale
        return x.permute(2, 0, 1)[None]                 # NCHW
    f0 = _EXTRACTORS[net](prep(img0), weights)
    f1 = _EXTRACTORS[net](prep(img1), weights)
    total = img0.new_zeros((), dtype=torch.float32)
    for li, (a, b) in enumerate(zip(f0, f1)):
        if 0 in a.shape[2:]:
            # image too small for this tap's receptive field (tiny synthetic
            # inputs only): an empty spatial mean would be NaN, so skip it
            continue
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + torch.mean(F.conv2d(d, weights[f"lin{li}/kernel"]))
    return total


def _net_layer_specs(net: str):
    """Yield (name, kh, kw, cin, cout) conv specs + tap channel widths."""
    convs, taps = [], []
    if net == "vgg":
        cin, ci = 3, 0
        for cfg in _VGG16:
            if cfg == "M":
                continue
            convs.append((f"conv{ci}", 3, 3, cin, cfg))
            if ci in _VGG_TAPS:
                taps.append(cfg)
            cin, ci = cfg, ci + 1
    elif net == "alex":
        cin, ci = 3, 0
        for cfg in _ALEX:
            if cfg == "M":
                continue
            c, k, _, _ = cfg
            convs.append((f"conv{ci}", k, k, cin, c))
            taps.append(c)
            cin, ci = c, ci + 1
    elif net == "squeeze":
        convs.append(("conv0", 3, 3, 3, 64))
        taps.append(64)
        cin, ci, level = 64, 1, 1
        for sq, e1, e3 in _SQUEEZE_FIRES:
            convs.append((f"conv{ci}", 1, 1, cin, sq))
            convs.append((f"conv{ci+1}", 1, 1, sq, e1))
            convs.append((f"conv{ci+2}", 3, 3, sq, e3))
            cin = e1 + e3
            if level in _SQUEEZE_TAPS:
                taps.append(cin)
            ci, level = ci + 3, level + 1
    else:
        raise ValueError(net)
    return convs, taps


def expected_layout(net: str) -> Dict[str, Tuple[int, ...]]:
    """The exact key->shape contract a converted-weights npz must satisfy
    for `net` (the architecture the backbones above execute)."""
    convs, taps = _net_layer_specs(net)
    layout: Dict[str, Tuple[int, ...]] = {}
    for name, kh, kw, cin, cout in convs:
        layout[f"{name}/kernel"] = (kh, kw, cin, cout)
        layout[f"{name}/bias"] = (cout,)
    for li, c in enumerate(taps):
        layout[f"lin{li}/kernel"] = (1, 1, c, 1)
    return layout


def validate_net_weights(net: str, w: Dict[str, np.ndarray],
                         source: str = "") -> None:
    """Fail loudly (expected-vs-got layout) on any tap/shape mismatch."""
    want = expected_layout(net)
    problems = []
    for key in sorted(set(want) | set(w)):
        if key not in w:
            problems.append(f"  missing {net}/{key} "
                            f"(expected shape {want[key]})")
        elif key not in want:
            problems.append(f"  unexpected key {net}/{key} "
                            f"(shape {tuple(np.shape(w[key]))})")
        elif tuple(np.shape(w[key])) != want[key]:
            problems.append(f"  {net}/{key}: expected shape {want[key]}, "
                            f"got {tuple(np.shape(w[key]))}")
    if problems:
        raise ValueError(
            f"LPIPS weights{f' in {source}' if source else ''} do not "
            f"match the {net} backbone layout "
            f"({len(problems)} problems):\n" + "\n".join(problems)
            + "\nRegenerate the npz with scripts/convert_lpips_weights.py "
              "matching this framework version.")


@functools.lru_cache(maxsize=8)
def substitute_weights(net: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic randomly-initialized backbone + uniform calibration,
    the JAX package's documented substitute (``lpips_jax.py:256-285``),
    drawn the same way so the arrays are bit-identical.

    Values from it are a valid *relative* perceptual distance but are NOT
    comparable to published LPIPS numbers; the metrics label them
    ``lpips-<net>-substitute``.
    """
    # zlib.crc32, not builtin hash(): str hashing is salted per interpreter
    net_key = zlib.crc32(net.encode("utf-8")) & 0xFFFF
    rng = np.random.default_rng(np.random.SeedSequence([net_key, seed]))
    w: Dict[str, np.ndarray] = {}
    convs, taps = _net_layer_specs(net)
    for name, kh, kw, cin, cout in convs:
        std = np.sqrt(2.0 / (kh * kw * cin))            # He init
        w[f"{name}/kernel"] = rng.normal(
            0.0, std, (kh, kw, cin, cout)).astype(np.float32)
        w[f"{name}/bias"] = np.zeros(cout, np.float32)
    for li, c in enumerate(taps):
        w[f"lin{li}/kernel"] = np.full((1, 1, c, 1), 1.0 / c, np.float32)
    return w


def prepare_weights(w: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """One net's npz-layout arrays as fp32 tensors on `device`, kernels
    turned from HWIO into OIHW."""
    out = {}
    for k, v in w.items():
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        if k.endswith("/kernel"):
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t.to(device)
    return out


def _as_image(img, device=None) -> torch.Tensor:
    if isinstance(img, np.ndarray):
        img = np.ascontiguousarray(img)      # torch takes no negative strides
    return torch.as_tensor(img, dtype=torch.float32, device=device)


def prepared_distances(img0, img1, nets: Dict[str, Dict[str, torch.Tensor]]
               ) -> Dict[str, Optional[float]]:
    return {net: (float(lpips_distance(img0, img1, net, nets[net]))
                  if net in nets else None) for net in NETS}


def lpips_all_from_nets(img0, img1, nets: Dict[str, Dict[str, np.ndarray]]
                        ) -> Dict[str, Optional[float]]:
    """{vgg, alex, squeeze} distances from in-memory npz-layout weight
    dicts (None for nets absent from `nets`). img0/img1: [H, W, 3] in
    [-1, 1], arrays or tensors; computed on img0's device."""
    img0 = _as_image(img0)
    img1 = _as_image(img1, img0.device)
    return prepared_distances(img0, img1, {n: prepare_weights(w, img0.device)
                                   for n, w in nets.items()})


PROVENANCE_KEY = "__provenance__"


def net_checksum(w: Dict[str, np.ndarray]) -> str:
    """sha256 over a net's tensors in sorted-key order (shape-tagged, so a
    reshape of identical bytes still changes the digest)."""
    h = hashlib.sha256()
    for k in sorted(w):
        arr = np.ascontiguousarray(np.asarray(w[k], np.float32))
        h.update(k.encode("utf-8"))
        h.update(str(arr.shape).encode("utf-8"))
        h.update(arr.tobytes())
    return h.hexdigest()


def write_weights_npz(path, nets: Dict[str, Dict[str, np.ndarray]],
                      meta: Dict[str, str]) -> str:
    """Write a layout-validated weights npz with its provenance record:
    `meta` (the converter's environment) plus each net's sha256, checked
    again at every load. Returns the whole file's sha256 (the JAX
    package's ``lpips_jax.write_weights_npz``)."""
    out: Dict[str, np.ndarray] = {}
    checksums = {}
    for net, w in nets.items():
        validate_net_weights(net, w, source="write_weights_npz input")
        for k, v in w.items():
            out[f"{net}/{k}"] = np.asarray(v, np.float32)
        checksums[net] = net_checksum(w)
    record = dict(meta, checksums=checksums, format=1)
    out[PROVENANCE_KEY] = np.frombuffer(
        json.dumps(record, sort_keys=True).encode("utf-8"), np.uint8)
    np.savez(path, **out)
    # np.savez appends '.npz' to a name without it: hash the file written
    written = str(path)
    if not written.endswith(".npz"):
        written += ".npz"
    with open(written, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _provenance_from(data) -> Dict:
    """Provenance record out of an already-open NpzFile ({} for legacy)."""
    if PROVENANCE_KEY not in data.files:
        return {}
    return json.loads(bytes(data[PROVENANCE_KEY].tolist()).decode("utf-8"))


def read_provenance(path: str) -> Dict:
    """The embedded provenance record, or {} for a legacy npz."""
    with np.load(path) as data:
        return _provenance_from(data)


@functools.lru_cache(maxsize=4)
def _load_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    nets: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            if key == PROVENANCE_KEY:
                continue
            if "/" not in key:
                raise ValueError(
                    f"LPIPS weights {path}: key {key!r} is not of the form "
                    f"<net>/<layer>/<param>: not a convert_lpips_weights.py "
                    f"file?")
            net, rest = key.split("/", 1)
            if net not in _EXTRACTORS:
                raise ValueError(
                    f"LPIPS weights {path}: unknown net prefix {net!r} "
                    f"(expected one of {sorted(_EXTRACTORS)})")
            nets.setdefault(net, {})[rest] = data[key]
        prov = _provenance_from(data)
    if not nets:
        raise ValueError(f"LPIPS weights {path}: file contains no nets")
    for net, w in nets.items():
        validate_net_weights(net, w, source=path)
    for net, want in prov.get("checksums", {}).items():
        if net not in nets:
            # a net the provenance promises but the file no longer carries
            # is tampering/truncation, not a smaller conversion
            raise ValueError(
                f"LPIPS weights {path}: provenance record lists net "
                f"{net!r} but the file contains no {net}/* tensors: "
                f"truncated or tampered. Regenerate with "
                f"scripts/convert_lpips_weights.py.")
        if net_checksum(nets[net]) != want:
            raise ValueError(
                f"LPIPS weights {path}: {net} tensors do not match the "
                f"embedded provenance sha256 ({want[:16]}…): the file was "
                f"modified or corrupted after conversion. Regenerate with "
                f"scripts/convert_lpips_weights.py.")
    return nets


def load_and_validate(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Public load + schema/provenance check (the runner's startup check)."""
    return _load_weights(path)


@functools.lru_cache(maxsize=4)
def device_nets(weights_path: Optional[str], device: str, seed: int = 0
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The nets of `weights_path` (or, for None, the substitute drawn from
    `seed`) prepared once for `device`."""
    if weights_path is None:
        nets = {net: substitute_weights(net, seed) for net in NETS}
    else:
        nets = _load_weights(weights_path)
    return {net: prepare_weights(w, device) for net, w in nets.items()}


def lpips_all(img0, img1, weights_path: str) -> Dict[str, Optional[float]]:
    """img0/img1 in [-1, 1]; returns {vgg, alex, squeeze} distances (None
    for nets missing from the weights file), on img0's device."""
    img0 = _as_image(img0)
    img1 = _as_image(img1, img0.device)
    return prepared_distances(img0, img1,
                      device_nets(weights_path, str(img0.device)))
