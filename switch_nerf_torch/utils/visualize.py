"""Visualization helpers for eval outputs.

Port of ``switch_nerf_tpu/utils/visualize.py``:
  * visualize_scalars: log-scale positive depths, 5/95-quantile normalize,
    inverted colormap: OpenCV's INFERNO (the default) or RAINBOW
    (--colormap 4, the classic-NeRF default), from their 256-entry tables
    (OpenCV's applyColorMap of 0..255, as RGB bytes), so the port needs no
    OpenCV.
  * voc_palette: expert-id segmentation colours.
"""
from __future__ import annotations

import numpy as np

_INFERNO = bytes.fromhex(
    "00000401000501010601010802010a02020c02020e030210040312040314050417060419"
    "07051b08051d09061f0a07220b07240c08260d08290e092b10092d110a30120a32140b34"
    "150b37160b39180c3c190c3e1b0c411c0c431e0c451f0c48210c4a230c4c240c4f260c51"
    "280b53290b552b0b572d0b592f0a5b310a5c320a5e340a5f3609613809623909633b0964"
    "3d09653e0966400a67420a68440a68450a69470b6a490b6a4a0c6b4c0c6b4d0d6c4f0d6c"
    "510e6c520e6d540f6d550f6d57106e59106e5a116e5c126e5d126e5f136e61136e62146e"
    "64156e65156e67166e69166e6a176e6c186e6d186e6f196e71196e721a6e741a6e751b6e"
    "771c6d781c6d7a1d6d7c1d6d7d1e6d7f1e6c801f6c82206c84206b85216b87216b88226a"
    "8a226a8c23698d23698f24699025689225689326679526679727669827669a28659b2964"
    "9d29649f2a63a02a63a22b62a32c61a52c60a62d60a82e5fa92e5eab2f5ead305dae305c"
    "b0315bb1325ab3325ab43359b63458b73557b93556ba3655bc3754bd3853bf3952c03a51"
    "c13a50c33b4fc43c4ec63d4dc73e4cc83f4bca404acb4149cc4248ce4347cf4446d04545"
    "d24644d34743d44842d54a41d74b3fd84c3ed94d3dda4e3cdb503bdd513ade5238df5337"
    "e05536e15635e25734e35933e45a31e55c30e65d2fe75e2ee8602de9612bea632aeb6429"
    "eb6628ec6726ed6925ee6a24ef6c23ef6e21f06f20f1711ff1731df2741cf3761bf37819"
    "f47918f57b17f57d15f67e14f68013f78212f78410f8850ff8870ef8890cf98b0bf98c0a"
    "f98e09fa9008fa9207fa9407fb9606fb9706fb9906fb9b06fb9d07fc9f07fca108fca309"
    "fca50afca60cfca80dfcaa0ffcac11fcae12fcb014fcb216fcb418fbb61afbb81dfbba1f"
    "fbbc21fbbe23fac026fac228fac42afac62df9c72ff9c932f9cb35f8cd37f8cf3af7d13d"
    "f7d340f6d543f6d746f5d949f5db4cf4dd4ff4df53f4e156f3e35af3e55df2e661f2e865"
    "f2ea69f1ec6df1ed71f1ef75f1f179f2f27df2f482f3f586f3f68af4f88ef5f992f6fa96"
    "f8fb9af9fc9dfafda1fcffa4")

_RAINBOW = bytes.fromhex(
    "ff0000ff0200ff0500ff0800ff0a00ff0c00ff0f00ff1200ff1400ff1600ff1900ff1b00"
    "ff1e00ff2000ff2300ff2600ff2800ff2a00ff2d00ff3000ff3200ff3400ff3700ff3900"
    "ff3c00ff3e00ff4100ff4400ff4600ff4800ff4b00ff4e00ff5000ff5200ff5500ff5800"
    "ff5a00ff5c00ff5f00ff6200ff6400ff6600ff6900ff6c00ff6e00ff7000ff7300ff7500"
    "ff7800ff7a00ff7d00ff8000ff8200ff8400ff8700ff8a00ff8c00ff8e00ff9100ff9400"
    "ff9600ff9800ff9b00ff9e00ffa000ffa200ffa500ffa800ffaa00ffac00ffaf00ffb200"
    "ffb400ffb600ffb900ffbc00ffbe00ffc000ffc300ffc600ffc800ffca00ffcd00ffd000"
    "ffd200ffd400ffd700ffda00ffdc00ffdf00ffe100ffe400ffe600ffe800ffeb00ffee00"
    "fff000fff300fff500fff800fffa00fffc00fcfd00f8fe00f4fe00f0ff00ebff00e6ff00"
    "e1ff00dcff00d7ff00d2ff00cdff00c8ff00c3ff00beff00b9ff00b4ff00afff00aaff00"
    "a5ff00a0ff009bff0096ff0091ff008cff0087ff0082ff007dff0078ff0073ff006eff00"
    "69ff0064ff005fff005aff0055ff0050ff004bff0046ff0041ff003cff0037ff0032ff00"
    "2dff0028ff0023ff001eff0019ff0014ff000fff000bfe0107fd0203fc0300fa0500f50a"
    "00f00f00eb1400e61900e11e00dc2300d72800d22d00cd3200c83700c33c00be4100b946"
    "00b44b00af5000aa5500a55a00a05f009b6400966900916e008c7300877800827d007d82"
    "00788700738c006e9100699600649b005fa0005aa50055aa0050af004bb40046b90041be"
    "003cc30037c80032cd002dd20028d70023dc001ee10019e60014eb000ff0000af50107f8"
    "0305fa0503fc0701fe0a00ff0d00ff1100ff1400ff1700ff1b00ff1e00ff2100ff2500ff"
    "2800ff2b00ff2f00ff3200ff3500ff3900ff3c00ff3f00ff4300ff4600ff4900ff4d00ff"
    "5000ff5300ff5700ff5a00ff5d00ff6100ff6400ff6700ff6b00ff6e00ff7100ff7500ff"
    "7800ff7b00ff7f00ff8200ff8500ff8900ff8c00ff8f00ff9300ff9600ff9900ff9d00ff"
    "a000ffa300ffa700ffaa00ff")

# OpenCV's colormap ids -> [256, 3] uint8 RGB tables
_COLORMAPS = {14: _INFERNO, 4: _RAINBOW}


def visualize_scalars(scalar_tensor: np.ndarray,
                      colormap: int | None = None) -> np.ndarray:
    """[H, W] scalars -> [H, W, 3] uint8 colormapped.

    colormap: an OpenCV COLORMAP_* id, INFERNO (14, the default) or
    RAINBOW (4)."""
    to_use = scalar_tensor.astype(np.float64).copy()
    while to_use.ndim > 2:
        to_use = to_use[..., 0]

    # log(d + 1e-8) over all pixels: zero depths land at the low extreme
    to_use = np.log(np.maximum(to_use, 0.0) + 1e-8)
    lo, hi = np.quantile(to_use, [0.05, 0.95])
    scale = max(hi - lo, 1e-8)
    norm = np.clip((to_use - lo) / scale, 0.0, 1.0)

    cmap = 14 if colormap is None else int(colormap)
    if cmap not in _COLORMAPS:
        raise NotImplementedError(
            f"colormap {cmap}: the port has INFERNO (14) and RAINBOW (4)")
    table = np.frombuffer(_COLORMAPS[cmap], np.uint8).reshape(256, 3)
    return table[((1.0 - norm) * 255).astype(np.uint8)]


def voc_palette(num_classes: int = 256) -> np.ndarray:
    """PASCAL-VOC color palette [N, 3] uint8 (bit-shuffled class colors)."""
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    palette = np.zeros((num_classes, 3), dtype=np.uint8)
    for k in range(num_classes):
        r = g = b = 0
        c = k
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        palette[k] = [r, g, b]
    return palette
