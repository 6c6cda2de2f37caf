"""VGG-16/19 and vggembed with the fc7 feature tap, in NCHW (the port's
counterpart of ``novel_vqa_tpu.models.vision.vgg``).

The reference's extractor (002_train_vqa_arch1/001_prepro_img_vgg.lua:36)
reads ``net.modules[38].output`` of the loadcaffe VGG: in evaluate mode the
post-ReLU fc7 activations (4096-d, non-negative).  ``apply(..., tap="fc7")``
returns exactly that.  Inputs are (N, 3, H, W) float32 in BGR order, scaled
to [0, 255] and mean-subtracted (``data/images.vgg_device_prepro``).

fc6 reads pool5 flattened in caffe's CHW order, so converted fc6 weights
load unchanged; in NCHW that is a plain reshape.  Each stage is a tracer
span (``core/profiling.span``: ``vgg.block1`` .. ``vgg.block5``,
``vgg.fc6``, ``vgg.fc7``, ``vgg.fc8`` / ``vgg.embed``), so a profile taken
with the tracer on reads the device time by stage (``nvqa.vgg.*``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.models.vision.layers import conv2d, conv_init, linear, linear_init, max_pool

# convs per block (all 3x3), a 2x2 max-pool after each.  "vggembed" is the
# early-fusion embedding net (thin_VGGNetEmbed in VGGEmbed.t7,
# 001_prepro_img_ef.lua:39-41): a VGG-16 backbone whose classifier head is a
# Linear(4096 -> 4800); the ef extractor taps that Linear's raw output.
_BLOCKS = {
    "vgg16": [2, 2, 3, 3, 3],
    "vgg19": [2, 2, 4, 4, 4],
    "vggembed": [2, 2, 3, 3, 3],
}
_WIDTHS = [64, 128, 256, 512, 512]


class VGGConfig(NamedTuple):
    arch: str = "vgg16"
    num_classes: int = 1000
    image_size: int = 224
    embed_dim: int = 4800  # vggembed head width (001_prepro_img_ef.lua:99)


def head_name(cfg: VGGConfig) -> str:
    return "embed" if cfg.arch == "vggembed" else "fc8"


def param_template(cfg: VGGConfig) -> Dict[str, Any]:
    """The params' tree with ``None`` leaves, in the order of the JAX
    package's tree: the structure ``core.checkpoint.unflatten_like`` reads a
    flat ``.npz`` into."""
    leaf = {"w": None, "b": None}
    return {"conv": [dict(leaf) for _ in range(sum(_BLOCKS[cfg.arch]))],
            "fc6": dict(leaf), "fc7": dict(leaf), head_name(cfg): dict(leaf)}


def init_params(cfg: VGGConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Dict[str, Any]:
    """He-init params drawn on the host from ``generator`` (so a seed gives
    the same weights on any device), placed on ``device``: ``cuda`` unless
    the caller asks for ``cpu``."""
    device = resolve_device(device)
    params: Dict[str, Any] = {"conv": []}
    c_in = 3
    for width, n in zip(_WIDTHS, _BLOCKS[cfg.arch]):
        for _ in range(n):
            params["conv"].append(conv_init(generator, 3, 3, c_in, width, device))
            c_in = width
    feat = (cfg.image_size // 32) ** 2 * 512  # 7*7*512 at 224
    params["fc6"] = linear_init(generator, feat, 4096, device)
    params["fc7"] = linear_init(generator, 4096, 4096, device)
    n_out = cfg.embed_dim if cfg.arch == "vggembed" else cfg.num_classes
    params[head_name(cfg)] = linear_init(generator, 4096, n_out, device)
    return params


def apply(params: Dict[str, Any], cfg: VGGConfig, images: torch.Tensor,
          tap: str = "fc7") -> torch.Tensor:
    """Forward of (N, 3, H, W) BGR mean-subtracted images; ``tap`` in
    {"pool5", "fc6", "fc7", "fc8", "embed"}.  fc6 and fc7 are post-ReLU;
    "embed" (vggembed) is the head's raw Linear output."""
    x = images
    ci = 0
    for bi, n in enumerate(_BLOCKS[cfg.arch]):
        with span(f"vgg.block{bi + 1}"):
            for _ in range(n):
                x = conv2d(params["conv"][ci], x)
                ci += 1
            x = max_pool(x)
    if tap == "pool5":
        return x
    with span("vgg.fc6"):
        x = linear(params["fc6"], x.reshape(x.shape[0], -1), relu=True)
    if tap == "fc6":
        return x
    with span("vgg.fc7"):
        x = linear(params["fc7"], x, relu=True)
    if tap == "fc7":
        return x
    with span(f"vgg.{tap}"):
        return linear(params[tap], x)


def forward_flops(cfg: VGGConfig, tap: str = "fc7") -> int:
    """Multiply-add FLOPs (2 per multiply-add) of one image's forward up to
    ``tap``, reckoned from the layer shapes above; pooling, ReLU and bias
    adds are not counted."""
    flops, c_in, size = 0, 3, cfg.image_size
    for width, n in zip(_WIDTHS, _BLOCKS[cfg.arch]):
        for _ in range(n):
            flops += 2 * size * size * 9 * c_in * width
            c_in = width
        size //= 2
    if tap == "pool5":
        return flops
    widths = [size * size * 512, 4096]  # fc6
    if tap != "fc6":
        widths.append(4096)  # fc7
    if tap in ("fc8", "embed"):
        widths.append(cfg.embed_dim if tap == "embed" else cfg.num_classes)
    return flops + sum(2 * a * b for a, b in zip(widths, widths[1:]))
