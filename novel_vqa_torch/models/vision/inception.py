"""Inception-v3 with the 2048-d global-pool feature tap, in NCHW (the port's
counterpart of ``novel_vqa_tpu.models.vision.inception``).

Replaces the reference's Inception-v3 t7 graph
(002_train_vqa_arch1/001_prepro_img_inc.lua:34), whose features are the
pre-logits global average pool (2048-d, ``nhimage 2048`` in the -inc
trainers).  The standard v3 topology: a BN-conv stem, 3 x InceptionA,
InceptionB, 4 x InceptionC, InceptionD, 2 x InceptionE; batch norm in
inference mode with folded running stats (eps 1e-3), as the always-
``evaluate()`` reference extractor runs it.  Input: (N, 3, H, W) float32
RGB, (x - 128) * 0.0078125 (``data/images.inception_device_prepro``).

Each branch is computed as written: the pool branch is avg_pool -> 1x1
conv -> BN -> ReLU.  The JAX package's default fuses the same-input 1x1
heads into one conv and pools after BN (``_cbr_multi``), and it has TPU
routes for the stem (space-to-depth, lane packing); all of these are exact
rewrites of this math, so the two packages differ by float reassociation
only.  Each stage is a tracer span (``core/profiling.span``:
``inception.stem``, ``.mixed5``, ``.mixed6``, ``.mixed7``, ``.pool``,
``.logits``), so a profile taken with the tracer on reads the device time
by stage (``nvqa.inception.*``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.models.vision.layers import (
    avg_pool,
    bn_init,
    conv_bn,
    conv_init,
    linear,
    linear_init,
    max_pool,
)


class InceptionConfig(NamedTuple):
    num_classes: int = 1000
    image_size: int = 299


# the smallest input whose VALID stem and reduction convs all have an output
MIN_IMAGE_SIZE = 75

# each block's conv+BN units as (kh, kw, c_in, c_out), in the JAX package's
# definition order (the order ``iter_conv_bn`` yields and the importers pair on)


def _block_a(c_in: int, pool_features: int):
    return {"b1x1": (1, 1, c_in, 64), "b5x5_1": (1, 1, c_in, 48), "b5x5_2": (5, 5, 48, 64),
            "b3x3dbl_1": (1, 1, c_in, 64), "b3x3dbl_2": (3, 3, 64, 96), "b3x3dbl_3": (3, 3, 96, 96),
            "bpool": (1, 1, c_in, pool_features)}


def _block_b(c_in: int):
    return {"b3x3": (3, 3, c_in, 384), "b3x3dbl_1": (1, 1, c_in, 64), "b3x3dbl_2": (3, 3, 64, 96),
            "b3x3dbl_3": (3, 3, 96, 96)}


def _block_c(c_in: int, c7: int):
    return {"b1x1": (1, 1, c_in, 192), "b7x7_1": (1, 1, c_in, c7), "b7x7_2": (1, 7, c7, c7),
            "b7x7_3": (7, 1, c7, 192), "b7x7dbl_1": (1, 1, c_in, c7), "b7x7dbl_2": (7, 1, c7, c7),
            "b7x7dbl_3": (1, 7, c7, c7), "b7x7dbl_4": (7, 1, c7, c7), "b7x7dbl_5": (1, 7, c7, 192),
            "bpool": (1, 1, c_in, 192)}


def _block_d(c_in: int):
    return {"b3x3_1": (1, 1, c_in, 192), "b3x3_2": (3, 3, 192, 320), "b7x7x3_1": (1, 1, c_in, 192),
            "b7x7x3_2": (1, 7, 192, 192), "b7x7x3_3": (7, 1, 192, 192), "b7x7x3_4": (3, 3, 192, 192)}


def _block_e(c_in: int):
    return {"b1x1": (1, 1, c_in, 320), "b3x3_1": (1, 1, c_in, 384), "b3x3_2a": (1, 3, 384, 384),
            "b3x3_2b": (3, 1, 384, 384), "b3x3dbl_1": (1, 1, c_in, 448), "b3x3dbl_2": (3, 3, 448, 384),
            "b3x3dbl_3a": (1, 3, 384, 384), "b3x3dbl_3b": (3, 1, 384, 384), "bpool": (1, 1, c_in, 192)}


def _units() -> Dict[str, Dict[str, tuple]]:
    return {
        "stem": {"c1": (3, 3, 3, 32), "c2": (3, 3, 32, 32), "c3": (3, 3, 32, 64),
                 "c4": (1, 1, 64, 80), "c5": (3, 3, 80, 192)},
        "mixed5b": _block_a(192, 32), "mixed5c": _block_a(256, 64), "mixed5d": _block_a(288, 64),
        "mixed6a": _block_b(288),
        "mixed6b": _block_c(768, 128), "mixed6c": _block_c(768, 160),
        "mixed6d": _block_c(768, 160), "mixed6e": _block_c(768, 192),
        "mixed7a": _block_d(768),
        "mixed7b": _block_e(1280), "mixed7c": _block_e(2048),
    }


def param_template(cfg: InceptionConfig) -> Dict[str, Any]:
    """The params' tree with ``None`` leaves, in the order of the JAX
    package's tree: the structure ``core.checkpoint.unflatten_like`` reads a
    flat ``.npz`` into."""
    unit = lambda: {"conv": {"w": None}, "bn": dict.fromkeys(("scale", "offset", "mean", "var"))}
    tree: Dict[str, Any] = {blk: {name: unit() for name in units} for blk, units in _units().items()}
    tree["fc"] = {"w": None, "b": None}
    return tree


def init_params(cfg: InceptionConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Dict[str, Any]:
    """He-init convs (no bias: BN holds the shift), identity BN stats, the
    ``fc`` head He-init; drawn on the host from ``generator`` (so a seed
    gives the same weights on any device; the draws differ from
    ``jax.random``'s), placed on ``device``: ``cuda`` unless the caller
    asks for ``cpu``."""
    device = resolve_device(device)

    def unit(kh, kw, c_in, c_out):
        return {"conv": {"w": conv_init(generator, kh, kw, c_in, c_out, device)["w"]},
                "bn": bn_init(c_out, device)}

    params: Dict[str, Any] = {blk: {name: unit(*shape) for name, shape in units.items()}
                              for blk, units in _units().items()}
    params["fc"] = linear_init(generator, 2048, cfg.num_classes, device)
    return params


def iter_conv_bn(params: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """Every {conv, bn} unit in definition order (the dict order of
    ``init_params``/``param_template``): the hook the weight importers use
    to map an ordered external conv list onto this tree."""
    def walk(p):
        if isinstance(p, dict):
            if set(p) == {"conv", "bn"}:
                yield p
            else:
                for v in p.values():
                    yield from walk(v)

    yield from walk(params)


def _cbr(p, x, stride: int = 1, padding: str = "SAME"):
    return conv_bn(p["conv"], p["bn"], x, stride, padding)


def _inception_a(p, x):
    b1 = _cbr(p["b1x1"], x)
    b5 = _cbr(p["b5x5_2"], _cbr(p["b5x5_1"], x))
    b3 = _cbr(p["b3x3dbl_3"], _cbr(p["b3x3dbl_2"], _cbr(p["b3x3dbl_1"], x)))
    bp = _cbr(p["bpool"], avg_pool(x, 3))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x):
    b3 = _cbr(p["b3x3"], x, 2, "VALID")
    bd = _cbr(p["b3x3dbl_2"], _cbr(p["b3x3dbl_1"], x))
    bd = _cbr(p["b3x3dbl_3"], bd, 2, "VALID")
    return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=1)


def _inception_c(p, x):
    b1 = _cbr(p["b1x1"], x)
    b7 = _cbr(p["b7x7_3"], _cbr(p["b7x7_2"], _cbr(p["b7x7_1"], x)))
    bd = _cbr(p["b7x7dbl_1"], x)
    for name in ("b7x7dbl_2", "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5"):
        bd = _cbr(p[name], bd)
    bp = _cbr(p["bpool"], avg_pool(x, 3))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x):
    b3 = _cbr(p["b3x3_2"], _cbr(p["b3x3_1"], x), 2, "VALID")
    b7 = _cbr(p["b7x7x3_3"], _cbr(p["b7x7x3_2"], _cbr(p["b7x7x3_1"], x)))
    b7 = _cbr(p["b7x7x3_4"], b7, 2, "VALID")
    return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=1)


def _inception_e(p, x):
    b1 = _cbr(p["b1x1"], x)
    b3 = _cbr(p["b3x3_1"], x)
    b3 = torch.cat([_cbr(p["b3x3_2a"], b3), _cbr(p["b3x3_2b"], b3)], dim=1)
    bd = _cbr(p["b3x3dbl_2"], _cbr(p["b3x3dbl_1"], x))
    bd = torch.cat([_cbr(p["b3x3dbl_3a"], bd), _cbr(p["b3x3dbl_3b"], bd)], dim=1)
    bp = _cbr(p["bpool"], avg_pool(x, 3))
    return torch.cat([b1, b3, bd, bp], dim=1)


def apply(params: Dict[str, Any], cfg: InceptionConfig, images: torch.Tensor,
          tap: str = "pool") -> torch.Tensor:
    """Forward of (N, 3, H, W) normalized RGB images; ``tap`` "pool" gives
    the (N, 2048) f32 global average pool, "logits" the ``fc`` head."""
    s = params["stem"]
    with span("inception.stem"):
        x = _cbr(s["c1"], images, 2, "VALID")
        x = _cbr(s["c2"], x, 1, "VALID")
        x = max_pool(_cbr(s["c3"], x), 3, 2)
        x = _cbr(s["c5"], _cbr(s["c4"], x, 1, "VALID"), 1, "VALID")
        x = max_pool(x, 3, 2)
    with span("inception.mixed5"):
        for name in ("mixed5b", "mixed5c", "mixed5d"):
            x = _inception_a(params[name], x)
    with span("inception.mixed6"):
        x = _inception_b(params["mixed6a"], x)
        for name in ("mixed6b", "mixed6c", "mixed6d", "mixed6e"):
            x = _inception_c(params[name], x)
    with span("inception.mixed7"):
        x = _inception_d(params["mixed7a"], x)
        for name in ("mixed7b", "mixed7c"):
            x = _inception_e(params[name], x)
    with span("inception.pool"):
        x = x.mean(dim=(2, 3))
    if tap == "pool":
        return x
    if tap != "logits":
        raise ValueError(f"unknown Inception tap {tap!r}: 'pool' or 'logits'")
    with span("inception.logits"):
        return linear(params["fc"], x)


def _conv_out(size: int, k: int, stride: int = 1) -> int:
    return (size - k) // stride + 1  # VALID


def forward_flops(cfg: InceptionConfig, tap: str = "pool") -> int:
    """Multiply-add FLOPs (2 per multiply-add) of one image's forward up to
    ``tap``, reckoned from the conv shapes; pooling, BN, ReLU and the mean
    are not counted."""
    u = _units()
    flops = 0

    def conv(shape, size):
        kh, kw, c_in, c_out = shape
        return 2 * size * size * kh * kw * c_in * c_out

    s = cfg.image_size
    s = _conv_out(s, 3, 2)
    flops += conv(u["stem"]["c1"], s)
    s = _conv_out(s, 3)
    flops += conv(u["stem"]["c2"], s) + conv(u["stem"]["c3"], s)
    s = _conv_out(s, 3, 2)
    flops += conv(u["stem"]["c4"], s)
    s = _conv_out(s, 3)
    flops += conv(u["stem"]["c5"], s)
    s = _conv_out(s, 3, 2)
    for blk in ("mixed5b", "mixed5c", "mixed5d"):
        flops += sum(conv(shape, s) for shape in u[blk].values())
    s2 = _conv_out(s, 3, 2)
    b = u["mixed6a"]
    flops += conv(b["b3x3"], s2) + conv(b["b3x3dbl_1"], s) + conv(b["b3x3dbl_2"], s) + conv(b["b3x3dbl_3"], s2)
    s = s2
    for blk in ("mixed6b", "mixed6c", "mixed6d", "mixed6e"):
        flops += sum(conv(shape, s) for shape in u[blk].values())
    s2 = _conv_out(s, 3, 2)
    d = u["mixed7a"]
    flops += sum(conv(d[k], s) for k in ("b3x3_1", "b7x7x3_1", "b7x7x3_2", "b7x7x3_3"))
    flops += conv(d["b3x3_2"], s2) + conv(d["b7x7x3_4"], s2)
    s = s2
    for blk in ("mixed7b", "mixed7c"):
        flops += sum(conv(shape, s) for shape in u[blk].values())
    if tap == "logits":
        flops += 2 * 2048 * cfg.num_classes
    return flops
