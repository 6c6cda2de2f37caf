"""PyTorch state_dict (.pth) -> vision trunk .npz importer (port of
``novel_vqa_tpu.train.import_pth``).

The reference's VGG weights ship as caffemodel/t7 (``import_caffe.py``,
``import_t7.py``); torchvision-format state dicts are the most available
source of VGG-16/19 and Inception-v3 weights, so this tool maps them onto
the JAX package's keys and layout (HWIO convs, (in, out) linears), which
``core/convert.py`` turns OIHW at load:

  * vgg16/vgg19: the ordered ``features.*.weight`` convs and the three
    ``classifier.*`` Linears -> conv/i, fc6/fc7/fc8;
  * inception: torchvision's named blocks (``Conv2d_1a_3x3`` .. ``Mixed_7c``,
    ``branchX.conv/bn``) map 1:1 onto ``stem.c1..c5`` / ``mixedNx.bX``
    units; the BN running stats fold into inference-mode batch norm; the
    aux head (``AuxLogits``) is dropped; without ``fc.*`` the head is
    written as zeros (the pool tap never reads it).

Torchvision weights expect RGB in [0, 1] normalized by mean (0.485, 0.456,
0.406) / std (0.229, 0.224, 0.225), not the reference's caffe pipelines:
extract with ``--prepro torchvision``.

    python -m novel_vqa_torch.train.import_pth --pth inception_v3.pth \\
        --arch inception --out inception.npz
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict

import numpy as np

from novel_vqa_torch.core.checkpoint import save_npz


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _conv_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))).astype(np.float32)


def _indices(sd, pattern: str):
    return sorted({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def import_vgg(sd: Dict[str, Any], arch: str) -> Dict[str, np.ndarray]:
    conv_idx = _indices(sd, r"features\.(\d+)\.weight$")
    expected = {"vgg16": 13, "vgg19": 16}[arch]
    if len(conv_idx) != expected:
        raise ValueError(f"{arch} expects {expected} convs, the state_dict has {len(conv_idx)}")
    cls_idx = _indices(sd, r"classifier\.(\d+)\.weight$")
    if len(cls_idx) != 3:
        raise ValueError(f"expected 3 classifier Linears, got {cls_idx}")
    flat: Dict[str, np.ndarray] = {}
    for i, fi in enumerate(conv_idx):
        flat[f"conv/{i}/w"] = _conv_hwio(_to_np(sd[f"features.{fi}.weight"]))
        flat[f"conv/{i}/b"] = _to_np(sd[f"features.{fi}.bias"])
    for name, ci in zip(("fc6", "fc7", "fc8"), cls_idx):
        flat[f"{name}/w"] = np.ascontiguousarray(_to_np(sd[f"classifier.{ci}.weight"]).T)
        flat[f"{name}/b"] = _to_np(sd[f"classifier.{ci}.bias"])
    return flat


_STEM_MAP = [
    ("Conv2d_1a_3x3", "c1"),
    ("Conv2d_2a_3x3", "c2"),
    ("Conv2d_2b_3x3", "c3"),
    ("Conv2d_3b_1x1", "c4"),
    ("Conv2d_4a_3x3", "c5"),
]
_MIXED = [
    "Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
    "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c",
]


def _tv_branch(key: str) -> str:
    # b5x5_1 -> branch5x5_1 ; bpool -> branch_pool
    return "branch_pool" if key == "bpool" else "branch" + key[1:]


def _fill_cbr(unit: Dict[str, Any], sd, prefix: str):
    unit["conv"]["w"] = _conv_hwio(_to_np(sd[f"{prefix}.conv.weight"]))
    unit["bn"] = {
        "scale": _to_np(sd[f"{prefix}.bn.weight"]),
        "offset": _to_np(sd[f"{prefix}.bn.bias"]),
        "mean": _to_np(sd[f"{prefix}.bn.running_mean"]),
        "var": _to_np(sd[f"{prefix}.bn.running_var"]),
    }


def import_inception(sd: Dict[str, Any]) -> Dict[str, Any]:
    from novel_vqa_torch.models.vision import inception

    cfg = inception.InceptionConfig()
    tree = inception.param_template(cfg)
    for tv_name, ours in _STEM_MAP:
        _fill_cbr(tree["stem"][ours], sd, tv_name)
    for tv_block in _MIXED:
        block = tree[tv_block.replace("Mixed_", "mixed").lower()]
        for key, unit in block.items():
            _fill_cbr(unit, sd, f"{tv_block}.{_tv_branch(key)}")
    if "fc.weight" in sd:
        tree["fc"] = {"w": np.ascontiguousarray(_to_np(sd["fc.weight"]).T), "b": _to_np(sd["fc.bias"])}
    else:
        tree["fc"] = {"w": np.zeros((2048, cfg.num_classes), np.float32),
                      "b": np.zeros(cfg.num_classes, np.float32)}
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pth", required=True, help="torch state_dict file")
    ap.add_argument("--arch", required=True, choices=["vgg16", "vgg19", "inception"])
    ap.add_argument("--out", required=True, help="output .npz")
    args = ap.parse_args(argv)

    import torch

    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if args.arch in ("vgg16", "vgg19"):
        np.savez(args.out, **import_vgg(sd, args.arch))
    else:
        save_npz(args.out, import_inception(sd))
    print("wrote", args.out)
    print("NOTE: torchvision weights expect --prepro torchvision at extraction "
          "time (RGB [0,1], ImageNet mean/std), not the reference caffe pipeline")


if __name__ == "__main__":
    main()
