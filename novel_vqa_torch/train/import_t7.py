"""Torch7 checkpoint import/export CLI (port of
``novel_vqa_tpu.train.import_t7``; ``core/t7.py`` does the wire format).

  import-flat        lstm.t7 {encoder_w_q, embedding_w_q, multimodal_w} (or
                     arch2's {cnn_w, ...}) -> flat h5 the trainers and evals
                     load;
  export-flat        flat h5 -> t7, so the reference's Lua tooling reads ours;
  import-ae-transfer converted AE t7 {lookup, encoder[, multimodal]}
                     (002_convert_text_model_arch1.lua's output) -> the
                     transfer h5;
  import-vision      a saved nn t7 network (a loadcaffe VGG save, the
                     Inception t7) -> vision ``.npz`` trunk weights in the JAX
                     package's keys and layout (HWIO convs, (in, out)
                     linears; ``core/convert.py`` turns the convs OIHW at
                     load), with the optional BGR->RGB swap of the first
                     conv (misc/net_utils.lua:25-33).

The h5 files are written by the port's own writer (``core/h5.py``).  The
Inception template is the port's (``models/vision/inception.param_template``),
so nothing here needs JAX.

    python -m novel_vqa_torch.train.import_t7 import-vision --t7 inc.t7 \\
        --arch inception --out inception.npz
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List

import numpy as np

from novel_vqa_torch.core import t7
from novel_vqa_torch.core.checkpoint import load_flat_h5, save_flat_h5, save_npz
from novel_vqa_torch.core.h5 import write_h5


def collect_parameterized(obj: Any, out: List[Dict[str, np.ndarray]]):
    """Depth-first traversal of an nn module graph collecting {weight, bias}
    in definition order (Sequential containers keep their children in
    'modules')."""
    if isinstance(obj, t7.TorchObject):
        w = obj.get("weight")
        if isinstance(w, np.ndarray):
            out.append({"weight": w, "bias": obj.get("bias"), "class": obj.torch_typename,
                        "running_mean": obj.get("running_mean"),
                        "running_var": obj.get("running_var")})
        mods = obj.get("modules")
        if mods:
            for m in mods if isinstance(mods, list) else mods.values():
                collect_parameterized(m, out)
    elif isinstance(obj, list):
        for m in obj:
            collect_parameterized(m, out)
    elif isinstance(obj, dict):
        for m in obj.values():
            collect_parameterized(m, out)


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))).astype(np.float32)


def vision_t7_to_npz(net: Any, out_path: str, bgr_to_rgb: bool, arch: str):
    mods: List[Dict[str, np.ndarray]] = []
    collect_parameterized(net, mods)
    convs = [m for m in mods if m["weight"].ndim == 4]
    linears = [m for m in mods if m["weight"].ndim == 2]
    if not convs:
        raise ValueError("no conv layers found in t7 net")
    flat: Dict[str, np.ndarray] = {}
    for i, m in enumerate(convs):
        w = m["weight"]  # (O, I, KH, KW) torch layout
        if i == 0 and bgr_to_rgb:
            w = w[:, ::-1, :, :]  # swap B and R input channels
        flat[f"conv/{i}/w"] = _hwio(w)
        if m["bias"] is not None:
            flat[f"conv/{i}/b"] = np.asarray(m["bias"], np.float32)
    # "vggembed" = thin_VGGNetEmbed (001_prepro_img_ef.lua:39-41): a VGG-16
    # trunk whose third Linear is the 4800-d embedding head (module 39)
    fc_names = ["fc6", "fc7", "embed"] if arch == "vggembed" else ["fc6", "fc7", "fc8"]
    for name, m in zip(fc_names, linears):
        flat[f"{name}/w"] = np.ascontiguousarray(m["weight"].T).astype(np.float32)
        flat[f"{name}/b"] = np.asarray(m["bias"], np.float32)
    np.savez(out_path, **flat)
    print(f"wrote {out_path}: {len(convs)} convs, {len(linears)} linears "
          f"({[m['class'] for m in mods[:3]]}...)")


def inception_t7_to_npz(net: Any, out_path: str):
    """Map an ordered Inception-v3 t7 graph onto the Inception tree: the 94
    conv+BN units pair positionally with ``inception.iter_conv_bn``'s
    definition order, stem first (the standard v3 topology; a graph with
    the aux head must be stripped first: positional pairing cannot place
    its 2 convs).  The last Linear is the ``fc`` head; without one ``fc`` is
    written as zeros (the pool tap never reads it)."""
    from novel_vqa_torch.models.vision import inception

    mods: List[Dict[str, np.ndarray]] = []
    collect_parameterized(net, mods)
    convs = [m for m in mods if m["weight"].ndim == 4]
    bns = [m for m in mods if m["weight"].ndim == 1 and m.get("running_mean") is not None]
    if len(convs) != 94 or len(bns) != 94:
        raise ValueError(f"expected 94 conv+BN units for Inception-v3, got {len(convs)} convs / "
                         f"{len(bns)} BNs (strip the aux head before importing)")
    cfg = inception.InceptionConfig()
    tree = inception.param_template(cfg)
    for unit, cm, bm in zip(inception.iter_conv_bn(tree), convs, bns):
        unit["conv"]["w"] = _hwio(cm["weight"])
        unit["bn"] = {
            "scale": np.asarray(bm["weight"], np.float32),
            "offset": np.asarray(bm["bias"], np.float32),
            "mean": np.asarray(bm["running_mean"], np.float32),
            "var": np.asarray(bm["running_var"], np.float32),
        }
    linears = [m for m in mods if m["weight"].ndim == 2]
    if linears:
        tree["fc"] = {"w": np.ascontiguousarray(linears[-1]["weight"].T).astype(np.float32),
                      "b": np.asarray(linears[-1]["bias"], np.float32)}
    else:
        tree["fc"] = {"w": np.zeros((2048, cfg.num_classes), np.float32),
                      "b": np.zeros(cfg.num_classes, np.float32)}
    save_npz(out_path, tree)
    print(f"wrote {out_path}: 94 conv+BN units + {len(linears)} linears")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("import-flat")
    p.add_argument("--t7", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("export-flat")
    p.add_argument("--h5", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("import-ae-transfer")
    p.add_argument("--t7", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("import-vision")
    p.add_argument("--t7", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--arch", default="vgg16")
    p.add_argument(
        "--bgr_to_rgb", default=0, type=int,
        help="1 when importing a raw-caffe net into the RGB weak-paired "
        "pipeline (net_utils.build_cnn swap); 0 for the BGR extractor path",
    )
    args = ap.parse_args(argv)

    if args.cmd == "import-flat":
        obj = t7.load(args.t7)
        vectors = {k: np.asarray(v, np.float32) for k, v in obj.items() if isinstance(v, np.ndarray)}
        save_flat_h5(args.out, vectors)
        print("wrote", args.out, "keys:", sorted(vectors))
    elif args.cmd == "export-flat":
        vectors = load_flat_h5(args.h5)
        t7.save(args.out, {k: np.asarray(v, np.float32) for k, v in vectors.items()})
        print("wrote", args.out)
    elif args.cmd == "import-ae-transfer":
        obj = t7.load(args.t7)
        # the t7 converter stores lookup already transposed (E, V+1)
        keys = ["lookup", "encoder"] + (["multimodal"] if "multimodal" in obj else [])
        write_h5(args.out, {k: np.asarray(obj[k], np.float32) for k in keys})
        print("wrote", args.out)
    else:
        net = t7.load(args.t7)
        if args.arch == "inception":
            inception_t7_to_npz(net, args.out)
        else:
            vision_t7_to_npz(net, args.out, bool(args.bgr_to_rgb), args.arch)


if __name__ == "__main__":
    main()
