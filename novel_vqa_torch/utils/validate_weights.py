"""One-command real-weight topology validation (port of
``novel_vqa_tpu.utils.validate_weights``).

The importers (train/import_caffe.py, import_t7.py, import_pth.py) are
wire-format-tested on synthetic artifacts only; the residual risk is a
mis-remembered TOPOLOGY vs the published weights — e.g. an Inception branch
arrangement that parses fine but permutes features
(002_train_vqa_arch1/001_prepro_img_inc.lua:34,
001_prepro_img_vgg.lua:36, net_utils.lua:25-33).  Only real weights + known
activations can close that, and this environment has zero egress — so this
tool makes the gate ONE command for the day data mounts:

  # record fixtures once, from a trusted environment (real weights + a few
  # real images; either package's tool on a validated host):
  python -m novel_vqa_torch.utils.validate_weights --weights_dir /data/weights \
      --images '/data/coco_samples/*.jpg' --make_fixtures fixtures.json

  # validate THIS framework's importers + vision towers against them:
  python -m novel_vqa_torch.utils.validate_weights --weights_dir /data/weights \
      --images '/data/coco_samples/*.jpg' --fixtures fixtures.json

Weight files are auto-discovered by name + extension (vgg16/vgg19/inception
x .npz/.caffemodel/.t7/.pth), converted through the port's importers
(``train/import_caffe.py``, ``import_t7.py``, ``import_pth.py``) into the
npz tree both packages read, forwarded through the port's extraction
forward (``train/extract_features.build_model``, with the real decode path
when ``--images`` is given), and the taps' activation statistics + a
strided value slice are compared against the fixtures within float
tolerance (reduction order differs between devices and packages, so byte
digests would be wrong by design).  The fixtures' schema, taps and records
are the JAX tool's: a file recorded by either package's tool is checked by
the other's.

Without real data the tool still runs end to end on synthetic weights and
deterministic synthetic images (tests/test_torch_validate_weights.py:
record -> check -> corrupt -> fail), so the command is known-good before it
ever sees a real mount.  The forward runs on the card (``--device``,
default ``cuda``); ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SCHEMA = "novel-vqa-weight-fixtures-v1"

# production taps per model (SURVEY.md section 2.3 extraction stores); fc8
# logits ride along for VGG because class scores are the strongest
# published-weights signal (a topology permutation that somehow preserves
# fc7 statistics still scrambles fc8 argmaxes)
_MODEL_TAPS = {
    "vgg16": ("fc7", "fc8"),
    "vgg19": ("fc7", "fc8"),
    "inception": ("pool",),
}

_EXT_IMPORTERS = (".npz", ".caffemodel", ".t7", ".pth")

# filename -> model matching: ALL patterns in the tuple must match the
# lowercased basename.  The published zoo names don't all contain the
# literal "vgg16"/"vgg19" — the canonical Caffe files are
# VGG_ILSVRC_16_layers.caffemodel / VGG_ILSVRC_19_layers.caffemodel
# (002_train_vqa_arch1/001_prepro_img_vgg.lua:36) — so match
# "vgg" plus a standalone depth number anywhere in the basename.  The
# lookarounds keep "16" from matching inside "2016" or "160".
_MODEL_NAME_PATTERNS = {
    "vgg16": (r"vgg", r"(?<!\d)16(?!\d)"),
    "vgg19": (r"vgg", r"(?<!\d)19(?!\d)"),
    "inception": (r"inception",),  # inception, inception_v3, inceptionv3, ...
}


def discover_weights(weights_dir: str) -> Dict[str, str]:
    """Map model name -> weight file found under ``weights_dir`` (first
    match per model, preferring the order in ``_EXT_IMPORTERS``)."""
    found: Dict[str, Tuple[int, str]] = {}
    for path in sorted(glob.glob(os.path.join(weights_dir, "*"))):
        base = os.path.basename(path).lower()
        ext = os.path.splitext(base)[1]
        if ext not in _EXT_IMPORTERS:
            continue
        for model, pats in _MODEL_NAME_PATTERNS.items():
            if all(re.search(p, base) for p in pats):
                rank = _EXT_IMPORTERS.index(ext)
                if model not in found or rank < found[model][0]:
                    found[model] = (rank, path)
    return {m: p for m, (_, p) in found.items()}


def to_npz(model: str, path: str, workdir: str) -> str:
    """Convert any supported weight file into the framework's vision npz via
    the real importer code paths; npz passes through unchanged."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        return path
    out = os.path.join(workdir, f"{model}_imported.npz")
    if ext == ".caffemodel":
        from novel_vqa_torch.train.import_caffe import caffemodel_to_npz

        caffemodel_to_npz(path, out, arch=model, bgr_to_rgb=False)
    elif ext == ".t7":
        from novel_vqa_torch.core import t7
        from novel_vqa_torch.train.import_t7 import (
            inception_t7_to_npz,
            vision_t7_to_npz,
        )

        net = t7.load(path)
        if model == "inception":
            inception_t7_to_npz(net, out)
        else:
            vision_t7_to_npz(net, out, bgr_to_rgb=False, arch=model)
    elif ext == ".pth":
        from novel_vqa_torch.core.checkpoint import save_npz
        from novel_vqa_torch.train.import_pth import import_inception, import_vgg

        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        flat = (
            import_inception(sd) if model == "inception"
            else import_vgg(sd, model)
        )
        save_npz(out, flat)
    else:  # pragma: no cover - discover_weights filters extensions
        raise ValueError(f"unsupported weight extension: {path}")
    return out


def load_fixture_images(
    pattern: Optional[str], size: int, center_crop: bool, n_synth: int = 4
) -> Tuple[np.ndarray, str]:
    """(N, size, size, 3) uint8 batch + a source tag recorded into fixtures.

    With ``pattern``: real files through the production decode pool (the
    same pixels extract_features would feed).  Without: deterministic
    synthetic photo-like images, so record/check agree byte-for-byte on the
    input side across hosts."""
    if pattern:
        paths = sorted(glob.glob(pattern))
        if not paths:
            raise FileNotFoundError(f"--images matched nothing: {pattern}")
        from novel_vqa_torch.data.images import DecodePool

        pool = DecodePool(size, center_crop, workers=2)
        try:
            batches = [u8 for u8, _, _ in pool.iter_batches(paths, len(paths))]
        finally:
            pool.close()
        tag = "files:" + hashlib.sha256(
            "\n".join(os.path.basename(p) for p in paths).encode()
        ).hexdigest()[:16]
        return np.concatenate(batches)[: len(paths)], tag
    rs = np.random.RandomState(20260818)
    imgs = []
    for _ in range(n_synth):
        base = rs.rand(max(1, size // 8), max(1, size // 8), 3)
        img = np.kron(base, np.ones((8, 8, 1)))[:size, :size]
        pad = [(0, size - img.shape[0]), (0, size - img.shape[1]), (0, 0)]
        img = np.pad(img, pad, mode="edge")
        img += rs.rand(size, size, 3) * 0.1
        imgs.append((img * 255 / img.max()).astype(np.uint8))
    return np.stack(imgs), "synthetic-v1"


def _tap_record(feats: np.ndarray, n_slice: int = 64) -> dict:
    flat = np.asarray(feats, np.float64).reshape(-1)
    stride = max(1, flat.size // n_slice)
    return {
        "shape": list(feats.shape),
        "mean": float(flat.mean()),
        "std": float(flat.std()),
        "min": float(flat.min()),
        "max": float(flat.max()),
        "slice_stride": stride,
        "slice": [float(v) for v in flat[::stride][:n_slice]],
        # per-image argmax: the published-weights class/feature-channel
        # signal (tolerance-free — a permuted topology can't survive it)
        "argmax": [int(i) for i in np.asarray(feats).reshape(feats.shape[0], -1).argmax(1)],
    }


def _tap_compare(name: str, rec: dict, feats: np.ndarray, rtol: float,
                 atol: float) -> List[str]:
    errs: List[str] = []
    got = _tap_record(feats, n_slice=len(rec["slice"]))
    if got["shape"] != rec["shape"]:
        return [f"{name}: shape {got['shape']} != fixture {rec['shape']}"]
    for stat in ("mean", "std", "min", "max"):
        if not np.isclose(got[stat], rec[stat], rtol=rtol, atol=atol):
            errs.append(
                f"{name}: {stat} {got[stat]:.6g} != fixture {rec[stat]:.6g}"
            )
    if got["slice_stride"] == rec["slice_stride"] and not np.allclose(
        got["slice"], rec["slice"], rtol=rtol, atol=atol
    ):
        bad = int(np.argmax(~np.isclose(got["slice"], rec["slice"],
                                        rtol=rtol, atol=atol)))
        errs.append(
            f"{name}: value slice mismatch (first at strided index {bad}: "
            f"{got['slice'][bad]:.6g} vs {rec['slice'][bad]:.6g})"
        )
    if got["argmax"] != rec["argmax"]:
        errs.append(f"{name}: per-image argmax {got['argmax']} != "
                    f"fixture {rec['argmax']}")
    return errs


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--weights_dir", help="directory to auto-discover weight files in")
    ap.add_argument("--weights", help="explicit weight file (with --model)")
    ap.add_argument("--model", choices=sorted(_MODEL_TAPS),
                    help="model name for --weights")
    ap.add_argument("--images", help="glob of real image files (default: "
                    "deterministic synthetic images)")
    ap.add_argument("--fixtures", help="fixtures JSON to validate against")
    ap.add_argument("--make_fixtures", help="record fixtures JSON to this path")
    ap.add_argument("--prepro", default="reference",
                    choices=("reference", "torchvision"),
                    help="device prepro for the forward (torchvision-sourced "
                    ".pth weights need --prepro torchvision)")
    ap.add_argument("--image_size", type=int, default=0,
                    help="override input resolution (tests/dry-runs only)")
    ap.add_argument("--rtol", type=float, default=2e-3)
    ap.add_argument("--atol", type=float, default=2e-3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if bool(args.fixtures) == bool(args.make_fixtures):
        ap.error("pass exactly one of --fixtures (check) / --make_fixtures (record)")
    if args.weights and not args.model:
        ap.error("--weights requires --model")

    if args.weights:
        weight_files = {args.model: args.weights}
    elif args.weights_dir:
        weight_files = discover_weights(args.weights_dir)
        if not weight_files:
            print(f"ERROR: no recognizable weight files under "
                  f"{args.weights_dir} (looked for vgg16/vgg19/inception x "
                  f"{'/'.join(_EXT_IMPORTERS)})", file=sys.stderr)
            return 2
    else:
        ap.error("pass --weights_dir or --weights/--model")

    fixtures = None
    if args.fixtures:
        with open(args.fixtures) as f:
            fixtures = json.load(f)
        if fixtures.get("schema") != SCHEMA:
            print(f"ERROR: fixtures schema {fixtures.get('schema')!r} != "
                  f"{SCHEMA!r}", file=sys.stderr)
            return 2

    from novel_vqa_torch.core.device import resolve_device
    from novel_vqa_torch.train.extract_features import build_model

    device = resolve_device(args.device)

    out = {"schema": SCHEMA, "prepro": args.prepro, "models": {}}
    failures: List[str] = []
    n_compared = 0  # taps actually compared — PASS requires at least one
    source_mismatch = False
    img_cache: Dict[Tuple[int, bool], Tuple[np.ndarray, str]] = {}
    with tempfile.TemporaryDirectory(prefix="nvqa_valweights_") as workdir:
        for model, wfile in sorted(weight_files.items()):
            print(f"[{model}] weights: {wfile}", file=sys.stderr)
            npz = to_npz(model, wfile, workdir)
            taps = _MODEL_TAPS[model]
            rec: dict = {"weights_file": os.path.basename(wfile),
                         "weights_sha256": _sha256(wfile), "taps": {}}
            fx = (fixtures or {}).get("models", {}).get(model)
            if fixtures is not None and fx is None:
                print(f"[{model}] SKIP: no fixture entry", file=sys.stderr)
                continue
            if fx and fx.get("weights_sha256") not in (None, rec["weights_sha256"]):
                print(f"[{model}] WARNING: weight file bytes differ from the "
                      "fixture's (recorded from a different file); comparing "
                      "activations anyway", file=sys.stderr)
            for tap in taps:
                forward, size, crop, _ = build_model(
                    model, npz, tap, seed=0, prepro_mode=args.prepro,
                    image_size=args.image_size, device=device,
                )
                # decode once per (size, crop) — taps of one model (and VGG
                # siblings) share the input resolution, so the image set
                # and its source tag are identical across them
                key = (size, crop)
                if key not in img_cache:
                    img_cache[key] = load_fixture_images(args.images, size, crop)
                images, source = img_cache[key]
                out["image_source"] = source
                if fixtures is not None and fixtures.get("image_source") != source:
                    # the source tag depends only on --images, not on the
                    # model/tap: one mismatch invalidates every comparison,
                    # so fail once and stop instead of per-tap repeats
                    failures.append(
                        f"image source {source!r} != fixture "
                        f"{fixtures.get('image_source')!r} (different input "
                        "images — re-record or fix --images)")
                    source_mismatch = True
                    break
                feats = forward(
                    torch.from_numpy(images).to(device),
                    torch.zeros(len(images), dtype=torch.bool, device=device),
                ).cpu().numpy()
                if fixtures is not None:
                    fx_tap = fx["taps"].get(tap)
                    if fx_tap is None:
                        failures.append(
                            f"{model}/{tap}: fixture has no record for this "
                            "tap (recorded with an older tap set? re-record)")
                        continue
                    errs = _tap_compare(
                        f"{model}/{tap}", fx_tap, feats,
                        args.rtol, args.atol,
                    )
                    failures.extend(errs)
                    n_compared += 1
                    print(f"[{model}] {tap}: "
                          + ("OK" if not errs else f"{len(errs)} mismatches"),
                          file=sys.stderr)
                else:
                    rec["taps"][tap] = _tap_record(feats)
                    print(f"[{model}] {tap}: recorded "
                          f"{tuple(feats.shape)}", file=sys.stderr)
            out["models"][model] = rec
            if source_mismatch:
                break

    if args.make_fixtures:
        with open(args.make_fixtures, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.make_fixtures} "
              f"({len(out['models'])} models)", file=sys.stderr)
        return 0
    fixture_only = sorted(set(fixtures.get("models", {})) - set(weight_files))
    if fixture_only:
        print(f"WARNING: fixture models not found under the weights "
              f"location (not validated): {', '.join(fixture_only)}",
              file=sys.stderr)
    if failures:
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        print(f"VALIDATION FAILED: {len(failures)} mismatches", file=sys.stderr)
        return 1
    if n_compared == 0:
        # every discovered model was skipped for lacking a fixture entry (or
        # nothing overlapped) — a green exit here would mean "validated
        # nothing"; make it a hard error instead
        print("ERROR: no tap was compared — discovered weights and fixture "
              "entries do not overlap; nothing was validated", file=sys.stderr)
        return 2
    print(f"VALIDATION PASSED ({n_compared} taps compared)", file=sys.stderr)
    return 0


def main(argv=None):  # pragma: no cover - thin exit-code wrapper
    raise SystemExit(run(argv))


if __name__ == "__main__":  # pragma: no cover
    main()
