"""Image-feature extraction CLI, on the card by default: port of
``novel_vqa_tpu.train.extract_features`` (002_train_vqa_arch1/
001_prepro_img_{vgg,inc,ef}.lua).

Reads the ``unique_img_{train,val,test}`` lists of data_prepro.json, decodes
and resizes each image on the host, runs the CNN on the device, taps the
feature layer and writes ``/images_{train,test,val}`` float32 datasets in
list order through the port's own h5 writer (``core/h5.py``), with the JAX
CLI's dataset names, dtype and shapes.  ``--model2`` concatenates a second
net's features for the early-fusion store (001_prepro_img_ef.lua): vggembed
+ vgg19 gives 4800 + 4096 = 8896 columns.

The loop keeps ``--pipeline_depth`` batches in flight: the decode pool
decodes ahead; each batch is copied into a pinned host buffer and uploaded
with a non-blocking copy on a side stream; its features are copied back
behind an event on another side stream and read only when ``depth`` newer
batches are queued, so uploads, the forward and the copies back overlap.

Same flags as the JAX CLI plus ``--device``.  ``--compute_dtype float32``
(default) runs in true fp32, TF32 off in a scope the extraction owns;
``bfloat16`` stores weights and activations in bf16 (within 1e-2 of fp32).
``--model inception`` taps Inception-v3's 2048-d global pool at 299x299
from a center square crop.  ``--weights`` takes a converted ``.npz``
(``train/import_caffe.py``, ``import_t7.py``, ``import_pth.py`` or the JAX
package's); without one the net is randomly initialised from ``--seed``
(throughput runs and smoke tests only: a warning is printed).  With more
than one card it still runs on one (``--device``); sharded extraction
comes with ROADMAP A13.

    python -m novel_vqa_torch.train.extract_features --input_json data_prepro.json \\
        --image_root images/ --weights vgg16.npz --out_name data_img.h5
    python -m novel_vqa_torch.train.extract_features ... --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from collections import deque
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.h5 import write_h5
from novel_vqa_torch.data import images as I
from novel_vqa_torch.models.vision import inception, vgg
from novel_vqa_torch.models.vision.layers import bf16_storage_cast, fp32_exact

_NETS = {vgg.VGGConfig: vgg, inception.InceptionConfig: inception}


@dataclasses.dataclass
class ExtractConfig:
    input_json: str = "data_prepro.json"
    image_root: str = ""
    model: str = "vgg16"  # vgg16 | vgg19 | vggembed | inception
    weights: str = ""  # converted .npz weight dump ('' = random init)
    model2: str = ""  # optional second net for early fusion
    weights2: str = ""
    batch_size: int = 32
    out_name: str = "data_img.h5"
    tap: str = "fc7"
    decode_workers: int = 8
    pipeline_depth: int = 4  # batches in flight
    # DCT-downscaled JPEG decode in the native decoder (pixels off by a few
    # intensity levels; off by default)
    fast_decode: int = 0
    seed: int = 123
    limit: int = -1  # cap images per split (smoke tests)
    image_size: int = 0  # override the net's input resolution (smoke tests)
    compute_dtype: str = "float32"  # float32 | bfloat16
    # "reference" = the pipeline of caffe/t7 weights (VGG: BGR 0-255
    # mean-subtracted; Inception: (x - 128) / 128); "torchvision" = ImageNet
    # normalisation, for weights imported by import_pth.py
    prepro: str = "reference"
    device: str = "cuda"


class Extractor:
    """One net's forward: (N, H, W, 3) uint8 and an (N,) bool missing mask
    on ``device`` -> (N, ndims) float32 features on ``device``.  The config
    names the net (VGG or Inception); the params' dtype is the route; TF32
    is off for the forward (it touches only the float32 route's
    products)."""

    def __init__(self, params, cfg, tap: str, prepro: Callable, ndims: int, device: torch.device):
        self.params, self.cfg, self.tap, self.prepro = params, cfg, tap, prepro
        self.ndims, self.device = ndims, device
        self.net = _NETS[type(cfg)]

    def __call__(self, u8: torch.Tensor, missing: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), fp32_exact():
            with record_function("extract.prepro"):
                x = self.prepro(u8, missing)
            return self.net.apply(self.params, self.cfg, x, self.tap).float()


def build_model(
    name: str, weights: str, tap: str, seed: int, prepro_mode: str = "reference",
    image_size: int = 0, compute_dtype: str = "float32", device: str | torch.device = "cuda",
):
    """Returns (forward, decode_size, center_crop, feature_dims); ``forward``
    is an ``Extractor``.  ``image_size`` overrides the net's input
    resolution (tests and dry runs only: the reference extractors are fixed
    at 224 and 299)."""
    device = resolve_device(device)
    if name == "inception":
        cfg = inception.InceptionConfig(image_size=image_size or 299)
        if cfg.image_size < inception.MIN_IMAGE_SIZE:
            raise ValueError(f"--image_size {cfg.image_size}: Inception-v3 needs at least "
                             f"{inception.MIN_IMAGE_SIZE}")
        net, tap, ndims, crop, reference = inception, "pool", 2048, True, I.inception_device_prepro
    elif name in ("vgg16", "vgg19", "vggembed"):
        cfg = vgg.VGGConfig(arch=name, image_size=image_size or 224)
        net, crop, reference = vgg, False, I.vgg_device_prepro
        if name == "vggembed":
            # the early-fusion embedding net's 4800-d module-39 tap
            # (001_prepro_img_ef.lua:99); pair with --model2 vgg19 for the
            # 8896-d ef store (:99-101)
            tap, ndims = "embed", cfg.embed_dim
        else:
            ndims = {"fc7": 4096, "fc6": 4096, "fc8": cfg.num_classes}[tap]
    else:
        raise ValueError(f"unknown --model {name}")
    prepro = {"reference": reference, "torchvision": I.torchvision_device_prepro}.get(prepro_mode)
    if prepro is None:
        raise ValueError(f"unknown --prepro {prepro_mode}")
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown --compute_dtype {compute_dtype}")

    if weights:
        from novel_vqa_torch.core.checkpoint import load_npz, unflatten_like
        from novel_vqa_torch.core.convert import vision_params_from_numpy

        flat, _ = load_npz(weights)
        params = vision_params_from_numpy(unflatten_like(net.param_template(cfg), flat), device)
    else:
        print(f"WARNING: no --weights for {name}; using RANDOM weights "
              "(features are meaningless for accuracy)", file=sys.stderr)
        params = net.init_params(cfg, torch.Generator().manual_seed(seed), device)
    if compute_dtype == "bfloat16":
        params = bf16_storage_cast(params)
    forward = Extractor(params, cfg, tap, prepro, ndims, device)
    return forward, cfg.image_size, crop, ndims


def _run_one(forward: Extractor, batches, depth: int, feats: np.ndarray, col: int) -> None:
    """``forward`` over ``batches`` with up to ``depth`` batches in flight;
    each batch's real rows land in ``feats[:, col:col + ndims]``."""
    dev, ndims = forward.device, forward.ndims
    cols = slice(col, col + ndims)
    row = 0
    if dev.type != "cuda":
        for u8, missing, real in batches:
            out = forward(torch.from_numpy(u8), torch.from_numpy(missing))
            feats[row : row + real, cols] = out[:real].numpy()
            row += real
        return
    compute = torch.cuda.current_stream(dev)
    upload, download = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    slots = []  # per slot in the ring: pinned (u8, missing, features)
    pending: deque = deque()  # (copy-back event, slot, row, real)

    def drain(limit):
        while len(pending) > limit:
            done, slot, prow, preal = pending.popleft()
            done.synchronize()
            feats[prow : prow + preal, cols] = slots[slot][2][:preal].numpy()

    for i, (u8, missing, real) in enumerate(batches):
        slot = i % depth
        if slot == len(slots):
            slots.append((torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True),
                          torch.empty(missing.shape, dtype=torch.bool, pin_memory=True),
                          torch.empty((u8.shape[0], ndims), dtype=torch.float32, pin_memory=True)))
        # the slot's earlier batch is drained: its copies are done
        h_u8, h_missing, h_out = slots[slot]
        h_u8.copy_(torch.from_numpy(u8))
        h_missing.copy_(torch.from_numpy(missing))
        with torch.cuda.stream(upload):
            d_u8 = h_u8.to(dev, non_blocking=True)
            d_missing = h_missing.to(dev, non_blocking=True)
        compute.wait_stream(upload)
        d_u8.record_stream(compute)
        d_missing.record_stream(compute)
        out = forward(d_u8, d_missing)
        download.wait_stream(compute)
        with torch.cuda.stream(download):
            h_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        out.record_stream(download)
        pending.append((done, slot, row, real))
        row += real
        drain(depth - 1)
    drain(0)


def run_pipelined_extraction(
    models, paths, batch_size: int, decode_workers: int,
    fast_decode: bool = False, feats: np.ndarray | None = None, depth: int = 4,
    predecoded=None,
):
    """The extraction loop over ``models`` (``build_model`` results), each
    in turn over all ``paths``, ``depth`` batches in flight.

    ``predecoded``: a list of ``(u8, missing, real)`` host batches served
    from RAM in place of the decode pool: the decode-free control, the same
    loop paying only upload, forward and copy back.  Single-model lists
    only (a control batch has one size).

    Returns ``(feats (N, sum of dims) float32, wall seconds)``; every
    feature is on the host when it returns.
    """
    if predecoded is not None and len(models) != 1:
        raise ValueError("predecoded control batches require a single model")
    depth = max(1, depth)
    if feats is None:
        feats = np.empty((len(paths), sum(m[3] for m in models)), np.float32)
    t0 = time.perf_counter()
    col = 0
    for forward, size, crop, ndims in models:
        pool = None
        if predecoded is None:
            pool = I.DecodePool(size, crop, workers=decode_workers,
                                fast_decode=fast_decode, prefetch_depth=depth)
            batches = pool.iter_batches(paths, batch_size)
        else:
            batches = iter(predecoded)
        try:
            _run_one(forward, batches, depth, feats, col)
        finally:
            if pool is not None:
                pool.close()
        col += ndims
    return feats, time.perf_counter() - t0


def main(argv=None):
    opt = parse_config(ExtractConfig, argv, description=__doc__)
    device = resolve_device(opt.device)
    with open(opt.input_json) as f:
        meta = json.load(f)
    models = [build_model(opt.model, opt.weights, opt.tap, opt.seed, opt.prepro,
                          opt.image_size, opt.compute_dtype, device)]
    if opt.model2:
        models.append(build_model(opt.model2, opt.weights2, opt.tap, opt.seed, opt.prepro,
                                  opt.image_size, opt.compute_dtype, device))
    print("decoder:", I.default_decoder())

    stores = {}
    for split in ("train", "test", "val"):
        paths = [os.path.join(opt.image_root, p) for p in meta.get(f"unique_img_{split}", [])]
        if opt.limit >= 0:
            paths = paths[: opt.limit]
        if not paths:
            continue
        feats, dt = run_pipelined_extraction(
            models, paths, opt.batch_size, opt.decode_workers,
            fast_decode=bool(opt.fast_decode), depth=opt.pipeline_depth,
        )
        print(f"processed {len(paths)} {split} images in {dt:.1f}s "
              f"({len(paths)/dt:.1f} images/sec)")
        stores[f"images_{split}"] = feats
    write_h5(opt.out_name, stores)
    print("wrote", opt.out_name)


if __name__ == "__main__":
    main()
