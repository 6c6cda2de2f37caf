"""Host-side image decode and resize, and the device-side normalisation
(the port's counterpart of ``novel_vqa_tpu.data.images``).

The host decodes and resizes to uint8 RGB (the native C++ decoder of
``native/``, built at first use, or PIL) and ships uint8 to the device, a
quarter of float32's bytes; the float conversion, channel reorder and mean
subtraction run on the device (``vgg_device_prepro``,
``inception_device_prepro``, ``torchvision_device_prepro``), which return
NCHW float32.

The pixel math reproduces the reference's VGG extractor
(002_train_vqa_arch1/001_prepro_img_vgg.lua:47-71 ``loadim``): [0,1] float
load -> bilinear scale to 224x224 -> grayscale replicate / RGBA drop -> x255
-> channels (B-103.939, G-116.779, R-123.68).  A missing file gives the
reference's literal quirk image: its mean fill is built before the x255 and
the channel swap and flows through them (:52-57), giving the channels
``VGG_MISSING_BGR``.  The Inception extractor decodes a center square
crop and scales it to 299x299, then (x - 128) * 0.0078125 in RGB order
(001_prepro_img_inc.lua:40-57).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

VGG_MEAN_BGR = (103.939, 116.779, 123.68)
# the missing-file quirk constants (see the module docstring), BGR order
VGG_MISSING_BGR = (
    103.939 * 255.0 - 103.939,
    116.779 * 255.0 - 116.779,
    123.68 * 255.0 - 123.68,
)
TORCHVISION_MEAN_RGB = (0.485, 0.456, 0.406)
TORCHVISION_STD_RGB = (0.229, 0.224, 0.225)


def decode_resize(
    path: str, size: int, center_crop_square: bool = False
) -> Tuple[np.ndarray, bool]:
    """Decode and resize with PIL to (size, size, 3) uint8 RGB.  Returns
    (image, missing)."""
    from PIL import Image

    if not os.path.exists(path):
        return np.zeros((size, size, 3), np.uint8), True
    with Image.open(path) as im:
        if im.mode != "RGB":
            im = im.convert("RGB")
        if center_crop_square:
            w, h = im.size
            m = min(w, h)
            left, top = (w - m) // 2, (h - m) // 2
            im = im.crop((left, top, left + m, top + m))
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8), False


def default_decoder(use_native: bool = True) -> str:
    """The decoder a ``DecodePool`` takes: "native" when the C++ decoder
    builds and loads (``native_images.available()``), else "pil"."""
    from novel_vqa_torch.data import native_images

    return "native" if use_native and native_images.available() else "pil"


class DecodePool:
    """Threaded decode with batches decoded ahead of the consumer: batch i+1
    decodes while the device runs batch i.  ``decoder`` records which
    decoder it uses ("native" or "pil"), so callers can report it."""

    def __init__(
        self,
        size: int,
        center_crop_square: bool = False,
        workers: int = 8,
        use_native: bool = True,
        fast_decode: bool = False,
        prefetch_depth: int = 3,
    ):
        self.size = size
        self.center_crop_square = center_crop_square
        self.workers = workers
        # DCT-downscaled JPEG decode (native only): cheaper, pixels off by a
        # few intensity levels; off by default, as in the JAX package
        self.fast_decode = fast_decode
        self.prefetch_depth = max(1, prefetch_depth)
        self.decoder = default_decoder(use_native)
        self.pool = ThreadPoolExecutor(max_workers=2)  # batch-level prefetch

    def _decode_batch(self, paths: Sequence[str]):
        if self.decoder == "native":
            from novel_vqa_torch.data import native_images

            return native_images.decode_batch_native(
                list(paths), self.size, self.center_crop_square, self.workers,
                fast_scale=self.fast_decode,
            )
        results = [decode_resize(p, self.size, self.center_crop_square) for p in paths]
        imgs = np.stack([r[0] for r in results])
        missing = np.asarray([r[1] for r in results], bool)
        return imgs, missing

    def iter_batches(
        self, paths: Sequence[str], batch_size: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yields (uint8 batch, missing mask, real_count); the final batch is
        padded to batch_size by repeating the first row, so every batch has
        one shape."""
        chunks = [paths[i : i + batch_size] for i in range(0, len(paths), batch_size)]
        futures: deque = deque()
        next_ci = 0
        while next_ci < min(self.prefetch_depth, len(chunks)):
            futures.append(self.pool.submit(self._decode_batch, chunks[next_ci]))
            next_ci += 1
        while futures:
            imgs, missing = futures.popleft().result()
            if next_ci < len(chunks):
                futures.append(self.pool.submit(self._decode_batch, chunks[next_ci]))
                next_ci += 1
            real = imgs.shape[0]
            if real < batch_size:
                pad = batch_size - real
                imgs = np.concatenate([imgs, np.repeat(imgs[:1], pad, 0)])
                missing = np.concatenate([missing, np.zeros(pad, bool)])
            yield imgs, missing, real

    def close(self):
        self.pool.shutdown()


def _channels(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device).view(1, 3, 1, 1)


def vgg_device_prepro(u8_rgb: torch.Tensor, missing: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB and an (N,) bool missing mask -> (N, 3, H, W)
    float32, BGR, mean-subtracted; a missing row is the quirk image."""
    bgr = u8_rgb.permute(0, 3, 1, 2).flip(1).float() - _channels(VGG_MEAN_BGR, u8_rgb)
    quirk = _channels(VGG_MISSING_BGR, u8_rgb)
    return torch.where(missing.view(-1, 1, 1, 1), quirk, bgr)


def inception_device_prepro(u8_rgb: torch.Tensor, missing: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB -> (N, 3, H, W) float32, (x - 128) * 0.0078125,
    RGB order.  A missing file is its zero image, as decoded."""
    return (u8_rgb.permute(0, 3, 1, 2).float() - 128.0) * 0.0078125


def torchvision_device_prepro(u8_rgb: torch.Tensor, missing: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB -> (N, 3, H, W) float32 with torchvision's
    ImageNet normalisation: x/255 minus the mean over the std, RGB order.
    For weights trained that way, not the reference's VGG prepro."""
    x = u8_rgb.permute(0, 3, 1, 2).float() / 255.0
    return (x - _channels(TORCHVISION_MEAN_RGB, u8_rgb)) / _channels(TORCHVISION_STD_RGB, u8_rgb)
