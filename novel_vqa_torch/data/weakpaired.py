"""Weak-paired (caption) data loader and the image crop (port of
``novel_vqa_tpu.data.weakpaired``).

Port of 001_train_autoencoder/misc/DataLoaderWeakPaired.lua: the corpus h5's
sequential-with-wrap batching (``data/corpus.CorpusLoader``) plus the raw
``images/<split>`` 3x256x256 byte images read as the same window of rows
(:72, :82-99).  Images go to the device as uint8; the crop and the mean
subtraction run there (``prepro_wp_images``), as net_utils.prepro does
(misc/net_utils.lua:143-176): a random crop at train, the center crop at
eval, then the RGB VGG mean subtracted (the CNN is build_cnn's BGR->RGB
swapped net, net_utils.lua:25-33, so inputs stay RGB).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from novel_vqa_torch.data.corpus import CorpusLoader

VGG_MEAN_RGB = (123.68, 116.779, 103.939)


class WeakPairedLoader(CorpusLoader):
    def get_batch_with_images(self, split: str, batch_size: int) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Returns (labels (L, N) int32, images (N, H, W, 3) uint8, bounds);
        only the batch's rows of the two datasets are read."""
        ds = self.h5.dataset(f"labels/{split}")
        ims = self.h5.dataset(f"images/{split}")
        max_index = self.split_count[split]
        it = self.iterators[split]
        wrapped = False
        if it + batch_size > max_index:
            wrapped = True
            if it < max_index - 1:
                head = batch_size - (max_index - it)
                label_batch = np.concatenate([ds[it:max_index], ds[0:head]])
                img_batch = np.concatenate([ims[it:max_index], ims[0:head]])
            else:
                label_batch, img_batch = ds[0:batch_size], ims[0:batch_size]
            self.iterators[split] = 0
        else:
            label_batch, img_batch = ds[it : it + batch_size], ims[it : it + batch_size]
            self.iterators[split] = it + batch_size
        labels = np.ascontiguousarray(label_batch.astype(np.int32).T)
        # the reference stores CHW (3, 256, 256): NHWC uint8 for the device
        if img_batch.ndim == 4 and img_batch.shape[1] == 3:
            img_batch = np.transpose(img_batch, (0, 2, 3, 1))
        bounds = {"it_pos_now": self.iterators[split], "it_max": max_index, "wrapped": wrapped}
        return labels, np.ascontiguousarray(img_batch, dtype=np.uint8), bounds


def prepro_wp_images(u8_rgb: torch.Tensor, crop_offsets: torch.Tensor, crop_size: int = 224) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB and (N, 2) integer (row, col) crop origins
    chosen on the host -> (N, 3, crop, crop) float32 crops, RGB mean
    subtracted; one gather on the device."""
    n = u8_rgb.shape[0]
    span = torch.arange(crop_size, device=u8_rgb.device)
    rows = crop_offsets[:, 0:1].long() + span  # (N, crop)
    cols = crop_offsets[:, 1:2].long() + span
    crops = u8_rgb[torch.arange(n, device=u8_rgb.device)[:, None, None], rows[:, :, None], cols[:, None, :]]
    mean = torch.tensor(VGG_MEAN_RGB, dtype=torch.float32, device=u8_rgb.device)
    return (crops.float() - mean).permute(0, 3, 1, 2)


def random_crop_offsets(rng: np.random.Generator, n: int, src: int, dst: int) -> np.ndarray:
    return rng.integers(0, src - dst + 1, size=(n, 2)).astype(np.int32)


def center_crop_offsets(n: int, src: int, dst: int) -> np.ndarray:
    return np.full((n, 2), (src - dst) // 2, np.int32)
