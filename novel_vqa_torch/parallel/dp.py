"""Batch gather over a device-resident split store (port of
``novel_vqa_tpu.parallel.dp.gather_batch``; the rest of the data-parallel
module comes with the multi-GPU slice)."""

from __future__ import annotations


def gather_batch(data, qinds):
    """(tokens, image, labels) of rows ``qinds`` from the store ``data``
    (tokens (N, D), image (M, F), img_pos (N,) 1-indexed, answers (N,));
    only the index vector crosses from the host (002_train_baseline.lua:
    195-222 inverted)."""
    tokens = data["tokens"][qinds]
    labels = data["answers"][qinds]
    iminds = data["img_pos"][qinds].long() - 1
    image = data["image"][iminds]
    return tokens, image, labels
