"""Right alignment of questions (copy of ``novel_vqa_tpu.data.align``).

Ports 002_train_vqa_arch1/misc/RNNUtils.lua:54-61: each row's ``length``
leading tokens move to the end of the buffer, the front is zero-filled.
Every sequence then ends at the last step, so the final state of a masked
dense scan is each row's final LSTM state.
"""

from __future__ import annotations

import numpy as np


def right_align_fast(seq: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """seq: (N, D) int tokens (0-padded at the tail); lengths: (N,)."""
    seq = np.asarray(seq)
    lengths = np.asarray(lengths).astype(np.int64)
    N, D = seq.shape
    cols = np.arange(D)[None, :]
    src_idx = cols - (D - lengths[:, None])  # column in seq feeding each slot
    valid = src_idx >= 0
    gathered = np.take_along_axis(seq, np.clip(src_idx, 0, D - 1), axis=1)
    return np.where(valid, gathered, 0).astype(seq.dtype)
