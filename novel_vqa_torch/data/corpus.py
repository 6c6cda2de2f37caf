"""Sequential-with-wrap corpus loader for the autoencoder trainers (copy of
``novel_vqa_tpu.data.corpus``, reading through the port's ``core/h5.py``).

Port of 001_train_autoencoder/misc/DataLoader.lua: per-split iterators over
``labels/{train,val,test}`` in a corpus h5 (the schema of
000_prepro_book_corpus.py:343-368), each batch read as a window of rows
(DataLoader.lua:71-79: the labels of the whole BookCorpus are hundreds of
MB), wrap-around at the split end, and labels returned time-major (L, N) as
the reference's transpose at :85.

Wrap quirk kept: when a batch crosses the split end the iterator resets to
element 0 *after* filling the tail from the beginning, so the first
``batch_size - num_left`` rows are read twice (DataLoader.lua:67-77).
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from novel_vqa_torch.core.h5 import H5Reader


class CorpusLoader:
    def __init__(self, h5_file: str, json_file: str):
        with open(json_file) as f:
            self.info = json.load(f)
        self.ix_to_word: Dict[str, str] = self.info["ix_to_word"]
        self.vocab_size = len(self.ix_to_word)
        self.split_count = {
            "train": self.info["num_train"],
            "val": self.info["num_val"],
            "test": self.info["num_test"],
        }
        self.h5 = H5Reader(h5_file)
        self.seq_length = self.h5.dataset("labels/train").shape[1]
        self.iterators = {"train": 0, "val": 0, "test": 0}

    def close(self):
        self.h5.close()

    def reset_iterator(self, split: str):
        self.iterators[split] = 0

    def split_rows(self, split: str) -> np.ndarray:
        """The whole split's labels, (N, L) int32."""
        return self.h5["labels/" + split].astype(np.int32)

    def get_batch(self, split: str, batch_size: int) -> Tuple[np.ndarray, dict]:
        """Returns (labels (L, N) int32 time-major, bounds info)."""
        ds = self.h5.dataset(f"labels/{split}")
        max_index = self.split_count[split]
        it = self.iterators[split]
        wrapped = False
        if it + batch_size > max_index:
            wrapped = True
            if it < max_index - 1:
                num_left = max_index - it
                head = ds[it:max_index]
                tail = ds[0 : batch_size - num_left]
                label_batch = np.concatenate([head, tail], axis=0)
            else:
                label_batch = ds[0:batch_size]
            self.iterators[split] = 0
        else:
            label_batch = ds[it : it + batch_size]
            self.iterators[split] = it + batch_size
        labels = np.ascontiguousarray(label_batch.astype(np.int32).T)  # (L, N)
        bounds = {
            "it_pos_now": self.iterators[split],
            "it_max": max_index,
            "wrapped": wrapped,
        }
        return labels, bounds
