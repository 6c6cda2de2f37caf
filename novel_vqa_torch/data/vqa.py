"""VQA dataset: h5-backed loading and batching (numpy only).

Copy of ``novel_vqa_tpu.data.vqa``, the data path of
002_train_vqa_arch1/002_train_baseline.lua:
  * whole-h5 load into RAM (:93-111), through the port's own HDF5 reader
    (``core/h5.py``: the machine with the card has no h5py);
  * ``right_align`` of questions (:113-114);
  * optional L2 normalization of image features (:117-123, no epsilon);
  * random-with-replacement train batches (:195-222) from a seeded
    ``numpy.random.Generator``;
  * sequential batches over a split (:227-260) and the whole split as one
    host store for the device-resident eval path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.data.align import right_align_fast


@dataclass
class Batch:
    tokens: np.ndarray  # (N, D) int32, right-aligned, 0 = pad
    image: np.ndarray  # (N, nhimage) float32
    labels: np.ndarray  # (N,) int32, 1-indexed answers
    question_id: Optional[np.ndarray] = None
    mc_answers: Optional[np.ndarray] = None  # (N, 18) for MC eval


def _l2_rows(x: np.ndarray) -> np.ndarray:
    nm = np.sqrt(np.sum(x * x, axis=1, keepdims=True))
    return (x / nm).astype(np.float32)


class VQAData:
    """In-RAM VQA train/val(/test) arrays with reference-equivalent batching."""

    def __init__(
        self,
        input_ques_h5: str,
        input_img_h5: str,
        input_json: str,
        *,
        img_norm: bool = True,
        seed: int = 123,
        load_test: bool = False,
        img_norm_split_dims: Optional[list] = None,
        align: str = "right",  # "right" (arch1, :113-114) | "left" (arch2: none)
        splits: Optional[tuple] = None,
    ):
        wanted = (
            tuple(splits) if splits is not None
            else (("test",) if load_test else ("train", "val"))
        )
        with open(input_json) as f:
            meta = json.load(f)
        self.ix_to_word: Dict[str, str] = meta["ix_to_word"]
        self.ix_to_ans: Dict[str, str] = meta.get("ix_to_ans", {})
        self.vocab_size = len(self.ix_to_word)
        self.meta = meta

        d: Dict[str, np.ndarray] = {}
        with H5Reader(input_ques_h5) as f:
            for split in wanted:
                d[f"question_{split}"] = f[f"ques_{split}"]
                d[f"lengths_{split}"] = f[f"ques_length_{split}"]
                d[f"img_pos_{split}"] = f[f"img_pos_{split}"]
                d[f"question_id_{split}"] = f[f"question_id_{split}"]
            if "train" in wanted:
                d["answers_train"] = f["answers"]
            if "val" in wanted:
                d["answers_val"] = f["answers_val"]
            if "test" in wanted and "MC_ans_test" in f:
                d["mc_ans_test"] = f["MC_ans_test"]

        with H5Reader(input_img_h5) as f:
            for split in wanted:
                d[f"fv_im_{split}"] = np.asarray(f[f"images_{split}"], np.float32)

        for split in wanted:
            if align == "right":
                d[f"question_{split}"] = right_align_fast(
                    d[f"question_{split}"].astype(np.int32), d[f"lengths_{split}"]
                )
            else:
                d[f"question_{split}"] = d[f"question_{split}"].astype(np.int32)
            if img_norm:
                fv = d[f"fv_im_{split}"]
                if img_norm_split_dims:
                    if sum(img_norm_split_dims) != fv.shape[1]:
                        raise ValueError(
                            f"img_norm_split dims {img_norm_split_dims} sum to "
                            f"{sum(img_norm_split_dims)} but the feature width "
                            f"is {fv.shape[1]}"
                        )
                    # early-fusion features are L2-normalized per part
                    # (003_train_ae_based_ef.lua:116-124)
                    off = 0
                    parts = []
                    for dim in img_norm_split_dims:
                        parts.append(_l2_rows(fv[:, off : off + dim]))
                        off += dim
                    d[f"fv_im_{split}"] = np.concatenate(parts, axis=1)
                else:
                    d[f"fv_im_{split}"] = _l2_rows(fv)

        self.d = d
        self.rng = np.random.default_rng(seed)
        self.splits = wanted

    @property
    def seq_length(self) -> int:
        return self.d[f"question_{self.splits[0]}"].shape[1]

    @property
    def nhimage(self) -> int:
        return self.d[f"fv_im_{self.splits[0]}"].shape[1]

    def num_examples(self, split: str) -> int:
        return self.d[f"question_{split}"].shape[0]

    def sample_train_batch(self, batch_size: int) -> Batch:
        n = self.num_examples("train")
        qinds = self.rng.integers(0, n, size=batch_size)  # with replacement, :203
        iminds = self.d["img_pos_train"][qinds].astype(np.int64) - 1  # 1-indexed h5
        return Batch(
            tokens=self.d["question_train"][qinds],
            image=self.d["fv_im_train"][iminds],
            labels=self.d["answers_train"][qinds].astype(np.int32),
        )

    def split_store(self, split: str) -> Dict[str, np.ndarray]:
        """Host arrays of a whole split, uploaded once for the
        device-resident eval path (the reference eval likewise holds the
        full ``fv_im`` store resident, 004_eval_model.lua:202-231).
        ``answers`` is zeros for unlabeled splits (the loss is then
        meaningless)."""
        n = self.num_examples(split)
        labels_key = {"train": "answers_train", "val": "answers_val"}.get(split, "")
        store = {
            "tokens": self.d[f"question_{split}"],
            "image": self.d[f"fv_im_{split}"],
            "img_pos": self.d[f"img_pos_{split}"].astype(np.int32),
            "answers": (
                self.d[labels_key].astype(np.int32)
                if labels_key in self.d
                else np.zeros(n, np.int32)
            ),
        }
        if split == "test" and "mc_ans_test" in self.d:
            store["mc_ans"] = self.d["mc_ans_test"].astype(np.int32)
        return store

    def iter_split(self, split: str, batch_size: int) -> Iterator[Batch]:
        """Sequential batches over a split (val loop :337-381 / test eval);
        the final batch holds only the rows left.  (The JAX package's
        ``pad_to_batch`` option repeats row 0 into it; the port pads in
        ``train/eval_loop.py``, with the split's last row.)"""
        n = self.num_examples(split)
        labels_key = {"train": "answers_train", "val": "answers_val"}.get(split, "")
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(n, start + batch_size))
            iminds = self.d[f"img_pos_{split}"][idx].astype(np.int64) - 1
            yield Batch(
                tokens=self.d[f"question_{split}"][idx],
                image=self.d[f"fv_im_{split}"][iminds],
                labels=(
                    self.d[labels_key][idx].astype(np.int32)
                    if labels_key in self.d
                    else np.zeros(len(idx), np.int32)
                ),
                question_id=self.d[f"question_id_{split}"][idx],
                mc_answers=(
                    self.d["mc_ans_test"][idx]
                    if split == "test" and "mc_ans_test" in self.d else None
                ),
            )
