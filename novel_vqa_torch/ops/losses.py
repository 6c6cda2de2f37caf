"""Loss criteria (port of ``novel_vqa_tpu.ops.losses.cross_entropy``).

``cross_entropy`` is Torch ``nn.CrossEntropyCriterion`` on 1-indexed targets
(002_train_vqa_arch1/002_train_baseline.lua:157): log-softmax + NLL averaged
over the batch.
"""

from __future__ import annotations

import torch


def cross_entropy(scores: torch.Tensor, labels_1indexed: torch.Tensor) -> torch.Tensor:
    """scores: (N, C); labels are 1-indexed class ids.

    Label 0 (an unlabelled split's placeholder) picks the last class, as the
    negative index does in the JAX package; that loss is meaningless and
    every caller discards it, but it must not index out of range."""
    logp = torch.log_softmax(scores, dim=-1)
    labels0 = labels_1indexed.long() - 1
    labels0 = torch.where(labels0 < 0, labels0 + scores.shape[-1], labels0)
    picked = torch.gather(logp, 1, labels0[:, None])[:, 0]
    return -torch.mean(picked)
