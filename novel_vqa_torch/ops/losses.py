"""Loss criteria (port of ``novel_vqa_tpu.ops.losses``).

``cross_entropy`` is Torch ``nn.CrossEntropyCriterion`` on 1-indexed targets
(002_train_vqa_arch1/002_train_baseline.lua:157): log-softmax + NLL averaged
over the batch.

``sequence_nll`` is ``nn.LanguageModelCriterion``
(001_train_autoencoder/misc/AutoEncoder.lua:437-474): the masked NLL of the
shifted targets over decoder logprobs, END (= vocab_size+1, the last class)
at each sequence's first null, normalized by the number of scored steps.
``sequence_targets`` builds those targets; the autoencoder's fused decoder
loss shares it.
"""

from __future__ import annotations

from typing import Tuple

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


def sequence_targets(seq: torch.Tensor, Mp1: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted targets and the scored mask (AutoEncoder.lua:450-462).

    seq: (D, N) 1-indexed tokens, 0 = null suffix.  Returns (targets (D+1, N)
    int64 with END = ``Mp1`` at each sequence's first null, scored (D+1, N)
    bool)."""
    D, N = seq.shape
    targets = torch.cat([seq.long(), seq.new_zeros(1, N, dtype=torch.long)], dim=0)
    # the first null per column; there is always one, the appended row
    first_null = torch.argmax((targets == 0).to(torch.int32), dim=0)
    t_idx = torch.arange(D + 1, device=seq.device)[:, None]
    targets = torch.where(t_idx == first_null[None, :], Mp1, targets)
    return targets, targets != 0


def sequence_nll(logprobs: torch.Tensor, seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked sequence NLL.

    logprobs: (D+1, N, M+1), each step predicting the next token and the
    last END; seq: (D, N) 1-indexed tokens, 0 = null suffix.  Returns
    (loss, n), n the number of scored predictions (AutoEncoder.lua:471-472).
    """
    L, N, Mp1 = logprobs.shape
    if seq.shape[0] != L - 1:
        raise ValueError("logprobs must have one more step than seq")
    targets, scored = sequence_targets(seq, Mp1)
    gather_idx = torch.clamp(targets - 1, 0, Mp1 - 1)
    picked = torch.gather(logprobs, 2, gather_idx[:, :, None])[:, :, 0]
    n = scored.sum()
    loss = -torch.where(scored, picked, torch.zeros_like(picked)).sum() / n.to(logprobs.dtype)
    return loss, n
