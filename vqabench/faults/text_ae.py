"""The text autoencoder's faults:
  * ``unchanged``: the optimizer's update is not applied;
  * ``half_batch_tokens``: the loss is the mean over the scored tokens of
    the first half of the batch only;
  * ``token``: one greedy token altered as it is made.
"""

from __future__ import annotations

from vqabench.faults import UNCHANGED


def _half_targets(original):
    def sequence_targets(seq, Mp1):
        targets, scored = original(seq, Mp1)
        scored = scored.clone()
        scored[:, seq.shape[1] // 2:] = False
        return targets, scored
    return sequence_targets


def _alter_token(original):
    def sample(*args, **kwargs):
        tokens, logprobs = original(*args, **kwargs)
        tokens = tokens.clone()
        tokens[3, 0] = tokens[3, 0] % 20 + 1
        return tokens, logprobs
    return sample


FAULTS = {
    "unchanged": UNCHANGED,
    "half_batch_tokens": ("novel_vqa_torch.models.seq.autoencoder", "sequence_targets",
                          _half_targets),
    "token": ("novel_vqa_torch.models.seq.autoencoder", "sample", _alter_token),
}
