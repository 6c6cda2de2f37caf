"""Faults planted underneath a cell's timed path, to show that the check
which decides ``correct`` catches them (``calibrate.py`` on the card,
``tests/test_vqabench_faults.py`` on the CPU).  Never used by a benchmark run.

Each fault patches one function of the port where the result is made:
  * ``unchanged``: the optimizer's update is not applied (the state comes
    back as it went in);
  * ``half_batch``: the loss is the mean over the first half of the batch
    only (arch1's cross-entropy; the autoencoder's scored tokens);
  * ``answer`` / ``mc_answer``: one OE / MC answer altered as it is made;
  * ``token``: one greedy token altered as it is made.
"""

from __future__ import annotations

import contextlib
import importlib



def _half_cross_entropy(original):
    def cross_entropy(scores, labels):
        half = scores.shape[0] // 2
        return original(scores[:half], labels[:half])
    return cross_entropy


def _half_targets(original):
    def sequence_targets(seq, Mp1):
        targets, scored = original(seq, Mp1)
        scored = scored.clone()
        scored[:, seq.shape[1] // 2:] = False
        return targets, scored
    return sequence_targets


def _alter_answer(original, which):
    def device_predict(scores, choices=None):
        pred, mc = original(scores, choices)
        pred, mc = pred.clone(), mc.clone()
        if which == "oe":
            pred[0] = pred[0] % scores.shape[1] + 1
        else:
            other = choices[0][choices[0] != mc[0]][0]
            mc[0] = other
        return pred, mc
    return device_predict


def _alter_token(original):
    def sample(*args, **kwargs):
        tokens, logprobs = original(*args, **kwargs)
        tokens = tokens.clone()
        tokens[3, 0] = tokens[3, 0] % 20 + 1
        return tokens, logprobs
    return sample


FAULTS = {
    "unchanged": ("novel_vqa_torch.parallel.mesh", "apply_updates",
                  lambda original: (lambda params, updates: params)),
    "half_batch_ce": ("novel_vqa_torch.models.vqa.arch1", "cross_entropy", _half_cross_entropy),
    "half_batch_tokens": ("novel_vqa_torch.models.seq.autoencoder", "sequence_targets",
                          _half_targets),
    "answer": ("novel_vqa_torch.models.vqa.eval_paths", "device_predict",
               lambda original: _alter_answer(original, "oe")),
    "mc_answer": ("novel_vqa_torch.models.vqa.eval_paths", "device_predict",
                  lambda original: _alter_answer(original, "mc")),
    "token": ("novel_vqa_torch.models.seq.autoencoder", "sample", _alter_token),
}

# the faults each cell can have
BY_CELL = {
    "arch1.train": ("unchanged", "half_batch_ce"),
    "text_ae.train": ("unchanged", "half_batch_tokens"),
    "arch1.eval": ("answer", "mc_answer"),
    "text_ae.val": ("half_batch_tokens", "token"),
}


@contextlib.contextmanager
def plant(name: str):
    """The port with fault ``name`` inside the block."""
    module_name, attr, make = FAULTS[name]
    module = importlib.import_module(module_name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)



