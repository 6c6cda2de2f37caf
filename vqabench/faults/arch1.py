"""arch1's faults:
  * ``unchanged``: the optimizer's update is not applied;
  * ``half_batch_ce``: the loss is the cross-entropy's mean over the
    first half of the batch only;
  * ``answer`` / ``mc_answer``: one OE / MC answer altered as it is made.
"""

from __future__ import annotations

from vqabench.faults import UNCHANGED


def _half_cross_entropy(original):
    def cross_entropy(scores, labels):
        half = scores.shape[0] // 2
        return original(scores[:half], labels[:half])
    return cross_entropy


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


FAULTS = {
    "unchanged": UNCHANGED,
    "half_batch_ce": ("novel_vqa_torch.models.vqa.arch1", "cross_entropy", _half_cross_entropy),
    "answer": ("novel_vqa_torch.models.vqa.eval_paths", "device_predict",
               lambda original: _alter_answer(original, "oe")),
    "mc_answer": ("novel_vqa_torch.models.vqa.eval_paths", "device_predict",
                  lambda original: _alter_answer(original, "mc")),
}
