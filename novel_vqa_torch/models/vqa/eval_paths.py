"""Eval paths over a device-resident split store (port of
``novel_vqa_tpu.models.vqa.eval_paths``).

Every architecture with the forward contract
``apply(params, cfg, tokens, image, deterministic=True) -> (B, num_output)``
gets the same four paths from :func:`build_eval_fns`; all mirror the
reference's full-split eval loop (004_eval_model.lua:202-231, which holds the
whole ``fv_im`` store resident for the pass):

* ``eval_step_indexed(cfg, params, data, qinds, dp=None)`` -> ``(loss,
  scores)``: one batch gathered on the device from the store; only the index
  vector moves (``dp``: this rank's rows of a DP batch, ``parallel/mesh``).
* ``eval_predict_indexed`` -> ``(loss, pred, mc_pred)``: the same plus the
  OE/MC argmax next to the scores (``predict.device_predict``).
* ``eval_predict_scan(cfg, params, data, n_batches, batch_size)`` ->
  ``(losses, pred, mc_pred)``, preds (n_batches, batch_size): the whole
  split as a loop over contiguous index chunks (the JAX package's
  ``lax.scan``).  Out-of-range rows of the final chunk are clamped to the
  last row; callers trim.
* ``eval_scores_scan`` -> ``(losses, scores)``: the same loop returning the
  full score matrices.

``data`` keys: tokens (N, D), image (M, F), img_pos (N,) 1-indexed, answers
(N,) (zeros for unlabeled splits), optional mc_ans (N, 18).  Everything runs
under ``torch.inference_mode()``.
"""

from __future__ import annotations

import torch

from novel_vqa_torch.models.vqa.predict import device_predict
from novel_vqa_torch.ops.losses import cross_entropy
from novel_vqa_torch.parallel.dp import gather_batch


def _gather_choices(data, qinds):
    return data["mc_ans"][qinds] if "mc_ans" in data else None


def build_eval_fns(apply_fn):
    """Returns ``(eval_step_indexed, eval_predict_indexed,
    eval_predict_scan, eval_scores_scan)`` for one architecture's ``apply``.

    CAVEAT on the scan losses: the final chunk clamps out-of-range indices
    to row ``n-1``, so its per-batch cross-entropy averages DUPLICATED rows
    whenever ``n % batch_size != 0``: the final-chunk loss term (and any
    split loss derived from the scan outputs) is biased.  Every current
    caller trims preds/scores by ``n`` and discards the losses; a caller
    that starts consuming them must mask the padded rows first."""

    def _forward(cfg, params, data, qinds, dp=None):
        tokens, image, labels = gather_batch(data, qinds)
        scores = apply_fn(params, cfg, tokens, image, deterministic=True, dp=dp)
        return cross_entropy(scores, labels), scores

    @torch.inference_mode()
    def eval_step_indexed(cfg, params, data, qinds, dp=None):
        return _forward(cfg, params, data, qinds, dp)

    @torch.inference_mode()
    def eval_predict_indexed(cfg, params, data, qinds, dp=None):
        loss, scores = _forward(cfg, params, data, qinds, dp)
        pred, mc_pred = device_predict(scores, _gather_choices(data, qinds))
        return loss, pred, mc_pred

    def _scan(cfg, params, data, n_batches, batch_size, chunk_out):
        n = data["tokens"].shape[0]
        arange = torch.arange(batch_size, device=data["tokens"].device)
        losses, outs = [], []
        for i in range(n_batches):
            qinds = torch.clamp(i * batch_size + arange, max=n - 1)
            loss, scores = _forward(cfg, params, data, qinds)
            losses.append(loss)
            outs.append(chunk_out(scores, data, qinds))
        return (torch.stack(losses),) + tuple(torch.stack(o) for o in zip(*outs))

    @torch.inference_mode()
    def eval_predict_scan(cfg, params, data, n_batches: int, batch_size: int):
        return _scan(
            cfg, params, data, n_batches, batch_size,
            lambda scores, data, qinds: device_predict(
                scores, _gather_choices(data, qinds)
            ),
        )

    @torch.inference_mode()
    def eval_scores_scan(cfg, params, data, n_batches: int, batch_size: int):
        return _scan(
            cfg, params, data, n_batches, batch_size,
            lambda scores, data, qinds: (scores,),
        )

    return eval_step_indexed, eval_predict_indexed, eval_predict_scan, eval_scores_scan
