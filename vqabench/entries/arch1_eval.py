"""arch1 evaluation through ``eval_loop.run_full_split(hbm_resident=True,
want="predict")``: one call is a pass over the whole split (the store
uploaded, every batch gathered and answered on the device, the OE and MC
answers copied back to the host at its end).

Every answer of every pass in the window is judged: by the gap between
the reference's best score and the reference's score of the answer given
(OE over all answers, MC over the question's choices), so a near tie that
rounding decides either way is no fault and a wrong answer is.
"""

from __future__ import annotations

import numpy as np
import torch

from vqabench import common as C

BLOCK = 4096  # rows per reference block


class _Split:
    """The split as ``run_full_split`` reads it: host arrays."""

    def __init__(self, store: dict):
        self.store = store
        self.n = len(store["tokens"])

    def num_examples(self, split: str) -> int:
        return self.n

    def split_store(self, split: str) -> dict:
        return self.store


class Cell:
    traced_dispatches = 1
    steps_per_dispatch = None  # batches per pass, set below

    def __init__(self, ctx):
        from novel_vqa_torch.models.vqa import arch1
        from novel_vqa_torch.train import eval_loop

        c, p = ctx.cfg, ctx.traffic
        self.ctx, self.arch1, self.eval_loop = ctx, arch1, eval_loop
        self.B = p["batch_size"]
        dev = ctx.device
        store = ctx.make_traffic(p, c, C.generator(ctx.seed, "traffic", dev), dev)
        host = {k: store[k].cpu().numpy() for k in ("tokens", "image", "img_pos", "answers", "mc_ans")}
        self.lengths = store["lengths"].cpu().numpy()
        del store
        self.data = _Split(host)
        n = self.data.n
        self.units_per_dispatch = n
        self.steps_per_dispatch = -(-n // self.B)
        self.params, self.ref_params = C.make_weights(ctx.ref.param_spec(c), ctx.seed, dev)
        self.cfg = arch1.Arch1Config(
            vocab_size=c["vocab_size"], input_encoding_size=c["input_encoding_size"],
            rnn_size=c["rnn_size"], rnn_layer=c["rnn_layer"], nhimage=c["nhimage"],
            common_embedding_size=c["common_embedding_size"], num_output=c["num_output"],
            dropout=c["dropout"], fusion=c["fusion"])
        self.answers = []
        self.dispatched = 0
        self.dispatch()  # warm-up: one pass
        self.answers, self.dispatched = [], 0

    def dispatch(self):
        pred, mc_pred, _ = self.eval_loop.run_full_split(
            self.arch1, self.cfg, self.params, self.data, "val", self.B,
            device=self.ctx.device, hbm_resident=True, want="predict")
        self.answers.append((pred, mc_pred))
        self.dispatched += 1

    def work(self, first: int, count: int) -> dict:
        """Per pass: the FLOPs at every question's active tokens; the seq
        kernel's launches, one per layer and batch, at that batch's active
        (row, step) pairs (the final batch's padding rows are not needed)."""
        c, F = self.ctx.cfg, self.ctx.flops
        from vqabench.flops import kernels as K
        T, H = c["seq_length"], c["rnn_size"]
        per_batch = [float(self.lengths[s:s + self.B].sum())
                     for s in range(0, len(self.lengths), self.B)]
        launches = [(count, *K.lstm_seq(T, self.B, c["input_encoding_size"] if k == 0 else H, H,
                                        pairs))
                    for pairs in per_batch for k in range(c["rnn_layer"])]
        return {"model_flops": count * F.forward(c, float(self.lengths.sum()), len(self.lengths)),
                "kernels": {"lstm_seq": launches}}

    def free(self):
        self.params = None

    def check(self, mode: str) -> dict:
        ref, c, dev = self.ctx.ref, self.ctx.cfg, self.ctx.device
        st = self.data.store
        n = self.data.n
        if mode != "control":
            for pred, mc in self.answers:
                if pred.shape != (n,) or mc.shape != (n,):
                    raise ValueError(f"a pass answered {pred.shape}, {mc.shape} of {n} questions")
            pred_all = torch.from_numpy(np.stack([a[0] for a in self.answers]))
            mc_all = torch.from_numpy(np.stack([a[1] for a in self.answers]))
        oe_gap = mc_gap = 0.0
        for s in range(0, n, BLOCK):
            rows = slice(s, min(n, s + BLOCK))
            tokens = torch.from_numpy(st["tokens"][rows]).to(dev)
            image = torch.from_numpy(st["image"][st["img_pos"][rows].astype(np.int64) - 1]).to(dev)
            choices = torch.from_numpy(st["mc_ans"][rows]).to(dev).long()
            with torch.no_grad():
                scores = ref.scores(self.ref_params, c, tokens, image)
                if mode == "control":
                    with C.tf32():
                        low = ref.scores(self.ref_params, c, tokens, image)
                    preds = (low.argmax(1) + 1)[None]
                    mcs = choices.gather(1, low.gather(1, choices - 1).argmax(1)[:, None])[:, 0][None]
                else:
                    preds = pred_all[:, rows].to(dev)
                    mcs = mc_all[:, rows].to(dev)
            oe_gap = max(oe_gap, _gap(scores, preds, None))
            mc_gap = max(mc_gap, _gap(scores, mcs, choices))
        return {"oe_gap": oe_gap, "mc_gap": mc_gap}


def _gap(scores, answers, choices) -> float:
    """The widest gap, over passes and rows, between the best reference
    score (over all answers, or over ``choices``) and the reference's score
    of the answer given; infinite for an answer outside the range or not
    among the choices."""
    V = scores.shape[1]
    a = answers.long()
    if choices is None:
        best = scores.max(1).values
        valid = (a >= 1) & (a <= V)
    else:
        best = scores.gather(1, choices - 1).max(1).values
        valid = (a[..., None] == choices[None]).any(-1)
    got = scores[None].expand(a.shape[0], -1, -1).gather(2, (a.clamp(1, V) - 1)[..., None])[..., 0]
    gap = torch.where(valid, best[None] - got, torch.full_like(got, float("inf")))
    return float(gap.max())
