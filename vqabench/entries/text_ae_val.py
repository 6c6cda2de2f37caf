"""Text-autoencoder validation, the trainer's ``eval_split`` work: per
batch ``train_text_ae.val_nll`` then ``train_text_ae.greedy_tokens``, in
repeated passes over a held-out store resident on the device.  One call
is one batch; nothing waits for the card, and each pass's NLLs and tokens
are copied to the host as it ends, without waiting.

Judged after the window: every batch's NLL of every pass against the
reference's, and the greedy tokens of ``SAMPLED`` batches drawn from the
seed (the batch with the longest sentences among them) by logits: the
reference's decoder fed the tokens chosen, and the gap between its best
logit and the chosen token's at every position.
"""

from __future__ import annotations

import numpy as np
import torch

from vqabench import common as C

SAMPLED = 4


class Cell:
    traced_dispatches = None  # a pass, set below
    steps_per_dispatch = 1

    def __init__(self, ctx):
        from novel_vqa_torch.models.seq import autoencoder as ae
        from novel_vqa_torch.train import train_text_ae as tta

        c, p = ctx.cfg, ctx.traffic
        self.ctx, self.tta = ctx, tta
        self.B = p["batch_size"]
        self.units_per_dispatch = self.B
        dev = ctx.device
        store = ctx.make_traffic(p, c, C.generator(ctx.seed, "traffic", dev), dev)
        nb = p["rows"] // self.B
        self.nb = self.traced_dispatches = nb
        T = c["seq_length"]
        self.store = store["rows"][: nb * self.B].view(nb, self.B, T).transpose(1, 2).contiguous()
        lengths = store["lengths"][: nb * self.B].cpu().numpy().reshape(nb, self.B)
        self.lengths = lengths
        self.host_store = self.store.cpu()
        self.params, self.ref_params = C.make_weights(ctx.ref.param_spec(c), ctx.seed, dev)
        self.cfg = ae.AEConfig(vocab_size=c["vocab_size"], input_encoding_size=c["input_encoding_size"],
                               rnn_size=c["rnn_size"], num_layers=c["num_layers"],
                               seq_length=c["seq_length"], dropout=c["dropout"], variant=c["variant"])
        self._reset()
        for _ in range(nb):  # warm-up: one pass
            self.dispatch()
        self._reset()

    def _reset(self):
        self.dispatched = 0
        self.pass_out = []  # this pass's (nll, tokens) on the device
        self.passes = []  # [(host nll (nb,), host tokens (nb, T, B), copy event)]

    def dispatch(self):
        seq = self.store[self.dispatched % self.nb]
        nll = self.tta.val_nll(self.cfg, self.params, seq)
        tokens = self.tta.greedy_tokens(self.cfg, self.params, seq)
        self.pass_out.append((nll, tokens))
        self.dispatched += 1
        if len(self.pass_out) == self.nb:
            self._fetch()

    def _fetch(self):
        nll = torch.stack([x[0] for x in self.pass_out])
        tokens = torch.stack([x[1] for x in self.pass_out])
        self.pass_out = []
        if nll.device.type != "cuda":
            self.passes.append((nll.clone(), tokens.clone(), None))
            return
        h_nll = torch.empty(nll.shape, dtype=nll.dtype, pin_memory=True)
        h_tok = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
        h_nll.copy_(nll, non_blocking=True)
        h_tok.copy_(tokens, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.passes.append((h_nll, h_tok, event))

    def work(self, first: int, count: int) -> dict:
        """Per batch: the NLL and a greedy decode from one encoder state
        (``flops/text_ae.validate``); the step kernel's needed launches:
        the encoder's steps some row needs (all rows), the teacher-forced
        decoder's steps at the rows not yet past END, the greedy decode's
        T steps (all rows)."""
        c, F = self.ctx.cfg, self.ctx.flops
        from vqabench.flops import kernels as K
        E, H, T = c["input_encoding_size"], c["rnn_size"], c["seq_length"]
        flops, launches = 0.0, []
        for i in (first + np.arange(count)) % self.nb:
            ln = self.lengths[i]
            steps = int(ln.max())
            flops += F.validate(c, self.B, steps, float(ln.sum()))
            _, b = K.lstm_step(self.B, E, H)
            launches.append((steps + T, K.gate_flops(self.B, E, H), b))
            for t in range(T + 1):
                launches.append((1, K.gate_flops(int((ln >= t).sum()), E, H), b))
        return {"model_flops": flops, "kernels": {"lstm_step": launches}}

    def free(self):
        if self.pass_out:
            self._fetch()
        for _, _, event in self.passes:
            if event is not None:
                event.synchronize()
        self.params = self.store = None

    def _sample(self):
        """``SAMPLED`` of the batches the window answered, drawn from the
        seed, the one with the longest sentences among them."""
        answered = range(max(h_nll.shape[0] for h_nll, _, _ in self.passes))
        longest = max(answered, key=lambda i: self.lengths[i].sum())
        rng = np.random.default_rng(C.sub_seed(self.ctx.seed, "sample"))
        others = [int(i) for i in rng.permutation(len(answered)) if i != longest]
        return sorted([longest] + others[: SAMPLED - 1])

    def check(self, mode: str) -> dict:
        ref, c, dev = self.ctx.ref, self.ctx.cfg, self.ctx.device
        self.sampled = self._sample()
        ref_nll = {}
        nll_gap = greedy_gap = 0.0
        with torch.no_grad():
            if mode == "control":
                with C.tf32():
                    got_nll = {i: ref.batch_nll(self.ref_params, c, self.host_store[i].to(dev))
                               for i in self.sampled}
                nll_by_pass = [got_nll]
            else:
                nll_by_pass = []
                for h_nll, h_tok, _ in self.passes:
                    n_batches = h_nll.shape[0]
                    nll_by_pass.append({i: float(h_nll[i]) for i in range(n_batches)})
            for got in nll_by_pass:
                for i, value in got.items():
                    if i not in ref_nll:
                        ref_nll[i] = ref.batch_nll(self.ref_params, c, self.host_store[i].to(dev))
                    nll_gap = max(nll_gap, C.rel_gap(value, ref_nll[i]))
            for i in self.sampled:
                seq = self.host_store[i].to(dev)
                if mode == "control":
                    greedy_gap = max(greedy_gap, _control_gap(ref, self.ref_params, c, seq,
                                                              self._program_tokens(i)))
                    continue
                seen = []
                for _, h_tok, _ in self.passes:
                    if i >= h_tok.shape[0]:
                        continue
                    tok = h_tok[i]
                    if any(torch.equal(tok, s) for s in seen):
                        continue
                    seen.append(tok)
                    gaps = ref.greedy_gaps(self.ref_params, c, seq, tok.to(dev))
                    greedy_gap = max(greedy_gap, float(gaps.max()))
        return {"nll": nll_gap, "greedy_gap": greedy_gap}

    def _program_tokens(self, i):
        for _, h_tok, _ in self.passes:
            if i < h_tok.shape[0]:
                return h_tok[i]
        raise ValueError(f"batch {i} was never answered")


def _control_gap(ref, params, c, seq, tokens) -> float:
    """At each position of the program's greedy tokens: the f32 reference's
    gap of the token that the TF32 reference puts first."""
    dev = seq.device
    tokens = tokens.to(dev)
    state = ref.encode(params, c, seq)
    logits = ref.decoder_logits(params, c, state, tokens[:-1])
    with C.tf32():
        low = ref.decoder_logits(params, c, ref.encode(params, c, seq), tokens[:-1])
    first = low.argmax(-1, keepdim=True)
    return float((logits.max(-1).values - logits.gather(2, first)[..., 0]).max())
