"""Text-autoencoder training through ``train_text_ae.train_steps_scan``:
the corpus resident on the device, read in the loader's sequential
windows, ``steps_per_dispatch`` steps per call, nothing waited for.

Set-up drives the one training state through ``common.CHECK_STEPS``
one-step calls of the window's entry with its generator, recording the dropout
masks as drawn; the reference follows those steps on the same windows
(rows k*B .. (k+1)*B - 1 of step k) from its own copy of the weights.
"""

from __future__ import annotations

import numpy as np
import torch

from vqabench import common as C


class Cell:
    traced_dispatches = 2

    def __init__(self, ctx):
        from novel_vqa_torch.models.seq import autoencoder as ae
        from novel_vqa_torch.train import train_text_ae as tta

        c, p = ctx.cfg, ctx.traffic
        if p["rows"] != c["corpus_sentences"]:
            raise ValueError("the train store's rows differ from the configuration's corpus")
        self.ctx, self.tta = ctx, tta
        self.B, self.S = p["batch_size"], p["steps_per_dispatch"]
        self.units_per_dispatch = self.B * self.S
        self.steps_per_dispatch = self.S
        dev = ctx.device
        store = ctx.make_traffic(p, c, C.generator(ctx.seed, "traffic", dev), dev)
        self.rows = store["rows"]
        lengths = store["lengths"].cpu().numpy().reshape(-1, self.B)
        self.batch_max, self.batch_sum = lengths.max(axis=1), lengths.sum(axis=1)
        params, self.ref_params = C.make_weights(ctx.ref.param_spec(c), ctx.seed, dev)
        self.cfg = ae.AEConfig(vocab_size=c["vocab_size"], input_encoding_size=c["input_encoding_size"],
                               rnn_size=c["rnn_size"], num_layers=c["num_layers"],
                               seq_length=c["seq_length"], dropout=c["dropout"], variant=c["variant"])
        o = c["optimizer"]
        self.tx = tta.make_tx(tta.AETrainConfig(
            optim="adam", learning_rate=o["learning_rate"], optim_alpha=o["beta1"],
            optim_beta=o["beta2"], optim_epsilon=o["epsilon"], grad_clip=o["grad_clip"],
            weight_decay=o["weight_decay"], learning_rate_decay_start=-1))
        opt_state = self.tx.init(params)
        self.gen = C.generator(ctx.seed, "program", dev)
        self.offset = torch.zeros((), dtype=torch.int64, device=dev)

        keep = 1.0 - c["dropout"]
        self.prog = {"losses": []}
        self.batches = []
        for k in range(C.CHECK_STEPS):
            rec = C.DrawRecorder()
            with rec:
                params, opt_state, self.offset, losses = tta.train_steps_scan(
                    self.cfg, self.tx, params, opt_state, self.rows, self.offset, 1, self.B,
                    self.gen)
            self.prog["losses"].append(float(losses[-1]))
            self.batches.append((self.rows[k * self.B:(k + 1) * self.B].t().cpu(),
                                 [(u < keep).cpu() for u in rec.uniforms]))
            if k == 0:
                b1 = o["beta1"]
                moment = C.optimizer_moment(opt_state)
                self.prog["grad1"] = {C.path_name(path): float(torch.linalg.vector_norm(m.double()))
                                      / (1 - b1) for path, m in C.leaves(moment)}
        self.prog_params = C.to_host(params)
        self.params, self.opt_state = params, opt_state
        self.dispatched = 0
        for _ in range(2):  # warm-up: the window's call at its own size
            self.dispatch()
        self.first_step = C.CHECK_STEPS + 2 * self.S
        self.dispatched = 0

    def dispatch(self):
        self.params, self.opt_state, self.offset, _ = self.tta.train_steps_scan(
            self.cfg, self.tx, self.params, self.opt_state, self.rows, self.offset, self.S,
            self.B, self.gen)
        self.dispatched += 1

    def work(self, first: int, count: int) -> dict:
        """The loader's windows are sequential: step s reads batch s of the
        store (the window never wraps a 1M-row corpus), so the FLOPs are
        those of exactly the batches the dispatches read."""
        nb = len(self.batch_max)
        idx = (self.first_step + first * self.S + np.arange(count * self.S)) % nb
        c = self.ctx.cfg
        flops = sum(self.ctx.flops.train(c, self.B, int(self.batch_max[i]), float(self.batch_sum[i]))
                    for i in idx)
        return {"model_flops": flops, "kernels": {}}

    def free(self):
        for name in ("params", "opt_state", "rows", "tx", "offset"):
            setattr(self, name, None)

    def check(self, mode: str) -> dict:
        ref, c, dev = self.ctx.ref, self.ctx.cfg, self.ctx.device
        slots = ref.draw_slots(c, self.B)
        batches = [(seq.to(dev), {k: v.to(dev) for k, v in C.fill_slots(slots, masks).items()})
                   for seq, masks in self.batches]
        base = {C.path_name(pp): t for pp, t in C.leaves(self.ref_params)}
        want = C.training_readings(ref.train(self.ref_params, c, batches), base)
        if mode == "control":
            with C.tf32():
                got = C.training_readings(ref.train(self.ref_params, c, batches), base)
        else:
            got = C.program_readings(self.prog, self.prog_params, base)
        return C.training_numbers(got, want)
