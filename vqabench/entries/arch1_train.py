"""arch1 training through ``arch1.train_steps_scan``: batches sampled on
the device from a resident VQA train store, ``steps_per_dispatch`` steps
per call, nothing waited for.

Set-up makes the store and the weights from the seed, builds the
optimizer and its state, and drives that one state through the window's
own entry and feed: ``common.CHECK_STEPS`` calls of one step each (the
entry and its generator as the window calls them, one step per call so
that the optimizer's state after the first step can be read), whose sampled rows
and dropout masks are recorded as drawn.  The reference follows those
steps from its own copy of the weights, with those rows and masks.
"""

from __future__ import annotations

import torch

from vqabench import common as C


class Cell:
    traced_dispatches = 2

    def __init__(self, ctx):
        from novel_vqa_torch.models.vqa import arch1

        c, p = ctx.cfg, ctx.traffic
        self.ctx, self.arch1 = ctx, arch1
        self.B, self.S = p["batch_size"], p["steps_per_dispatch"]
        self.units_per_dispatch = self.B * self.S
        self.steps_per_dispatch = self.S
        dev = ctx.device
        store = ctx.make_traffic(p, c, C.generator(ctx.seed, "traffic", dev), dev)
        self.mean_len = float(store["lengths"].double().mean())
        self.data = {k: store[k] for k in ("tokens", "image", "img_pos", "answers")}
        params, self.ref_params = C.make_weights(ctx.ref.param_spec(c), ctx.seed, dev)
        self.cfg = arch1.Arch1Config(
            vocab_size=c["vocab_size"], input_encoding_size=c["input_encoding_size"],
            rnn_size=c["rnn_size"], rnn_layer=c["rnn_layer"], nhimage=c["nhimage"],
            common_embedding_size=c["common_embedding_size"], num_output=c["num_output"],
            dropout=c["dropout"], fusion=c["fusion"])
        o = c["optimizer"]
        self.tx = arch1.make_optimizer(learning_rate=o["learning_rate"],
                                       decay_factor=o["decay_factor"], grad_clamp=o["grad_clamp"],
                                       alpha=o["alpha"], epsilon=o["epsilon"])
        opt_state = self.tx.init(params)
        self.gen = C.generator(ctx.seed, "program", dev)

        keep = 1.0 - c["dropout"]
        self.prog = {"losses": []}
        self.batches = []
        for k in range(C.CHECK_STEPS):
            rec = C.DrawRecorder()
            with rec:
                params, opt_state, losses = arch1.train_steps_scan(
                    self.cfg, self.tx, params, opt_state, self.data, 1, self.B, self.gen)
            self.prog["losses"].append(float(losses[-1]))
            rows = [d for d in rec.ints if tuple(d.shape) == (self.B,)]
            if len(rows) != 1:
                raise RuntimeError(f"step {k}: {len(rows)} draws of {self.B} rows, expected 1")
            q = rows[0].long()
            self.batches.append((
                self.data["tokens"][q].cpu(),
                self.data["image"][self.data["img_pos"][q].long() - 1].cpu(),
                self.data["answers"][q].cpu(),
                [(u < keep).cpu() for u in rec.uniforms],
            ))
            if k == 0:
                alpha, moment = o["alpha"], C.optimizer_moment(opt_state)
                self.prog["grad1"] = {C.path_name(path): float(torch.sqrt(m.double().sum() / (1 - alpha)))
                                      for path, m in C.leaves(moment)}
        self.prog_params = C.to_host(params)
        self.params, self.opt_state = params, opt_state
        self.dispatched = 0
        for _ in range(2):  # warm-up: the window's call at its own size
            self.dispatch()
        self.dispatched = 0

    def dispatch(self):
        self.params, self.opt_state, _ = self.arch1.train_steps_scan(
            self.cfg, self.tx, self.params, self.opt_state, self.data, self.S, self.B, self.gen)
        self.dispatched += 1

    def work(self, first: int, count: int) -> dict:
        """Uniform sampling from the store draws the store's mean length per
        question in expectation: the FLOPs at that many active tokens."""
        c, F = self.ctx.cfg, self.ctx.flops
        questions = count * self.units_per_dispatch
        tokens = questions * self.mean_len
        T, H = c["seq_length"], c["rnn_size"]
        from vqabench.flops import kernels as K
        pairs = self.B * self.mean_len
        per_step = [K.lstm_seq(T, self.B, c["input_encoding_size"] if k == 0 else H, H, pairs)
                    for k in range(c["rnn_layer"])]
        steps = count * self.S
        return {"model_flops": F.train(c, tokens, questions),
                "kernels": {"lstm_seq": [(steps, f, b) for f, b in per_step]}}

    def free(self):
        for name in ("params", "opt_state", "data", "tx"):
            setattr(self, name, None)

    def check(self, mode: str) -> dict:
        ref, c, dev = self.ctx.ref, self.ctx.cfg, self.ctx.device
        slots = ref.draw_slots(c, self.B)
        batches = [(t.to(dev), i.to(dev), a.to(dev),
                    {k: v.to(dev) for k, v in C.fill_slots(slots, masks).items()})
                   for t, i, a, masks in self.batches]
        base = {C.path_name(pp): t for pp, t in C.leaves(self.ref_params)}
        want = C.training_readings(ref.train(self.ref_params, c, batches), base)
        if mode == "control":
            with C.tf32():
                got = C.training_readings(ref.train(self.ref_params, c, batches), base)
        else:
            got = C.program_readings(self.prog, self.prog_params, base)
        return C.training_numbers(got, want)
