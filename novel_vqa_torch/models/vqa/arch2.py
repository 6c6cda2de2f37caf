"""Arch2: encoder-initialized (early fusion) VQA model, forward and
training step.

Port of ``novel_vqa_tpu.models.vqa.arch2`` after
003_train_vqa_arch2/002_train_baseline.lua:
  * ``cnn_projection`` = Linear(nhimage, input_encoding_size), no activation
    (:166);
  * question encoder = the arch2 AE's encoder (misc/Encoder_lstm.lua): the
    image projection at t=1, START at t=2, then the LEFT-aligned question
    tokens, nulls redirected to token 1 with the batch-wide can_skip
    (:170-226); the output is the top layer's final hidden state (:226);
  * classifier = Dropout(0.5) -> Linear(rnn_size, num_output) (:162-164);
  * cross-entropy over 1-indexed answers; rmsprop with weight decay 1e-4
    (:203-207) after a +-10 gradient clamp (:335).

The encoder is ``models/seq/autoencoder.encode`` with ``variant="arch2"``,
so every deterministic step runs the step kernel (18 launches per batch at
T=16, one layer); training steps run the plain cell with autograd.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.models.seq import autoencoder as ae
from novel_vqa_torch.models.vqa.eval_paths import build_eval_fns
from novel_vqa_torch.ops import optim
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.losses import cross_entropy
from novel_vqa_torch.ops.lstm import lstm_layer_init
from novel_vqa_torch.parallel.dp import make_vqa_dp_indexed_step, make_vqa_dp_steps_scan
from novel_vqa_torch.parallel.mesh import DPGroup


class Arch2Config(NamedTuple):
    vocab_size: int
    input_encoding_size: int = 512  # :38
    rnn_size: int = 512
    num_layers: int = 1
    nhimage: int = 4096
    num_output: int = 1000
    seq_length: int = 16
    dropout: float = 0.5  # -drop_prob_ae

    @property
    def ae_cfg(self) -> ae.AEConfig:
        return ae.AEConfig(
            vocab_size=self.vocab_size,
            input_encoding_size=self.input_encoding_size,
            rnn_size=self.rnn_size,
            num_layers=self.num_layers,
            seq_length=self.seq_length,
            dropout=self.dropout,
            variant="arch2",
        )


def init_params(
    cfg: Arch2Config, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Dict[str, Any]:
    """uniform(-0.08, 0.08) everywhere (:180-187), in the JAX package's
    layout; the draws differ from ``jax.random``'s.  The params land on
    ``device``."""
    device = resolve_device(device)

    def u(*shape):
        return (torch.rand(*shape, generator=generator) * 0.16 - 0.08).to(device)

    return {
        "cnn_proj": {"w": u(cfg.nhimage, cfg.input_encoding_size), "b": u(cfg.input_encoding_size)},
        "lookup": u(cfg.vocab_size + 1, cfg.input_encoding_size),
        "encoder": [
            lstm_layer_init(
                generator, cfg.input_encoding_size if i == 0 else cfg.rnn_size,
                cfg.rnn_size, device=device,
            )
            for i in range(cfg.num_layers)
        ],
        "classifier": {"w": u(cfg.rnn_size, cfg.num_output), "b": u(cfg.num_output)},
    }


def apply(
    params: Dict[str, Any],
    cfg: Arch2Config,
    tokens: torch.Tensor,  # (N, D) LEFT-aligned int tokens, 0 = pad suffix
    image: torch.Tensor,  # (N, nhimage) float32 (L2-normalized per img_norm)
    *,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> torch.Tensor:
    """Forward pass -> (N, num_output) answer scores.  On a DP group
    (``dp``) the encoder's batch-wide can_skip spans the global batch, and
    the dropout masks are the global batch's (``ops/dropout.py``)."""
    img_proj = torch.matmul(image, params["cnn_proj"]["w"]) + params["cnn_proj"]["b"]
    enc_params = {"lookup": params["lookup"], "encoder": params["encoder"]}
    _, h = ae.encode(enc_params, cfg.ae_cfg, tokens.transpose(0, 1), img_proj,
                     generator=generator, deterministic=deterministic, dp=dp)
    top_h = dropout(h[-1], cfg.dropout, generator, deterministic, dp=dp)
    return torch.matmul(top_h, params["classifier"]["w"]) + params["classifier"]["b"]


def loss_fn(params, cfg, tokens, image, labels, generator, dp=None) -> torch.Tensor:
    scores = apply(params, cfg, tokens, image, generator=generator, deterministic=False, dp=dp)
    return cross_entropy(scores, labels)


def make_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 1e-4,  # optimize.weightDecay
    grad_clamp: float = 10.0,
) -> optim.GradientTransformation:
    """clamp(+-10) -> the weight decay folded into the gradient -> rmsprop."""
    return optim.chain(
        optim.clamp(grad_clamp),
        optim.add_decayed_weights(weight_decay),
        optim.rmsprop(learning_rate),
    )


def train_step_indexed(cfg, tx, params, opt_state, data, qinds, generator):
    """One step on rows ``qinds`` of a device-resident store: returns
    (params, opt_state, loss), the loss a 0-d tensor left on the device
    (``parallel/dp.make_vqa_dp_indexed_step`` on one process)."""
    step = make_vqa_dp_indexed_step(loss_fn, cfg, tx, DPGroup(0, 1, qinds.device))
    return step(params, opt_state, data, qinds, generator)


def train_steps_scan(cfg, tx, params, opt_state, data, n_steps: int, batch_size: int,
                     generator):
    """``n_steps`` iterations with on-device batch sampling and no host
    sync (``parallel/dp.make_vqa_dp_steps_scan`` on one process)."""
    steps = make_vqa_dp_steps_scan(loss_fn, cfg, tx, DPGroup(0, 1, data["tokens"].device),
                                   n_steps, batch_size)
    return steps(params, opt_state, data, generator)


@torch.inference_mode()
def eval_step(cfg: Arch2Config, params, tokens, image, labels, dp=None):
    """(loss, scores) of one batch (the JAX package's jitted eval_step)."""
    scores = apply(params, cfg, tokens, image, deterministic=True, dp=dp)
    return cross_entropy(scores, labels), scores


(
    eval_step_indexed,
    eval_predict_indexed,
    eval_predict_scan,
    eval_scores_scan,
) = build_eval_fns(apply)
