"""The text autoencoder's model FLOPs: the matrix products it needs.

The encoder computes every row at every step that some row of the batch
needs (rows are not masked, so an ended row's steps change its state and
are part of the model); the teacher-forced decoder needs a row's steps up
to its END (length + 1 predictions); a greedy decode needs the steps of
its T emitted tokens.  The encoder of a validation batch counts once,
whether the program runs it for the NLL and the greedy pass apart or not.
Elementwise work, the lookups and recompute are not counted.
"""

from __future__ import annotations

from vqabench.flops.kernels import gate_flops


def encoder_flops_per_step(cfg: dict) -> float:
    E, H = cfg["input_encoding_size"], cfg["rnn_size"]
    return sum(gate_flops(1, E if k == 0 else H, H) for k in range(cfg["num_layers"]))


def decoder_flops_per_step(cfg: dict) -> float:
    """Gate products plus the (V+1)-wide output projection."""
    return encoder_flops_per_step(cfg) + 2.0 * cfg["rnn_size"] * (cfg["vocab_size"] + 1)


def nll_forward(cfg: dict, rows: int, encoder_steps: int, sum_lengths: float) -> float:
    """One batch's encoder (``encoder_steps`` steps some row needs, all
    ``rows``) and teacher-forced decoder (sum of length + 1)."""
    return (encoder_flops_per_step(cfg) * rows * encoder_steps
            + decoder_flops_per_step(cfg) * (sum_lengths + rows))


def train(cfg: dict, rows: int, encoder_steps: int, sum_lengths: float) -> float:
    """Forward, the weights' and the inputs' gradients: three forwards
    (every product's input is trained: the lookup feeds both LSTMs)."""
    return 3.0 * nll_forward(cfg, rows, encoder_steps, sum_lengths)


def validate(cfg: dict, rows: int, encoder_steps: int, sum_lengths: float) -> float:
    """The trainer's validation of one batch: the NLL and a greedy decode
    of T tokens from the same encoder state."""
    return (nll_forward(cfg, rows, encoder_steps, sum_lengths)
            + decoder_flops_per_step(cfg) * rows * cfg["seq_length"])
