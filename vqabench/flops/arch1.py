"""arch1's model FLOPs: the matrix products the model needs at the active
tokens of its questions.  Elementwise work, the lookup and recompute are
not counted; a null (masked) step is not needed work.
"""

from __future__ import annotations

from vqabench.flops.kernels import gate_flops


def lstm_flops_per_token(cfg: dict) -> float:
    """Both LSTM layers' gate products for one active token."""
    E, H = cfg["input_encoding_size"], cfg["rnn_size"]
    return sum(gate_flops(1, E if k == 0 else H, H) for k in range(cfg["rnn_layer"]))


def head_flops_per_question(cfg: dict) -> dict:
    """The products after the encoder, per question: the question and
    image projections of AxB and the classifier."""
    C = cfg["common_embedding_size"]
    return {"question": 2.0 * 2 * cfg["rnn_size"] * cfg["rnn_layer"] * C,
            "image": 2.0 * cfg["nhimage"] * C,
            "classifier": 2.0 * C * cfg["num_output"]}


def forward(cfg: dict, active_tokens: float, questions: float) -> float:
    head = sum(head_flops_per_question(cfg).values())
    return lstm_flops_per_token(cfg) * active_tokens + head * questions


def train(cfg: dict, active_tokens: float, questions: float) -> float:
    """Forward, the weights' gradients and the inputs' gradients: three
    times the forward, less the image projection's input gradient, which
    nothing needs (the image features are data)."""
    return 3.0 * forward(cfg, active_tokens, questions) \
        - head_flops_per_question(cfg)["image"] * questions
