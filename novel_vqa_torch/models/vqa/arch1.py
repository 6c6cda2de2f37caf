"""Arch1: late-fusion LSTM VQA baseline, deterministic forward.

Port of ``novel_vqa_tpu.models.vqa.arch1`` after
002_train_vqa_arch1/002_train_baseline.lua:
  * word embedding = row gather + bias -> tanh (:141-144; the dropout
    between them is off in eval);
  * question encoder = ``rnn_layer``-layer LSTM over right-aligned tokens,
    masked (:147, misc/LSTM.lua);
  * question vector = the packed final state [c1, h1, ..., cL, hL] (:152);
  * head = AxB (or AskipB for the wp variant) -> Linear(common,
    num_output) (:151-154).

Only ``deterministic=True`` is ported; training mode comes with the
training slice.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.models.vqa.eval_paths import build_eval_fns
from novel_vqa_torch.ops.embedding import embedding_lookup
from novel_vqa_torch.ops.fusion import askipb_apply, axb_apply
from novel_vqa_torch.ops.losses import cross_entropy
from novel_vqa_torch.ops.lstm import lstm_encode, lstm_layer_init, pack_state


class Arch1Config(NamedTuple):
    vocab_size: int
    input_encoding_size: int = 200  # -input_encoding_size (:34)
    rnn_size: int = 512  # -rnn_size (:35)
    rnn_layer: int = 2  # -rnn_layer (:36)
    nhimage: int = 4096  # -nhimage (:33)
    common_embedding_size: int = 1024  # -common_embedding_size (:37)
    num_output: int = 1000  # -num_output (:38)
    fusion: str = "axb"  # "axb" | "askipb" (wp variant)


def init_params(
    cfg: Arch1Config, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Dict[str, Any]:
    """uniform(-0.08, 0.08) everywhere (:174-181), in the JAX package's
    layout; the draws differ from ``jax.random``'s.  The params land on
    ``device``, ``cuda`` unless the caller asks for ``cpu``."""
    device = resolve_device(device)

    def u(*shape):
        t = torch.rand(*shape, generator=generator, dtype=torch.float32)
        return (t * 0.16 - 0.08).to(device)

    C = cfg.common_embedding_size
    return {
        "embedding": {
            "w": u(cfg.vocab_size, cfg.input_encoding_size),
            "b": u(cfg.input_encoding_size),
        },
        "encoder": [
            lstm_layer_init(
                generator,
                cfg.input_encoding_size if i == 0 else cfg.rnn_size,
                cfg.rnn_size,
                device=device,
            )
            for i in range(cfg.rnn_layer)
        ],
        "fusion": {
            "wq": u(2 * cfg.rnn_size * cfg.rnn_layer, C),
            "bq": u(C),
            "wi": u(cfg.nhimage, C),
            "bi": u(C),
        },
        "classifier": {"w": u(C, cfg.num_output), "b": u(cfg.num_output)},
    }


def apply(
    params: Dict[str, Any],
    cfg: Arch1Config,
    tokens: torch.Tensor,  # (N, D) right-aligned int tokens, 0 = pad
    image: torch.Tensor,  # (N, nhimage) float32 (already L2-normalized)
    *,
    deterministic: bool = True,
) -> torch.Tensor:
    """Forward pass -> (N, num_output) answer scores."""
    if not deterministic:
        raise NotImplementedError(
            "arch1.apply(deterministic=False): training mode (dropout, the "
            "backward) is ported with the training slice"
        )
    if cfg.fusion == "axb":
        fuse = axb_apply
    elif cfg.fusion == "askipb":
        fuse = askipb_apply
    else:
        raise ValueError(f"cfg.fusion={cfg.fusion!r}: must be 'axb' or 'askipb'")

    emb = torch.tanh(
        embedding_lookup(params["embedding"]["w"], tokens, params["embedding"]["b"])
    )
    xs = emb.transpose(0, 1)  # (D, N, E) time-major
    mask = (tokens != 0).to(xs.dtype).transpose(0, 1)  # (D, N)
    c, h = lstm_encode(params["encoder"], xs, mask)
    tv_q = pack_state(c, h)  # (N, 2*rnn*layers)
    fused = fuse(params["fusion"], tv_q, image)
    return torch.matmul(fused, params["classifier"]["w"]) + params["classifier"]["b"]


@torch.inference_mode()
def eval_step(cfg: Arch1Config, params, tokens, image, labels):
    """(loss, scores) of one batch (the JAX package's jitted eval_step)."""
    scores = apply(params, cfg, tokens, image, deterministic=True)
    return cross_entropy(scores, labels), scores


(
    eval_step_indexed,
    eval_predict_indexed,
    eval_predict_scan,
    eval_scores_scan,
) = build_eval_fns(apply)
