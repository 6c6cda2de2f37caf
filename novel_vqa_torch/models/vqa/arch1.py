"""Arch1: late-fusion LSTM VQA baseline, forward and training step.

Port of ``novel_vqa_tpu.models.vqa.arch1`` after
002_train_vqa_arch1/002_train_baseline.lua:
  * word embedding = row gather + bias -> Dropout(0.5) -> tanh (:141-144);
  * question encoder = ``rnn_layer``-layer LSTM over right-aligned tokens,
    masked, with inter-layer dropout 0.5 (:147, misc/LSTM.lua);
  * question vector = the packed final state [c1, h1, ..., cL, hL] (:152);
  * head = AxB (or AskipB for the wp variant) -> Dropout(0.5) ->
    Linear(common, num_output) (:151-154);
  * loss = CrossEntropy over 1-indexed answers (:157); one step = forward,
    backward, [grad scale] -> clamp(+-10) -> rmsprop with per-iteration lr
    decay (:272-335, :408-410).

The dropout masks of training mode come from a ``torch.Generator`` on the
batch's device (``generator=``) where the JAX package splits an rng key.

``compute_dtype="bfloat16"`` is the JAX package's mixed precision: inside
:func:`apply` the params' f32 leaves and the image are cast to bf16 (the
f32 masters and the optimizer's states stay f32, the cast's backward
carries the gradients to f32), the LSTM runs the plain bf16 cell
(``ops/lstm.py``; no kernel), the products give f32
(``ops/precision.dot_f32``), and the fusion's output, the scores and the
loss are f32.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.models.vqa.eval_paths import build_eval_fns
from novel_vqa_torch.ops import optim
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.embedding import embedding_lookup
from novel_vqa_torch.ops.fusion import askipb_apply, axb_apply
from novel_vqa_torch.ops.losses import cross_entropy
from novel_vqa_torch.ops.lstm import lstm_encode, lstm_layer_init, pack_state
from novel_vqa_torch.ops.precision import cast_compute, compute_dtype, dot_f32
from novel_vqa_torch.parallel.dp import make_vqa_dp_indexed_step, make_vqa_dp_steps_scan
from novel_vqa_torch.parallel.mesh import DPGroup, make_dp_train_step


class Arch1Config(NamedTuple):
    vocab_size: int
    input_encoding_size: int = 200  # -input_encoding_size (:34)
    rnn_size: int = 512  # -rnn_size (:35)
    rnn_layer: int = 2  # -rnn_layer (:36)
    nhimage: int = 4096  # -nhimage (:33)
    common_embedding_size: int = 1024  # -common_embedding_size (:37)
    num_output: int = 1000  # -num_output (:38)
    dropout: float = 0.5
    fusion: str = "axb"  # "axb" | "askipb" (wp variant)
    remat: bool = False  # recompute each LSTM training step in the backward
    # "bfloat16" = mixed precision: bf16 weights and activations in the
    # forward, f32 products' results, f32 masters, optimizer states and
    # loss.  float32 as the reference
    compute_dtype: str = "float32"


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
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> torch.Tensor:
    """Forward pass -> (N, num_output) answer scores.  Training mode
    (``deterministic=False``) draws its dropout masks from ``generator``;
    on a DP group (``dp``, a ``parallel.mesh.DPGroup``) at the global
    batch's shape, this rank's rows taken (``ops/dropout.py``)."""
    cdt = compute_dtype(cfg.compute_dtype)
    params = cast_compute(params, cdt)
    image = image.to(cdt)
    if cfg.fusion == "axb":
        fuse = axb_apply
    elif cfg.fusion == "askipb":
        fuse = askipb_apply
    else:
        raise ValueError(f"cfg.fusion={cfg.fusion!r}: must be 'axb' or 'askipb'")

    # embedding: tanh(dropout(W[t] + b)), the Linear->Dropout->Tanh order
    emb = embedding_lookup(params["embedding"]["w"], tokens, params["embedding"]["b"])
    emb = torch.tanh(dropout(emb, cfg.dropout, generator, deterministic, dp=dp))
    xs = emb.transpose(0, 1)  # (D, N, E) time-major
    mask = (tokens != 0).to(xs.dtype).transpose(0, 1)  # (D, N)
    c, h = lstm_encode(
        params["encoder"], xs, mask, dropout_rate=cfg.dropout,
        generator=generator, deterministic=deterministic, remat=cfg.remat, dp=dp,
    )
    tv_q = pack_state(c, h)  # (N, 2*rnn*layers)
    fused = fuse(
        params["fusion"], tv_q, image, dropout_rate=cfg.dropout,
        generator=generator, deterministic=deterministic, dp=dp,
    )
    fused = dropout(fused, cfg.dropout, generator, deterministic, dp=dp)
    # f32 ``fused`` against a bf16 ``w`` is an f32 product, as JAX promotes
    return dot_f32(fused, params["classifier"]["w"]) + params["classifier"]["b"]


def loss_fn(params, cfg, tokens, image, labels, generator, dp=None) -> torch.Tensor:
    scores = apply(params, cfg, tokens, image, generator=generator, deterministic=False, dp=dp)
    return cross_entropy(scores, labels)


def make_optimizer(
    learning_rate: float = 3e-4,
    decay_factor: float = 0.99997592083,  # :78
    grad_clamp: float = 10.0,  # :329
    alpha: float = 0.99,
    epsilon: float = 1e-8,
    grad_scales=None,
) -> optim.GradientTransformation:
    """[optional grad scaling] -> clamp(+-10) -> reference rmsprop with
    per-step multiplicative decay (:408-410).  ``grad_scales`` is a tree of
    factors matching the params (the wp variant's ``-lr_scale`` on the
    encoder/embedding blocks, 003_train_ae_based_wp.lua:344), applied
    before the clamp as in the reference."""
    chain = []
    if grad_scales is not None:
        chain.append(optim.scale_by_tree(grad_scales))
    chain += [
        optim.clamp(grad_clamp),
        optim.rmsprop(
            optim.exponential_decay_schedule(learning_rate, decay_factor),
            alpha=alpha,
            epsilon=epsilon,
        ),
    ]
    return optim.chain(*chain)


def train_step(cfg, tx, params, opt_state, tokens, image, labels, generator):
    """One forward/backward/update step (replaces JdJ + optim.rmsprop,
    002_train_baseline.lua:272-335,408): returns (params, opt_state, loss),
    the loss a 0-d tensor left on the device.  The DP step on the group of
    one process (``parallel/mesh.make_dp_train_step``)."""
    step = make_dp_train_step(cfg, tx, DPGroup(0, 1, tokens.device), loss_fn)
    return step(params, opt_state, generator, tokens, image, labels)


def train_step_indexed(cfg, tx, params, opt_state, data, qinds, generator):
    """:func:`train_step` on rows ``qinds`` of a device-resident store
    (tokens (N, D), image (M, F), img_pos (N,), answers (N,)): only the
    (B,) index vector crosses from the host
    (``parallel/dp.make_vqa_dp_indexed_step`` on one process)."""
    step = make_vqa_dp_indexed_step(loss_fn, cfg, tx, DPGroup(0, 1, qinds.device))
    return step(params, opt_state, data, qinds, generator)


def train_steps_scan(cfg, tx, params, opt_state, data, n_steps: int, batch_size: int,
                     generator):
    """``n_steps`` iterations with on-device batch sampling and no host
    sync (``parallel/dp.make_vqa_dp_steps_scan`` on one process): returns
    (params, opt_state, losses (n_steps,))."""
    steps = make_vqa_dp_steps_scan(loss_fn, cfg, tx, DPGroup(0, 1, data["tokens"].device),
                                   n_steps, batch_size)
    return steps(params, opt_state, data, generator)


@torch.inference_mode()
def eval_step(cfg: Arch1Config, params, tokens, image, labels, dp=None):
    """(loss, scores) of one batch (the JAX package's jitted eval_step)."""
    scores = apply(params, cfg, tokens, image, deterministic=True)
    return cross_entropy(scores, labels), scores


(
    eval_step_indexed,
    eval_predict_indexed,
    eval_predict_scan,
    eval_scores_scan,
) = build_eval_fns(apply)
