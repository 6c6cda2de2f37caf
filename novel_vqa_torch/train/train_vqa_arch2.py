"""Arch2 VQA trainer CLI, on the card by default: port of
``novel_vqa_tpu.train.train_vqa_arch2`` (003_train_vqa_arch2/
002_train_baseline.lua, flags :26-52, and the AE-based variants
003_train_ae_based{,_wp_vgg,_wp_inc}.lua).

Same flags and output files as the JAX trainer, plus ``--device``:
  * ``--init_from`` takes an AE ``.npz`` (``train_text_ae --variant
    arch2``, or a weak-paired AE) of either package: its encoder and lookup
    are cloned into the question encoder (003_train_ae_based.lua:150-152),
    its layer count must equal ``--num_layers``; the cnn projection stays
    fresh unless ``--cnn_proj_init`` gives an npz with ``cnn_proj/{w,b}``
    (003_train_ae_based_wp_vgg.lua:174-176);
  * ``--start_from`` warm-restarts from a flat ``lstm.h5``;
  * rmsprop with weight decay 1e-4, gradient clamp +-10, batch 500;
  * writes ``lstm.{h5,npz}``, ``save/lstm_save_iter<k>.{h5,npz}`` and the
    ``save/`` logs.

Questions stay LEFT-aligned (arch2 never right-aligns).  The train split
lives on the device: each iteration ships the sampled index vector
(``--steps_per_dispatch 1``) or nothing (``> 1``, on-device sampling, no
host sync).  Validation steps through the step kernel.  ``--data_parallel
1`` under ``torchrun`` trains each rank on its slice of every batch, the
encoder's can_skip all-reduced over the group so that it spans the global
batch as on one device; rank 0 writes every file.

    python -m novel_vqa_torch.train.train_vqa_arch2 --input_img_h5 data_img.h5 \\
        --input_ques_h5 data_prepro.h5 --input_json data_prepro.json \\
        --init_from ae/model_id.npz --checkpoint_path models_vqa/
    python -m novel_vqa_torch.train.train_vqa_arch2 ... --device cpu
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from novel_vqa_torch.core.checkpoint import (
    arch2_from_flat,
    arch2_to_flat,
    load_flat_h5,
    load_npz,
    save_flat_h5,
    save_npz,
)
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import arch2_params_from_numpy, arch2_params_to_numpy
from novel_vqa_torch.core.logging import EMA, MetricsLogger
from novel_vqa_torch.core.profiling import nan_guard, trace
from novel_vqa_torch.data.vqa import VQAData
from novel_vqa_torch.models.vqa import arch2
from novel_vqa_torch.parallel.dp import make_vqa_dp_indexed_step, make_vqa_dp_steps_scan
from novel_vqa_torch.parallel.mesh import cli_group


@dataclasses.dataclass
class TrainConfig:
    input_img_h5: str = "data_img.h5"
    input_ques_h5: str = "data_prepro.h5"
    input_json: str = "data_prepro.json"
    drop_prob_ae: float = 0.5
    learning_rate: float = 3e-4
    batch_size: int = 500
    max_iters: int = 150000
    input_encoding_size: int = 512
    rnn_size: int = 512
    num_layers: int = 1
    num_output: int = 1000
    img_norm: int = 1
    # per-part L2 dims for early-fusion features, e.g. "2048,4096"
    img_norm_split: str = ""
    nhimage: int = 4096
    save_checkpoint_every: int = 25000
    checkpoint_path: str = "models_vqa/"
    seed: int = 123
    profile_dir: str = ""  # torch.profiler chrome trace output dir ('' = off)
    debug_nans: int = 0  # 1 = torch.autograd.detect_anomaly
    weight_decay: float = 1e-4
    grad_clamp: float = 10.0
    init_from: str = ""  # AE .npz checkpoint (arch2 or null variant)
    cnn_proj_init: str = ""  # npz with cnn_proj/{w,b} (wp CNN Linear)
    start_from: str = ""  # flat h5 resume
    log_every: int = 100
    # >1 runs that many iterations per call with on-device batch sampling
    # (arch2.train_steps_scan)
    steps_per_dispatch: int = 1
    # 1 = data-parallel over the process group (torchrun: one process per
    # card; parallel/mesh.py): each rank trains on its slice of every
    # batch, the encoder's can_skip spanning the global batch
    data_parallel: int = 0
    device: str = "cuda"


def build_params(opt: TrainConfig, cfg: arch2.Arch2Config, device):
    """Fresh params from ``--seed``, or the ``--start_from`` flat h5; then
    the ``--init_from`` AE's encoder and lookup and the ``--cnn_proj_init``
    projection over them."""
    params = arch2.init_params(cfg, torch.Generator().manual_seed(opt.seed), device=device)
    if opt.start_from:
        return arch2_params_from_numpy(arch2_from_flat(load_flat_h5(opt.start_from), cfg), device)
    if opt.init_from:
        flat, _ = load_npz(opt.init_from)
        num_layers = len({k.split("/")[1] for k in flat if k.startswith("encoder/")})
        if num_layers != cfg.num_layers:
            raise ValueError(
                f"--init_from {opt.init_from}: the AE has {num_layers} encoder layers, "
                f"--num_layers is {cfg.num_layers}"
            )
        if flat["lookup"].shape != (cfg.vocab_size + 1, cfg.input_encoding_size):
            raise ValueError(
                f"--init_from {opt.init_from}: lookup {flat['lookup'].shape}, the question "
                f"vocabulary and --input_encoding_size need {(cfg.vocab_size + 1, cfg.input_encoding_size)}"
            )
        params["lookup"] = arch2_params_from_numpy(flat["lookup"], device)
        params["encoder"] = arch2_params_from_numpy(
            [{p: flat[f"encoder/{i}/{p}"] for p in ("wx", "bx", "wh", "bh")}
             for i in range(num_layers)],
            device,
        )
    if opt.cnn_proj_init:
        flat, _ = load_npz(opt.cnn_proj_init)
        params["cnn_proj"] = arch2_params_from_numpy(
            {"w": flat["cnn_proj/w"], "b": flat["cnn_proj/b"]}, device
        )
    return params


def main(argv=None):
    opt = parse_config(TrainConfig, argv, description=__doc__)
    group = cli_group(opt.data_parallel, opt.device, opt.batch_size)
    try:
        _train(opt, group)
    finally:
        group.close()


def _train(opt: TrainConfig, group):
    device = group.device
    writer = group.is_writer  # only rank 0 writes files
    # full fp32 in the products, as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    if writer:
        os.makedirs(os.path.join(opt.checkpoint_path, "save"), exist_ok=True)

    data = VQAData(
        opt.input_ques_h5,
        opt.input_img_h5,
        opt.input_json,
        img_norm=bool(opt.img_norm),
        seed=opt.seed,
        align="left",
        img_norm_split_dims=(
            [int(x) for x in opt.img_norm_split.split(",")] if opt.img_norm_split else None
        ),
    )
    cfg = arch2.Arch2Config(
        vocab_size=data.vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size,
        num_layers=opt.num_layers,
        nhimage=opt.nhimage,
        num_output=opt.num_output,
        seq_length=data.seq_length,
        dropout=opt.drop_prob_ae,
    )
    params = build_params(opt, cfg, device)
    tx = arch2.make_optimizer(
        learning_rate=opt.learning_rate,
        weight_decay=opt.weight_decay,
        grad_clamp=opt.grad_clamp,
    )
    opt_state = tx.init(params)
    # every rank starts from rank 0's state
    params = group.broadcast_tree(params)
    opt_state = group.broadcast_tree(opt_state)

    # ship the whole train split to the device once
    dev_data = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in data.split_store("train").items()
    }
    logger = MetricsLogger(os.path.join(opt.checkpoint_path, "save")) if writer else None
    ema, ema_val = EMA(0.95), EMA(0.95)
    n_train = data.num_examples("train")
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    pending = []

    def validate():
        total, n_batches = 0.0, 0
        for batch in data.iter_split("val", opt.batch_size):
            loss, _ = arch2.eval_step(
                cfg,
                params,
                torch.from_numpy(batch.tokens).to(device),
                torch.from_numpy(batch.image).to(device),
                torch.from_numpy(batch.labels).to(device),
            )
            f = float(loss)
            ema_val.update(f)
            total += f
            n_batches += 1
        return total / max(1, n_batches)

    def save_ckpt(tag: str):
        if not writer:
            return
        host = arch2_params_to_numpy(params)
        save_flat_h5(os.path.join(opt.checkpoint_path, tag + ".h5"), arch2_to_flat(host))
        save_npz(
            os.path.join(opt.checkpoint_path, tag + ".npz"),
            host,
            meta={"cfg": cfg._asdict(), "opt": dataclasses.asdict(opt)},
        )

    chunk = max(1, opt.steps_per_dispatch)
    step = make_vqa_dp_indexed_step(arch2.loss_fn, cfg, tx, group)
    it = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(trace(opt.profile_dir if writer else "", device))
        stack.enter_context(nan_guard(bool(opt.debug_nans)))
        while it < opt.max_iters:
            if (it + 1) % opt.save_checkpoint_every <= chunk - 1 or it == 0:
                loss_val = validate()
                if writer:
                    logger.log_val(it + 1, opt.max_iters, loss_val, ema_val.value)
                save_ckpt(os.path.join("save", f"lstm_save_iter{it + 1}"))
            if chunk == 1:
                qinds = torch.from_numpy(
                    data.rng.integers(0, n_train, opt.batch_size)
                ).to(device, non_blocking=True)
                params, opt_state, loss = step(params, opt_state, dev_data, qinds, generator)
                pending.append(loss[None])
                it += 1
            else:
                n_steps = min(chunk, opt.max_iters - it)
                scan = make_vqa_dp_steps_scan(arch2.loss_fn, cfg, tx, group, n_steps, opt.batch_size)
                params, opt_state, losses = scan(params, opt_state, dev_data, generator)
                pending.append(losses)
                it += n_steps
            # the losses stay on the device until log time
            if it % opt.log_every < chunk:
                for f in torch.cat(pending).tolist():
                    ema.update(f)
                pending.clear()
                if writer:
                    logger.log_train(it, opt.max_iters, ema.value)

    save_ckpt("lstm")
    if writer:
        logger.close()
        print("done; final checkpoint at", os.path.join(opt.checkpoint_path, "lstm.h5"))


if __name__ == "__main__":
    main()
