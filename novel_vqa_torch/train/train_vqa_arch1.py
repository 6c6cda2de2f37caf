"""Arch1 VQA trainer CLI, on the card by default: port of
``novel_vqa_tpu.train.train_vqa_arch1`` (002_train_vqa_arch1/
002_train_baseline.lua, flags :16-50, and its AE-initialized variants
003_train_ae_based*.lua).

Same flags and output files as the JAX trainer, plus ``--device``:
  * ``--init_from`` loads a converted-AE transfer h5 ({lookup^T, encoder,
    [multimodal]}): embedding weight <- lookup minus its last (START) row
    with zero bias, encoder <- flat vector (003_train_ae_based.lua:175-188);
    with a ``multimodal`` entry and ``--fusion askipb`` the fusion
    projections are AE-initialized too (003_train_ae_based_wp.lua:151-160);
  * ``--start_from`` warm-restarts from a flat h5 (params only);
    ``--resume`` restores params, optimizer state and iteration from a
    ``train_state.npz`` written by either package;
  * writes ``lstm.{h5,npz}``, ``save/lstm_save_iter<k>.{h5,npz}``,
    ``save/logFile.txt``, ``save/logFileVal.txt``,
    ``save/train_metrics.jsonl`` and, under ``--save_train_state 1``,
    ``train_state.npz``.

The whole train split lives on the device and each iteration ships only the
sampled index vector (``--steps_per_dispatch 1``, host sampling from the
data's seeded generator) or nothing at all (``> 1``: on-device sampling,
``arch1.train_steps_scan``).  Losses stay on the device until log time.
``NOVEL_VQA_FUSED2=1`` routes the 2-layer encode through the seq2 kernel
(``ops/lstm.py``).  ``--compute_dtype bfloat16`` trains in the JAX
package's mixed precision (``models/vqa/arch1.py``): its training and
validation run the plain bf16 cell and launch no kernel, and the
checkpoints hold the f32 masters, which either package's eval CLI reads
(its f32 eval runs the seq kernel).  ``--data_parallel 1`` under ``torchrun`` trains each
rank on its slice of every batch (both dispatch modes; NCCL on the cards,
gloo with ``--device cpu``), the gradient mean all-reduced before the
update; rank 0 writes every file.  ``--profile_dir`` writes a ``torch.profiler`` chrome
trace (``trace.json``); ``--debug_nans 1`` runs under
``torch.autograd.detect_anomaly``.

    python -m novel_vqa_torch.train.train_vqa_arch1 \\
        --input_img_h5 data_img.h5 --input_ques_h5 data_prepro.h5 \\
        --input_json data_prepro.json --checkpoint_path model/
    python -m novel_vqa_torch.train.train_vqa_arch1 ... --device cpu
    torchrun --standalone --nproc_per_node=<cards> -m \\
        novel_vqa_torch.train.train_vqa_arch1 ... --data_parallel 1
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from novel_vqa_torch.core.checkpoint import (
    _linear_from_flat,
    ae_transfer_from_h5,
    arch1_from_flat,
    arch1_to_flat,
    load_flat_h5,
    load_npz,
    save_flat_h5,
    save_npz,
    unflatten_like,
)
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import (
    arch1_params_from_numpy,
    arch1_params_to_numpy,
    lstm_params_from_numpy,
)
from novel_vqa_torch.core.logging import EMA, MetricsLogger
from novel_vqa_torch.core.profiling import nan_guard, trace
from novel_vqa_torch.core.tree import tree_map
from novel_vqa_torch.data.vqa import VQAData
from novel_vqa_torch.models.vqa import arch1
from novel_vqa_torch.parallel.dp import make_vqa_dp_indexed_step, make_vqa_dp_steps_scan
from novel_vqa_torch.parallel.mesh import cli_group


@dataclasses.dataclass
class TrainConfig:
    input_img_h5: str = "data_img.h5"
    input_ques_h5: str = "data_prepro.h5"
    input_json: str = "data_prepro.json"
    learning_rate: float = 3e-4
    decay_factor: float = 0.99997592083  # :78
    batch_size: int = 500
    max_iters: int = 150000
    nhimage: int = 4096
    input_encoding_size: int = 200
    rnn_size: int = 512
    rnn_layer: int = 2
    common_embedding_size: int = 1024
    num_output: int = 1000
    img_norm: int = 1
    # per-part L2 normalization dims for early-fusion features, e.g.
    # "2048,4096" (003_train_ae_based_ef.lua:116-124)
    img_norm_split: str = ""
    save_checkpoint_every: int = 150000
    checkpoint_path: str = "model/"
    seed: int = 123
    init_from: str = ""  # converted-AE transfer h5 (003_train_ae_based.lua)
    # warm restart from a flat h5 checkpoint (params only)
    start_from: str = ""
    # full-state resume (params + optimizer state + iteration) from a
    # train_state .npz written by --save_train_state
    resume: str = ""
    save_train_state: int = 0  # also write train_state.npz at checkpoints
    fusion: str = "axb"  # axb | askipb (wp variant)
    grad_clamp: float = 10.0
    # gradient downweighting of the encoder+embedding blocks
    # (003_train_ae_based_wp.lua:30,:344)
    lr_scale: float = 1.0
    log_every: int = 100
    # >1 runs that many iterations per call with on-device batch sampling
    # (arch1.train_steps_scan); 1 keeps host-side sampling (exact data.rng
    # stream)
    steps_per_dispatch: int = 1
    # 1 = data-parallel over the process group (torchrun: one process per
    # card; parallel/mesh.py): each rank trains on its slice of every
    # batch, the gradient mean all-reduced before the update
    data_parallel: int = 0
    profile_dir: str = ""  # torch.profiler chrome trace output dir ('' = off)
    debug_nans: int = 0  # 1 = torch.autograd.detect_anomaly
    # "bfloat16" = mixed-precision training (bf16 weights/activations, f32
    # products' results and master weights; no kernel); f32 as the reference
    compute_dtype: str = "float32"
    device: str = "cuda"


def build_params(opt: TrainConfig, cfg: arch1.Arch1Config, device):
    """Fresh params from ``--seed``, or the ``--start_from`` flat h5, or
    the ``--init_from`` AE transfer over fresh ones."""
    params = arch1.init_params(cfg, torch.Generator().manual_seed(opt.seed), device=device)
    if opt.start_from:
        return arch1_params_from_numpy(
            arch1_from_flat(load_flat_h5(opt.start_from), cfg), device
        )
    if opt.init_from:
        saved = ae_transfer_from_h5(
            opt.init_from, cfg.input_encoding_size, cfg.rnn_size, cfg.rnn_layer
        )
        lookup = saved["lookup"]  # (vocab+1, E)
        if lookup.shape[0] - 1 != cfg.vocab_size:
            raise ValueError(
                f"AE vocab {lookup.shape[0] - 1} != question vocab {cfg.vocab_size}"
            )
        # drop the last (START) entry, zero bias (003_train_ae_based.lua:177-183)
        params["embedding"] = arch1_params_from_numpy(
            {"w": lookup[:-1], "b": np.zeros(cfg.input_encoding_size, np.float32)},
            device,
        )
        params["encoder"] = lstm_params_from_numpy(saved["encoder"], device)
        if "multimodal" in saved and opt.fusion == "askipb":
            # AE multimodal init for the AskipB projections
            # (003_train_ae_based_wp.lua:151-160); final Linear stays fresh
            mv = np.asarray(saved["multimodal"], np.float32)
            wq, bq, off = _linear_from_flat(
                mv, 0, 2 * cfg.rnn_size * cfg.rnn_layer, cfg.common_embedding_size
            )
            wi, bi, off = _linear_from_flat(mv, off, cfg.nhimage, cfg.common_embedding_size)
            params["fusion"] = arch1_params_from_numpy(
                {"wq": wq, "bq": bq, "wi": wi, "bi": bi}, device
            )
    return params


def main(argv=None):
    opt = parse_config(TrainConfig, argv, description=__doc__)
    if opt.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown --compute_dtype {opt.compute_dtype}")
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

    split_dims = (
        [int(x) for x in opt.img_norm_split.split(",")] if opt.img_norm_split else None
    )
    data = VQAData(
        opt.input_ques_h5,
        opt.input_img_h5,
        opt.input_json,
        img_norm=bool(opt.img_norm),
        seed=opt.seed,
        img_norm_split_dims=split_dims,
    )
    cfg = arch1.Arch1Config(
        vocab_size=data.vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size,
        rnn_layer=opt.rnn_layer,
        nhimage=opt.nhimage,
        common_embedding_size=opt.common_embedding_size,
        num_output=opt.num_output,
        fusion=opt.fusion,
        compute_dtype=opt.compute_dtype,
    )
    params = build_params(opt, cfg, device)
    grad_scales = None
    if opt.lr_scale != 1.0:
        grad_scales = tree_map(lambda _: 1.0, params)
        for block in ("embedding", "encoder"):
            grad_scales[block] = tree_map(lambda _: opt.lr_scale, grad_scales[block])
    tx = arch1.make_optimizer(
        learning_rate=opt.learning_rate,
        decay_factor=opt.decay_factor,
        grad_clamp=opt.grad_clamp,
        grad_scales=grad_scales,
    )
    opt_state = tx.init(params)
    start_iter = 0
    if opt.resume:
        flat, meta = load_npz(opt.resume)
        restored = unflatten_like({"params": params, "opt_state": opt_state}, flat)
        to_dev = lambda a: torch.from_numpy(np.array(a)).to(device)
        params = tree_map(to_dev, restored["params"])
        opt_state = tree_map(to_dev, restored["opt_state"])
        start_iter = int(meta.get("iter", 0))
        print(f"resumed from {opt.resume} at iteration {start_iter}")
    # every rank starts from rank 0's state
    params = group.broadcast_tree(params)
    opt_state = group.broadcast_tree(opt_state)

    # ship the whole train split to the device once
    dev_data = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in data.split_store("train").items()
    }

    logger = MetricsLogger(os.path.join(opt.checkpoint_path, "save")) if writer else None
    ema = EMA(0.95)
    ema_val = EMA(0.95)
    n_train = data.num_examples("train")
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    pending_losses: list = []

    def validate():
        total, n_batches = 0.0, 0
        for batch in data.iter_split("val", opt.batch_size):
            loss, _ = arch1.eval_step(
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
        host_params = arch1_params_to_numpy(params)
        save_flat_h5(
            os.path.join(opt.checkpoint_path, tag + ".h5"), arch1_to_flat(host_params)
        )
        save_npz(
            os.path.join(opt.checkpoint_path, tag + ".npz"),
            host_params,
            meta={"cfg": cfg._asdict(), "opt": dataclasses.asdict(opt)},
        )
        if opt.save_train_state:
            save_npz(
                os.path.join(opt.checkpoint_path, "train_state.npz"),
                {"params": host_params, "opt_state": opt_state},
                meta={"cfg": cfg._asdict(), "iter": it},
            )

    chunk = max(1, opt.steps_per_dispatch)
    # DP: every rank samples the same global batch (the same seeds) and
    # trains on its slice of it (parallel/dp.py)
    step = make_vqa_dp_indexed_step(arch1.loss_fn, cfg, tx, group)
    it = start_iter
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
                # copied without waiting for the card (the host buffer is
                # staged before the copy returns)
                qinds = torch.from_numpy(
                    data.rng.integers(0, n_train, opt.batch_size)
                ).to(device, non_blocking=True)
                params, opt_state, loss = step(params, opt_state, dev_data, qinds, generator)
                pending_losses.append(loss[None])
                it += 1
            else:
                n_steps = min(chunk, opt.max_iters - it)
                scan = make_vqa_dp_steps_scan(arch1.loss_fn, cfg, tx, group, n_steps, opt.batch_size)
                params, opt_state, losses = scan(params, opt_state, dev_data, generator)
                pending_losses.append(losses)
                it += n_steps
            # defer the device sync: fold the losses into the EMA only at log
            # time (exact running_avg semantics, 002_train_baseline.lua:330-334)
            if it % opt.log_every < chunk:
                for f in torch.cat(pending_losses).tolist():
                    ema.update(f)
                pending_losses.clear()
                if writer:
                    logger.log_train(it, opt.max_iters, ema.value)

    save_ckpt("lstm")
    if writer:
        logger.close()
        print("done; final checkpoint at", os.path.join(opt.checkpoint_path, "lstm.h5"))


if __name__ == "__main__":
    main()
