#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                  # from the repository root, one CUDA card
    python3 chip_smoke.py --seq2-mutants   # the seq2 check against broken kernels

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: nvcc builds every kernel source of the port into build/, one
     nvcc per source, all started together;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the main paths' shapes and at odd shapes (the fp32 kernels
     within atol/rtol 1e-5; the bf16 seq2 kernel step by step against its
     plain version replayed from the kernel's own saved states, within
     1e-5 and one bf16 ulp, and run free within SEQ2_FREE_ATOL and
     SEQ2_HS_DIFFER_MAX), with its time, its plain version's time, one
     PyTorch library call's time as a yardstick, and its bound on an H100
     SXM.  The seq kernel also runs at In=512 under the eval slice's
     right-aligned lengths, where whole row tiles are inactive on the
     leading steps and it skips them, and under
     left-aligned lengths with two steps no row takes, where tiles skip
     interior steps that computed steps follow and their trailing steps;
     its rows report the cluster launch (CTAs per cluster, rows per
     cluster, CTAs, cudaOccupancyMaxActiveClusters) and the steps skipped
     per tile.  The seq2 kernel (also a cluster kernel) runs the train
     slice's multiplier at uniform right-aligned lengths and at the
     slices' question lengths (both timed), and the gaps masks at
     keep 0.7; its rows report the same launch and skip.  The step
     kernel runs a stack step of the step route (In=200, then 512), the
     autoencoder's width (N=1000), the weak-paired validation's (N=16)
     and compute_mean_vectors' (N=256) shapes, and odd shapes on both of
     its tiles; its
     rows report its launch (tile, CTAs, the CTAs an SM holds, one wave)
     and, where timed, the device time per call from a CUDA graph of 20
     calls (``device_ms``) beside the time per call a Python caller sees
     (``kernel_ms``), the same for its plain version and the library
     call; the build line reports its registers and spills (a spill
     fails the run);
  4. autograd: the forward-only kernel wrappers refuse an input that
     requires grad under grad mode, and launch nothing;
  5. slice: arch1 test-split inference through the eval CLI at the
     reference width (vocab 12782, E=200, 2x512 LSTM, 4096-d fc7, common
     1024, 1000 answers, T=16, batch 500) on a synthetic split with random
     seeded weights, in both store modes; the seq kernel's launch count,
     identical result JSONs, and the scores of the first batches against a
     forward through the plain LSTM; the ms per batch, the device time by
     kernel and the device's idle share;
  6. step route: ``lstm_encode(return_sequence=True)`` at the same width,
     which steps cell by cell through the step kernel, against the plain
     step;
  7. route agreement: at the reference width and dropout 0, the arch1
     loss and gradients of one batch through the ``NOVEL_VQA_FUSED2=1``
     route (the seq2 kernel, bf16 storage) against the default route (the
     f32 per-step cell), within ROUTE_TOL;
  8. train slice: the train CLI at the reference width on a synthetic
     train/val/test split, both routes, ``--steps_per_dispatch`` 1 and 10:
     seq2 launches equal the iterations under FUSED2 (none otherwise),
     validation launches the seq kernel, every loss is finite; the
     train-step time per route (CUDA events) and its device time by kernel
     (torch.profiler); ``train_steps_scan`` of 10 steps makes no host sync
     (``torch.cuda.set_sync_debug_mode("error")``); then the eval CLI on
     the trained ``lstm.h5``;
  9. decoders: whether this machine has PIL, and whether the native
     decoder (native/imagepipe.cpp) builds here, or why not;
 10. extract: VGG-16 fc7 at 224x224, batch 32, random seeded weights.
     (a) ``run_pipelined_extraction`` on EXTRACT_BATCHES predecoded uint8
     batches, float32 (TF32 off) and bfloat16: images/s (CUDA events around
     the loop, median of three runs after a warm-up), the forward's time
     per batch and its bound (FLOPs from the layer shapes over the peak for
     the type), device time by stage (torch.profiler); (b) the fc7 of the
     first two images (the second a missing file) against the port's fp32
     forward on the CPU, within EXTRACT_REL_TOL; every fc7 finite and >= 0;
     the missing row's prepro is the quirk image; (c) with a decoder, the
     extraction CLI over synthetic PNGs (written with zlib and struct),
     vgg16 and then vggembed + vgg19: the stores' shapes, identical rows for
     identical files, vgg16's features against (a)'s forward on the same
     decoded pixels, the decoder, the CLI's images/s, the host decode's
     images/s alone; without a decoder a line says why (c) did not run;
 11. chain: images to accuracy, extraction CLI (or, without a decoder,
     (a)'s features) -> eval CLI at the reference width -> matching
     annotations and questions -> ``eval.drivers`` on the OpenEnded and
     MultipleChoice JSONs, whose accuracies (overall, per answer type, the
     novel subset) must equal a count made here;
 12. ae: the text autoencoder at the reference width (text_nostart, vocab
     20,000, E = H = 512, one layer, T=16, batch 1000, adam) on a synthetic
     corpus of 20,000/2,000 sentences written through the port's h5 writer
     (``labels/*`` and ``label_length/*`` groups): ``train_text_ae`` for 20
     iterations at ``--steps_per_dispatch`` 1 and 10 with greedy samples and
     language eval, every logged loss finite, the step kernel's launches in
     validation equal to the count its loop implies (ae_evals x
     ae_eval_batches x 66); the greedy tokens of a val batch against the
     plain step (a differing token only at a tie, AE_TIE) and its fused NLL
     within 1e-5; the train step's ms (CUDA events, median of 10), its
     sentences/s (``text_ae_train_throughput``), device time by kernel and
     peak memory; ``train_steps_scan`` of 10 without a host sync; a val
     batch's ms; then ``convert_ae`` (its arrays equal the checkpoint's) and
     ``train_vqa_arch1 --init_from`` the converted file for 2 iterations;
 13. arch2: arch2 at the reference width (vocab 12782, E = H = 512, one
     layer, 4096-d fc7, 1000 answers, T=16, batch 500, dropout 0.5): an
     arch2 AE for 5 iterations on a corpus over the VQA vocabulary,
     ``train_vqa_arch2 --init_from`` its npz for 20 iterations at
     ``--steps_per_dispatch`` 1 and 10, ``eval_vqa_arch2`` on its lstm.h5 in
     both store modes over a 4,950-question left-aligned split whose row 0
     is a 16-token question and whose final short batch is shorter:
     identical JSONs, 18 step launches per batch per mode, the first batch
     within 1e-5 of a forward through the plain step; ms per batch and
     questions/s (CUDA events around the split, median of 5), device time
     by kernel, the idle share; the train step's ms;
 14. inception: Inception-v3's 2048-d pool at 299x299, batch 32, He-init
     weights, as phase 10 does VGG: the pipelined loop on INC_BATCHES
     predecoded batches, float32 (TF32 off) and bf16: images/s, the
     forward's ms per batch against its bound (FLOPs from the conv shapes),
     device ms by stage (inception.stem, .mixed5, .mixed6, .mixed7, .pool)
     and the idle share; the first two images against the port's CPU fp32
     forward (INC_REL_TOL); the CLI, ``--model inception``, on synthetic
     PNGs (center square crop), its rows against that forward;
 15. weakpaired: the weak-paired trainer at bench.py's reference width
     (VGG-16 at crop 224 from 256x256 stored images, batch 16, vocab
     20,000, E = H = 512, adam) on a synthetic corpus with ``images/*``
     groups: ``compute_mean_vectors lstm`` at batch 256 (its step launches,
     2 batches x 16, and its mean within 1e-5 of the plain route's), then
     the vqa_arch CLI run reading that mean, 20 iterations with the
     finetune gate at 10 and validation every 10 (33 step launches per
     validation batch at N=16, 3 batches, 3 validations); each phase's
     step in both compute dtypes (CUDA events, median of 10; device time
     by kernel, idle share, peak memory), the trunk's forward in both, a
     validation batch (its NLL within 1e-5 of the plain step's); a short
     null run on the Inception trunk at crop 224 (35 launches per
     validation batch).
Phases 9-15 print the card's name and power limit on their lines.
Then a line with nvidia-smi's name and power limit, one JSON line listing
every kernel, and as the last line ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without a card it exits non-zero at
once.  Imports torch, numpy, the standard library and the port only.

``--seq2-mutants`` runs phases 1-2 and then shows that the seq2 check is
tight enough: it builds variants of csrc/lstm2.cu, each with one of the
kernel's bf16 roundings done otherwise (toward zero, or from the f32
value; in a temporary directory, the checkout is not touched), and exits
0 only if the kernel passes the check and every variant fails it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = 1e-4
# seq2 kernel vs its plain version run free from the same inputs: a
# last-bit f32 difference can flip a bf16 rounding of h, and the flip feeds
# every later step, so the two drift apart by about one bf16 ulp of |h| < 1
# on the saved states and 6e-4 on the f32 finals.  These bounds hold that
# drift; they cannot tell the kernel from one without its bf16 roundings,
# which drifts as far.  The replay check (kernels/lstm2.replay_errors),
# which no flip survives, does.
SEQ2_FREE_ATOL = {"finals": 2e-3, "hs": 2.0**-8}
# ... and those flips touch a few of the saved bf16 states (at most 2.1% at
# the kernel check's shapes on an H100).  A kernel that rounds h toward zero
# in its operands and its saved states alike passes the replay, which takes
# those states as its operands, but differs on about half of them.
SEQ2_HS_DIFFER_MAX = 0.1
# FUSED2 route (bf16 storage) vs the default route (f32): loss relative
# error, and each gradient's error relative to its largest entry (the JAX
# package's bound for this comparison, tests/test_pallas_lstm.py:278)
ROUTE_TOL = 5e-2
SEED = 1234
REPS = 20

SOURCES = ("lstm.cu", "lstm2.cu")  # csrc/, built in parallel
SOURCE = "novel_vqa_torch/csrc/lstm.cu"  # seq and step kernels
SEQ2_SOURCE = "novel_vqa_torch/csrc/lstm2.cu"
SEQ_REPLACES = "novel_vqa_tpu/ops/pallas_lstm.py:173 (_seq_kernel)"
STEP_REPLACES = "novel_vqa_tpu/ops/pallas_lstm.py:40 (_fused_step_kernel)"
SEQ2_REPLACES = "novel_vqa_tpu/ops/pallas_lstm2.py:56 (_seq2_kernel)"

# the reference width (EvalConfig defaults, 002_train_baseline.lua:33-38)
V, E, H, L, F, C, O, T, BATCH = 12782, 200, 512, 2, 4096, 1024, 1000, 16, 500
N_TEST, N_IMG, N_MC = 4950, 2000, 18
# the train slice's synthetic split and run length
N_TRAIN, N_VAL, N_TEST_TRAIN = 5000, 1000, 1000
TRAIN_ITERS = 20
# the extract phase: VGG-16 fc7 at the reference extractor's input and
# ExtractConfig's default batch; fc7 held to the CPU fp32 forward within
# these relative errors (bf16: the JAX package's stated bound,
# extract_features.py:61-65)
EXTRACT_BATCH, EXTRACT_SIZE, EXTRACT_BATCHES = 32, 224, 16
EXTRACT_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
EXTRACT_CLI_IMAGES, EXTRACT_CLI_COPIES = 80, 8  # three batches, the last ragged
# the chained phase: images -> fc7 store -> eval -> accuracy
CHAIN_IMAGES, CHAIN_QUESTIONS = 200, 500
# the ae phase: the text AE at the reference width (AETrainConfig's
# defaults, 001_train_arch1_text_autoencoder.lua:22-59: E = H = 512, one
# layer, batch 1000, adam) over a 20k-word vocabulary (bench.py:490-520);
# its synthetic corpus and run length; a greedy token may differ from the
# plain step's only where the plain top-2 logprobs are this close (a tie)
AE_V, AE_E, AE_T, AE_BATCH = 20000, 512, 16, 1000
AE_N_TRAIN, AE_N_VAL, AE_ITERS = 20000, 2000, 20
AE_TIE = 1e-5
# the arch2 phase: arch2 at the reference width (TrainConfig's defaults,
# 003_train_vqa_arch2/002_train_baseline.lua:26-52: E = H = 512, one layer);
# its AE's corpus and run length
A2_E, A2_AE_SENTENCES, A2_AE_ITERS = 512, 5000, 5
# the inception phase: Inception-v3's 2048-d pool at the reference
# extractor's input (001_prepro_img_inc.lua, 299x299) and ExtractConfig's
# batch; a handful of synthetic PNGs through the CLI
INC_SIZE, INC_BATCHES, INC_CLI_IMAGES, INC_CLI_COPIES = 299, 8, 40, 4
# its features against the CPU fp32 forward: fp32 as VGG's; bf16 storage
# rounds ~47 stacked conv outputs on Inception's longest path (VGG: 16),
# about 1.2% of max |f32| by the end on the CPU, the JAX package's own bf16
# route as much as the port's (tests/test_torch_inception.py)
INC_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the weakpaired phase at bench.py's reference width (bench.py:604-650,
# WPTrainConfig's defaults): VGG-16 at crop 224 from 256x256 stored images,
# batch 16, vocab 20,000, E = H = 512, vqa_arch, adam; a corpus cut to one
# pass of the run and three validation batches; the finetune gate halfway;
# then a short Inception-trunk run (null) at crop 224, and
# compute_mean_vectors at its default batch
WP_V, WP_E, WP_BATCH, WP_SIDE, WP_CROP = 20000, 512, 16, 256, 224
WP_ITERS, WP_FINETUNE_AFTER, WP_EVERY = 20, 10, 10
WP_N_TRAIN, WP_N_VAL = WP_ITERS * WP_BATCH, 40
WP_INC_ITERS, WP_INC_FINETUNE_AFTER = 4, 2
MV_BATCH = 256


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` single calls timed with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, reps: int = REPS, warmup: int = 3) -> float:
    """Device time per call without the host's issue: ``calls`` calls of
    ``fn`` captured in one CUDA graph after warm-up (so no one-time host
    set-up runs inside the capture), the graph replayed ``reps`` times
    between CUDA events; the median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_lines(log: str):
    """What ptxas -v said of each kernel: entry, registers, spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def ptxas_report(lines, kernel: str):
    """Registers and spilled bytes of each compiled variant of ``kernel``
    (its entries in ``ptxas_lines``' output, which ptxas prints in the order
    entry, spills, registers)."""
    out, entry = [], None
    for ln in lines:
        if "Compiling entry" in ln:
            entry = {"entry": ln.split("'")[1]} if kernel in ln else None
            if entry:
                out.append(entry)
        elif entry is not None and "spill" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            entry["spill_bytes"] = nums[1] + nums[2]  # stores + loads
        elif entry is not None and "registers" in ln:
            entry["registers"] = int(ln.split("Used ")[1].split()[0])
    return out


def max_err(got, ref) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def errs(names, got, ref):
    return {n: float((a - b).abs().max()) for n, a, b in zip(names, got, ref)}


def check_close(what: str, got, ref) -> None:
    for a, b in zip(got, ref):
        if not torch.allclose(a, b, **TOL):
            raise AssertionError(f"{what}: max |err| {float((a - b).abs().max())} outside {TOL}")


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def ragged_mask(T_, N, gen, dev):
    """Right-aligned activity with lengths 1..T_."""
    lengths = torch.randint(1, T_ + 1, (N,), generator=gen, device=dev)
    return right_aligned(lengths, T_, dev)


def right_aligned(lengths, T_, dev):
    return (torch.arange(T_, device=dev)[:, None] >= (T_ - lengths)[None, :]).float()


def question_lengths(rs: np.random.RandomState, n: int) -> np.ndarray:
    """Question lengths around the VQA mean of ~6 words, capped at T."""
    return np.clip(rs.poisson(5.2, n) + 1, 1, T)


def eval_mask(T_, N, dev):
    """Right-aligned activity with the eval slice's question lengths."""
    lengths = torch.from_numpy(question_lengths(np.random.RandomState(SEED + 5), N)).to(dev)
    return right_aligned(lengths, T_, dev)


def steps_skipped(mask, rows: int) -> dict:
    """The steps the seq kernel skips: per tile of ``rows`` rows, those on
    which no row of the tile is active."""
    T_, N = mask.shape
    tiles = -(-N // rows)
    padded = mask.new_zeros(T_, tiles * rows)
    padded[:, :N] = mask
    skipped = (~(padded.view(T_, tiles, rows) > 0).any(dim=2)).sum(dim=0).tolist()
    return {"rows_per_tile": rows, "tiles": tiles, "per_tile_mean": sum(skipped) / tiles,
            "per_tile_min": min(skipped), "per_tile_max": max(skipped),
            "share_of_tile_steps": sum(skipped) / (tiles * T_)}


def gaps_mask(T_, N, gen, dev):
    """Left-aligned activity with lengths 1..T_-g, g = T_ // 4, and no row
    active on steps g and g+1 (4 and 5 at T=16): every tile skips those
    interior steps, computed steps follow them, and it skips its trailing
    steps."""
    g = T_ // 4
    lengths = torch.randint(1, T_ - g + 1, (N,), generator=gen, device=dev)
    mask = (torch.arange(T_, device=dev)[:, None] < lengths[None, :]).float()
    mask[g:g + 2] = 0.0
    return mask


def make_mask(kind, N, gen, dev):
    """The (T, N) mask of a kernel case: "uniform" draws right-aligned
    lengths 1..T uniformly, "eval" takes the slices' question lengths
    (right-aligned, as eval and training see them), "gaps" the
    left-aligned lengths of gaps_mask."""
    return {"uniform": lambda: ragged_mask(T, N, gen, dev), "eval": lambda: eval_mask(T, N, dev),
            "gaps": lambda: gaps_mask(T, N, gen, dev)}[kind]()


def uniform(gen, dev, *shape, scale=1.0):
    return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale


# the seq kernel's cases: (N, In, H, mask, timed); the first two are the
# eval path's layers, whose times the kernel line sums
SEQ_CASES = ((BATCH, E, H, "uniform", True), (BATCH, H, H, "uniform", True),
             (BATCH, H, H, "eval", True), (BATCH, H, H, "gaps", False),
             (13, 24, 40, "uniform", False), (13, 24, 600, "uniform", False),
             (13, 24, 600, "gaps", False))


def seq_inputs(N, In, H_, mask_kind, gen, dev):
    """The seq kernel's inputs, the mask of make_mask."""
    xs = uniform(gen, dev, T, N, In)
    mask = make_mask(mask_kind, N, gen, dev)
    wx, wh = uniform(gen, dev, In, 4 * H_, scale=0.08), uniform(gen, dev, H_, 4 * H_, scale=0.08)
    b = uniform(gen, dev, 4 * H_, scale=0.16)
    return xs, mask, wx, wh, b


def one_wave(launch: dict) -> dict:
    launch["one_wave"] = launch["max_active_clusters"] >= launch["clusters"]
    return launch


def seq_case(K, N, In, H_, mask_kind, timed, gen, dev):
    xs, mask, wx, wh, b = args = seq_inputs(N, In, H_, mask_kind, gen, dev)
    got = K.lstm_seq(*args)
    torch.cuda.synchronize()
    ref = K.lstm_seq_plain(*args)
    check_close(f"lstm_seq N={N} In={In} H={H_} mask={mask_kind}", got, ref)
    launch = one_wave(K.lstm_seq_launch_info(N, In, H_, dev))
    row = {"kernel": "lstm_seq", "N": N, "T": T, "In": In, "H": H_, "mask": mask_kind,
           "main": timed and mask_kind == "uniform", "max_abs_err": max_err(got, ref),
           "errs": errs(("c", "h", "hs"), got, ref), "launch": launch,
           "steps_skipped": steps_skipped(mask, launch["rows_per_cluster"])}
    if timed:
        active = float(mask.sum())
        flops = 2.0 * (In + H_) * 4 * H_ * active
        nbytes = 4.0 * (xs.numel() + mask.numel() + wx.numel() + wh.numel() + b.numel()
                        + 2 * N * H_ + T * N * H_)
        lstm = torch.nn.LSTM(In, H_).to(dev)
        lstm.flatten_parameters()  # cuDNN's packed weight layout
        with torch.no_grad():
            library = time_ms(lambda: lstm(xs))
        row.update(
            kernel_ms=time_ms(lambda: K.lstm_seq(xs, mask, wx, wh, b)),
            plain_ms=time_ms(lambda: K.lstm_seq_plain(xs, mask, wx, wh, b)),
            library_ms=library,
            library="torch.nn.LSTM (cuDNN, 1 layer, fp32, no TF32, unmasked)",
        )
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    return row


# the step kernel's cases: (N, In, H, timed, main); the first two are a
# stack step of the step route (In = E, then H), whose times the kernel line
# sums; then the autoencoder's width (train_text_ae.py:49-53), N a multiple
# of the row tile, and odd shapes: ragged row, unit and k tiles, rows not
# 16-byte aligned (In=13, 4-byte copies), more hidden units than one unit
# tile (H=600); the last two on the wide tile (more CTAs than SMs), the
# others at N <= 500 on the narrow one.  Timed beside them: the weak-paired
# validation's (N=16, a half-empty 32-row tile) and compute_mean_vectors'
# (N=256) steps
STEP_CASES = ((BATCH, E, H, True, True), (BATCH, H, H, True, True),
              (1000, H, H, True, False), (WP_BATCH, H, H, True, False), (MV_BATCH, H, H, True, False),
              (128, H, H, False, False),
              (13, 24, 40, False, False), (13, 24, 600, False, False), (7, 13, 37, False, False),
              (1000, E, 300, False, False), (1000, 13, 300, False, False))


def step_inputs(N, In, H_, gen, dev):
    x, h, c = uniform(gen, dev, N, In), uniform(gen, dev, N, H_), uniform(gen, dev, N, H_)
    wx, wh = uniform(gen, dev, In, 4 * H_, scale=0.08), uniform(gen, dev, H_, 4 * H_, scale=0.08)
    b = uniform(gen, dev, 4 * H_, scale=0.16)
    return x, h, c, wx, wh, b


def step_case(K, N, In, H_, timed, main, gen, dev):
    x, h, c, wx, wh, b = args = step_inputs(N, In, H_, gen, dev)
    got = K.lstm_step(*args)
    torch.cuda.synchronize()
    ref = K.lstm_step_plain(*args)
    check_close(f"lstm_step N={N} In={In} H={H_}", got, ref)
    launch = K.lstm_step_launch_info(N, In, H_, dev)
    launch["one_wave"] = launch["ctas"] <= launch["ctas_per_sm"] * launch["sms"]
    row = {"kernel": "lstm_step", "N": N, "In": In, "H": H_, "main": main,
           "max_abs_err": max_err(got, ref), "errs": errs(("c", "h"), got, ref), "launch": launch}
    if timed:
        flops = 2.0 * N * (In + H_) * 4 * H_
        nbytes = 4.0 * (x.numel() + 2 * h.numel() + wx.numel() + wh.numel() + b.numel() + 2 * N * H_)
        w_ih, w_hh, b_hh = wx.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)

        def kernel():
            K.lstm_step(*args)

        def plain():
            K.lstm_step_plain(*args)

        def library():
            torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)

        # per call as a Python caller pays it (CUDA events around one call,
        # host issue included), and device time alone (CUDA-graph replay)
        row.update(
            kernel_ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=time_ms(library),
            device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
            library_device_ms=device_ms(library), library="torch.lstm_cell (fp32)",
        )
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    return row


# the seq2 kernel's cases: (N, In, H, keep, mask, timed); the first is the
# train step's, whose time the kernel line gives
SEQ2_CASES = ((BATCH, E, H, 0.5, "uniform", True), (BATCH, E, H, 0.5, "eval", True),
              (BATCH, E, H, 0.7, "gaps", False), (13, 24, 40, 0.7, "uniform", False),
              (13, 24, 600, 0.7, "uniform", False), (13, 24, 600, 0.7, "gaps", False))


def seq2_inputs(N, In, H_, keep, mask_kind, gen, dev):
    """The seq2 kernel's inputs in bf16 storage: inputs, the {0, 1/keep}
    dropout multiplier, weights and biases in bf16, the mask of make_mask
    in f32.  Training's rate 0.5 gives {0, 2}; keep 0.7 gives a multiplier
    whose products are not exact in bf16, so the layer-2 input's own
    rounding matters."""
    bf = torch.bfloat16
    xs = uniform(gen, dev, T, N, In).to(bf)
    mask = make_mask(mask_kind, N, gen, dev)
    drop = ((torch.rand(T, N, H_, generator=gen, device=dev) < keep).float() / keep).to(bf)
    ws = [uniform(gen, dev, *shape, scale=scale).to(bf) for shape, scale in (
        ((In, 4 * H_), 0.08), ((H_, 4 * H_), 0.08), ((4 * H_,), 0.16),
        ((H_, 4 * H_), 0.08), ((H_, 4 * H_), 0.08), ((4 * H_,), 0.16))]
    return (xs, mask, drop, *ws)


def seq2_errors(K2, args):
    """One kernel run on ``args``: its errors against the plain version run
    free and replayed from the kernel's saved states, and the checks that
    failed (an empty list passes)."""
    got = K2.lstm_seq2(*args)
    torch.cuda.synchronize()
    ref = K2.lstm_seq2_plain(*args)
    free = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(K2.OUT_NAMES, got, ref)}
    replay = K2.replay_errors(args, got)
    # written so that a NaN fails
    failed = [f"replay {n}: {v:.3g} x its tolerance" for n, v in replay.items() if not v <= 1.0]
    for n, v in free.items():
        tol = SEQ2_FREE_ATOL["hs" if n.startswith("hs") else "finals"]
        if not v <= tol:
            failed.append(f"free {n}: {v:.3g} > {tol}")
    differ = [float((a != b).float().mean()) for a, b in zip(got[4:], ref[4:])]
    if not max(differ) <= SEQ2_HS_DIFFER_MAX:
        failed.append(f"free hs: {max(differ):.3g} of the bf16 states differ > {SEQ2_HS_DIFFER_MAX}")
    return {"max_abs_err": max(free.values()), "errs": free, "replay_err_ratio": replay,
            "hs_bf16_differ_share": differ, "failed": failed}


def seq2_case(K2, N, In, H_, keep, mask_kind, timed, gen, dev):
    """The seq2 kernel against its plain version, both checks."""
    xs, mask, drop, *ws = args = seq2_inputs(N, In, H_, keep, mask_kind, gen, dev)
    row = {"kernel": "lstm_seq2", "N": N, "T": T, "In": In, "H": H_, "keep": keep, "mask": mask_kind,
           "main": timed and mask_kind == "uniform", **seq2_errors(K2, args)}
    if row.pop("failed"):
        raise AssertionError(f"lstm_seq2 N={N} In={In} H={H_} keep={keep} mask={mask_kind}: {row}")
    launch = one_wave(K2.lstm_seq2_launch_info(N, In, H_, dev))
    row.update(launch=launch, steps_skipped=steps_skipped(mask, launch["rows_per_cluster"]))
    if timed:
        active = float(mask.sum())
        flops = 2.0 * (In + 3 * H_) * 4 * H_ * active  # both layers, active (row, step) pairs
        nbytes = (2.0 * (xs.numel() + drop.numel() + sum(w.numel() for w in ws)) + 4.0 * mask.numel()
                  + 4.0 * 4 * N * H_ + 2.0 * 2 * T * N * H_)
        from torch.backends.cudnn import rnn

        lstm = torch.nn.LSTM(In, H_, num_layers=2, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            # pack the weights into cuDNN's layout once, as flatten_parameters()
            # does for fp16/fp32; it skips bf16, and cuDNN would then copy the
            # weights into that layout on every call
            torch._cudnn_rnn_flatten_weight(lstm._flat_weights, 4, In, rnn.get_cudnn_mode("LSTM"),
                                            H_, 0, 2, False, False)
            library = time_ms(lambda: lstm(xs))
        row.update(
            kernel_ms=time_ms(lambda: K2.lstm_seq2(*args)),
            plain_ms=time_ms(lambda: K2.lstm_seq2_plain(*args)),
            library_ms=library,
            library="torch.nn.LSTM (cuDNN, 2 layers, bf16, unmasked, forward)",
        )
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, BF16_FLOPS)
    return row


# The seq2 check against kernels that do one of csrc/lstm2.cu's bf16
# roundings otherwise: (text in the source, its replacement).  The kernel
# stages every value as bf16, so a rounding cannot be left out; it can be
# toward zero (as taking the high half of an f32's bits does) or of the
# wrong value.  ``h`` is the unit's f32 hidden state in both layers.
SEQ2_MUTANTS = {
    # bf16(h1) pushed into the cluster for Wh1, rounded toward zero
    "h1_exchange_toward_zero": ("h1x[e] = hb1;", "h1x[e] = __float2bfloat16_rz(h);"),
    # bf16(h2) pushed for Wh2, rounded toward zero
    "h2_exchange_toward_zero": ("h2x[e] = hb2;", "h2x[e] = __float2bfloat16_rz(h);"),
    # d from the f32 h1 rather than bf16(h1)
    "d_from_f32_h1": ("__bfloat162float(hb1) * __bfloat162float(drop[o])",
                      "h * __bfloat162float(drop[o])"),
    # d's product rounded toward zero
    "d_toward_zero": ("dx[e] = __float2bfloat16_rn(d);", "dx[e] = __float2bfloat16_rz(d);"),
    # bf16(h1) rounded toward zero everywhere: exchange, saved state and d
    "h1_toward_zero": ("const bf16 hb1 = __float2bfloat16_rn(h);", "const bf16 hb1 = __float2bfloat16_rz(h);"),
    # the saved states rounded otherwise than the operands the kernel used
    "hs1_toward_zero": ("hs1_out[o] = hb1;", "hs1_out[o] = __float2bfloat16_rz(h);"),
    "hs2_toward_zero": ("H + j] = hb2;", "H + j] = __float2bfloat16_rz(h);"),
}
# the main shape at training's multiplier {0, 2}, and an odd one at keep 0.7
MUTANT_CASES = ((BATCH, E, H, 0.5, "uniform"), (13, 24, 600, 0.7, "gaps"))


def run_seq2_mutants(K2, dev):
    """Build each mutant in a temporary directory (one nvcc each, all
    started together), run the seq2 check on it at MUTANT_CASES through the
    port's own wrapper, and return each one's errors; the kernel itself is
    checked on the same inputs first."""
    from novel_vqa_torch.kernels import build

    source = (build.CSRC / K2.SOURCE).read_text()
    out = {"kernel": {}, "mutants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for header in build.CSRC.glob("*.cuh"):
            (Path(tmp) / header.name).write_text(header.read_text())

        def compile_mutant(name):
            old, new = SEQ2_MUTANTS[name]
            if source.count(old) != 1:
                raise AssertionError(f"mutant {name}: {old!r} occurs {source.count(old)} times in {K2.SOURCE}")
            src, lib = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            src.write_text(source.replace(old, new))
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                           check=True, capture_output=True, text=True)
            return lib

        with concurrent.futures.ThreadPoolExecutor(len(SEQ2_MUTANTS)) as pool:
            libs = dict(zip(SEQ2_MUTANTS, pool.map(compile_mutant, SEQ2_MUTANTS)))
        for i, case in enumerate(MUTANT_CASES):
            key = "N={} In={} H={} keep={} mask={}".format(*case)
            args = seq2_inputs(*case, torch.Generator(device=dev).manual_seed(SEED + 10 + i), dev)
            out["kernel"][key] = seq2_errors(K2, args)
            for name, path in libs.items():
                lib = build.load(path)
                with mock.patch.object(K2, "library", lambda source: lib):
                    out["mutants"].setdefault(name, {})[key] = seq2_errors(K2, args)
    for name, cases in out["mutants"].items():
        cases["rejected"] = any(r["failed"] for r in cases.values())
    return out


# --------------------------------------------------------------------------
# phase 4: the forward-only wrappers refuse a training graph
# --------------------------------------------------------------------------

def run_autograd_refusal(K, K2, dev):
    """Each CUDA wrapper, given an input that requires grad under grad
    mode, raises before its launch: its output would carry no grad_fn."""
    bf = torch.bfloat16
    N, In, H_ = 8, 24, 40
    xs = torch.zeros(T, N, In, device=dev, requires_grad=True)
    mask = torch.ones(T, N, device=dev)
    x, hc = torch.zeros(N, In, device=dev, requires_grad=True), torch.zeros(N, H_, device=dev)
    wx, wh, b = (torch.zeros(*s, device=dev) for s in ((In, 4 * H_), (H_, 4 * H_), (4 * H_,)))
    w2 = [torch.zeros(*s, device=dev, dtype=bf) for s in (
        (In, 4 * H_), (H_, 4 * H_), (4 * H_,), (H_, 4 * H_), (H_, 4 * H_), (4 * H_,))]
    cases = {
        "lstm_seq": lambda: K.lstm_seq(xs, mask, wx, wh, b),
        "lstm_step": lambda: K.lstm_step(x, hc, hc, wx, wh, b),
        "lstm_seq2": lambda: K2.lstm_seq2(xs.to(bf), mask, torch.ones(T, N, H_, device=dev, dtype=bf), *w2),
    }
    out = {}
    for name, fn in cases.items():
        before = (K.lstm_seq.launches, K.lstm_step.launches, K2.lstm_seq2.launches)
        try:
            fn()
        except RuntimeError as err:
            if "requires grad" not in str(err):
                raise
            out[name] = str(err)[:60]
        else:
            raise AssertionError(f"{name} accepted an input that requires grad under grad mode")
        if (K.lstm_seq.launches, K.lstm_step.launches, K2.lstm_seq2.launches) != before:
            raise AssertionError(f"{name} launched although it refused its input")
    return out


# --------------------------------------------------------------------------
# phase 5: the slice at the reference width
# --------------------------------------------------------------------------

def write_split(tmp: str, rs: np.random.RandomState, sizes, n_img: int = N_IMG,
                empty_mc_row: bool = True, vocab: int = V, long_first: bool = False) -> None:
    """Synthetic splits in the data_prepro.{h5,json} / data_img.h5 schema
    (000_prepro_vqa.py:273-293); ``sizes`` maps each split to its number
    of questions, over ``vocab`` words.  Train and val carry answers, test
    MC choices (with ``empty_mc_row``, row 5 has none); the splits share one
    table of ``n_img`` images.  With ``long_first`` the test split's row 0
    has T tokens and every question of its final short batch fewer, so a
    final batch padded with row 0 would run steps no real row takes."""
    from novel_vqa_torch.core.h5 import write_h5

    ques_h5, img_h5 = {}, {}
    for split, n_q in sizes.items():
        lengths = question_lengths(rs, n_q).astype(np.uint32)
        if long_first and split == "test":
            lengths[0] = T
            last = n_q - n_q % BATCH
            lengths[last:] = np.minimum(lengths[last:], T - 1)
        ques = np.zeros((n_q, T), np.uint32)
        for i, n in enumerate(lengths):
            ques[i, :n] = rs.randint(1, vocab + 1, size=n)
        ques_h5.update({
            f"ques_{split}": ques,
            f"ques_length_{split}": lengths,
            f"question_id_{split}": np.arange(n_q, dtype=np.uint32) * 10 + 7,
            f"img_pos_{split}": rs.randint(1, n_img + 1, size=n_q).astype(np.uint32),
        })
        if split == "test":
            mc = np.stack([rs.choice(O, N_MC, replace=False) + 1 for _ in range(n_q)]).astype(np.uint32)
            mc[::97, N_MC // 2:] = 0  # some rows with fewer choices
            if empty_mc_row:
                mc[5] = 0  # a row with none: MC falls back to the OE answer
            ques_h5["MC_ans_test"] = mc
        else:
            key = "answers" if split == "train" else f"answers_{split}"
            ques_h5[key] = rs.randint(1, O + 1, size=n_q).astype(np.uint32)
    write_h5(os.path.join(tmp, "data_prepro.h5"), ques_h5)
    # fc7 features are post-ReLU: non-negative
    fc7 = np.maximum(rs.randn(n_img, F), 0).astype(np.float32)
    write_h5(os.path.join(tmp, "data_img.h5"), {f"images_{split}": fc7 for split in sizes})
    meta = {
        "ix_to_word": {str(i): f"w{i}" for i in range(1, vocab + 1)},
        "ix_to_ans": {str(i): f"a{i}" for i in range(1, O + 1)},
    }
    meta.update({f"unique_img_{split}": [f"im{i}.png" for i in range(n_img)] for split in sizes})
    with open(os.path.join(tmp, "data_prepro.json"), "w") as f:
        json.dump(meta, f)


def data_argv(tmp: str):
    return ["--input_img_h5", os.path.join(tmp, "data_img.h5"),
            "--input_ques_h5", os.path.join(tmp, "data_prepro.h5"),
            "--input_json", os.path.join(tmp, "data_prepro.json")]


def plain_scores(params, cfg, tokens, image):
    """arch1's forward with the LSTM through the plain seq version, called
    here directly (no switch on the main path)."""
    from novel_vqa_torch.kernels.lstm import lstm_seq_plain
    from novel_vqa_torch.ops.embedding import embedding_lookup
    from novel_vqa_torch.ops.fusion import axb_apply
    from novel_vqa_torch.ops.lstm import pack_state

    emb = torch.tanh(embedding_lookup(params["embedding"]["w"], tokens, params["embedding"]["b"]))
    inp = emb.transpose(0, 1).contiguous()
    mask = (tokens != 0).float().transpose(0, 1).contiguous()
    cs, hs = [], []
    for layer in params["encoder"]:
        c, h, inp = lstm_seq_plain(inp, mask, layer["wx"], layer["wh"], layer["bx"] + layer["bh"])
        cs.append(c)
        hs.append(h)
    fused = axb_apply(params["fusion"], pack_state(torch.stack(cs), torch.stack(hs)), image)
    return fused @ params["classifier"]["w"] + params["classifier"]["b"]


def run_slice(K, dev):
    from novel_vqa_torch.core.checkpoint import arch1_to_flat, save_flat_h5
    from novel_vqa_torch.core.convert import arch1_params_to_numpy
    from novel_vqa_torch.data.vqa import VQAData
    from novel_vqa_torch.models.vqa import arch1
    from novel_vqa_torch.train import eval_vqa_arch1

    n_batches = -(-N_TEST // BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_split(tmp, np.random.RandomState(SEED), {"test": N_TEST})
        cfg = arch1.Arch1Config(vocab_size=V, input_encoding_size=E, rnn_size=H, rnn_layer=L,
                                nhimage=F, common_embedding_size=C, num_output=O)
        params = arch1.init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
        model = os.path.join(tmp, "lstm.h5")
        save_flat_h5(model, arch1_to_flat(arch1_params_to_numpy(params)))
        out["setup_s"] = time.perf_counter() - t0

        answers = {}
        for hbm in (1, 0):
            res = os.path.join(tmp, f"result_{hbm}")
            argv = data_argv(tmp) + [
                    "--model_path", model, "--out_path", res,
                    "--hbm_resident", str(hbm), "--device", "cuda"]
            K.lstm_seq.launches = 0
            K.lstm_step.launches = 0
            t0 = time.perf_counter()
            eval_vqa_arch1.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches}
            if launches["lstm_seq"] != 2 * n_batches:
                raise AssertionError(f"hbm_resident={hbm}: {launches} seq launches, expected {2 * n_batches}")
            files = sorted(os.listdir(res))
            answers[hbm] = {}
            for name in files:
                with open(os.path.join(res, name), "rb") as f:
                    answers[hbm][name] = f.read()
            for name, blob in answers[hbm].items():
                if len(json.loads(blob)) != N_TEST:
                    raise AssertionError(f"{name}: wrong number of entries")
            out[f"cli_hbm_resident_{hbm}"] = {"wall_s": wall, "launches": launches, "files": files}
        if answers[0] != answers[1] or len(answers[1]) != 2:
            raise AssertionError("the two store modes wrote different result JSONs")
        out["launches"] = out["cli_hbm_resident_1"]["launches"]

        # the kernel route's scores and written answers against the plain
        # LSTM, first batches
        data = VQAData(os.path.join(tmp, "data_prepro.h5"), os.path.join(tmp, "data_img.h5"),
                       os.path.join(tmp, "data_prepro.json"), load_test=True)
        store = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in data.split_store("test").items()}
        p_dev = params  # on the card; lstm.h5 holds them exactly (float32)
        oe =json.loads(answers[1][[n for n in answers[1] if n.startswith("OpenEnded")][0]])
        worst, near_ties, compared = 0.0, 0, 0
        with torch.inference_mode():
            for bi in range(3):
                qinds = torch.arange(bi * BATCH, (bi + 1) * BATCH, device=dev)
                tokens = store["tokens"][qinds]
                image = store["image"][store["img_pos"][qinds].long() - 1]
                got = arch1.apply(p_dev, cfg, tokens, image)
                ref = plain_scores(p_dev, cfg, tokens, image)
                worst = max(worst, float((got - ref).abs().max()))
                top2 = torch.topk(ref, 2, dim=1).values
                tie = (top2[:, 0] - top2[:, 1]) < SCORE_TOL
                pred_ref = (ref.argmax(1) + 1).tolist()
                pred_got = (got.argmax(1) + 1).tolist()
                for r in range(BATCH):
                    if tie[r]:
                        near_ties += 1
                        continue
                    written = oe[bi * BATCH + r]["answer"]
                    if pred_got[r] != pred_ref[r] or written != f"a{pred_ref[r]}":
                        raise AssertionError(f"row {bi * BATCH + r}: kernel route disagrees with the plain LSTM")
                    compared += 1
        if worst > SCORE_TOL:
            raise AssertionError(f"scores differ from the plain LSTM by {worst} > {SCORE_TOL}")
        out["scores_vs_plain"] = {"max_abs_err": worst, "rows_compared": compared,
                                  "near_ties_skipped": near_ties}

        # device time of the whole split through the resident path
        def whole_split():
            arch1.eval_predict_scan(cfg, p_dev, store, n_batches, BATCH)

        split_ms = time_ms(whole_split, reps=5, warmup=1)
        out["card"] = torch.cuda.get_device_name(dev)
        out["eval_ms_per_batch_on_card"] = split_ms / n_batches
        out["eval_questions_per_s_on_card"] = N_TEST / (split_ms / 1e3)
        out["batches"] = n_batches
        out["profile_top"] = profile(whole_split)
        out["device_idle_share"] = 1 - out["profile_top"]["device_ms_total"] / split_ms
        rows = K.lstm_seq_launch_info(BATCH, E, H, dev)["rows_per_cluster"]
        out["seq_steps_skipped"] = steps_skipped((store["tokens"] != 0).float().t().contiguous(), rows)
    return out


def profile(fn, top: int = 8):
    """Device time by kernel name over one call, from torch.profiler; the
    device-side copies of ``record_function`` ranges (VGG's and
    Inception's stages) are left out, which would count their kernels
    twice."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.device_time_total for e in events)
    events.sort(key=lambda e: -e.device_time_total)
    return {"device_ms_total": total / 1e3,
            "top": [{"name": e.key[:80], "ms": e.device_time_total / 1e3, "count": e.count}
                    for e in events[:top]]}


# --------------------------------------------------------------------------
# phase 6: the per-step route through the step kernel
# --------------------------------------------------------------------------

def run_step_route(K, dev, gen):
    from novel_vqa_torch.ops.lstm import lstm_encode, lstm_layer_init

    g_cpu = torch.Generator().manual_seed(SEED + 1)
    layers = [lstm_layer_init(g_cpu, E if i == 0 else H, H, device=dev) for i in range(L)]
    xs = uniform(gen, dev, T, BATCH, E)
    mask = ragged_mask(T, BATCH, gen, dev)

    K.lstm_seq.launches = 0
    K.lstm_step.launches = 0
    (c, h), (cs, hs) = lstm_encode(layers, xs, mask, return_sequence=True)
    torch.cuda.synchronize()
    launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches}
    if launches != {"lstm_seq": 0, "lstm_step": T * L}:
        raise AssertionError(f"step route launches {launches}, expected {T * L} step launches")

    # the same scan with the plain step, called here directly
    pc = xs.new_zeros(L, BATCH, H)
    ph = xs.new_zeros(L, BATCH, H)
    pcs, phs = [], []
    for t in range(T):
        inp, nc, nh = xs[t], [], []
        for li, la in enumerate(layers):
            c_l, h_l = K.lstm_step_plain(inp, ph[li], pc[li], la["wx"], la["wh"], la["bx"] + la["bh"])
            nc.append(c_l)
            nh.append(h_l)
            inp = h_l
        m = mask[t][None, :, None] > 0
        pc = torch.where(m, torch.stack(nc), pc)
        ph = torch.where(m, torch.stack(nh), ph)
        pcs.append(pc)
        phs.append(ph)
    ref = (pc, ph, torch.stack(pcs), torch.stack(phs))
    got = (c, h, cs, hs)
    check_close("lstm_encode(return_sequence=True)", got, ref)
    # and the whole-sequence route (seq kernel) reaches the same final state
    c2, h2 = lstm_encode(layers, xs, mask)
    check_close("seq route vs step route", (c2, h2), (c, h))
    return {"launches": launches, "max_abs_err": max_err(got, ref),
            "seq_vs_step_route_max_abs_err": max_err((c2, h2), (c, h))}


# --------------------------------------------------------------------------
# phase 7: the FUSED2 route against the default route
# --------------------------------------------------------------------------

def ref_cfg(**kw):
    from novel_vqa_torch.models.vqa import arch1

    return arch1.Arch1Config(vocab_size=V, input_encoding_size=E, rnn_size=H, rnn_layer=L,
                             nhimage=F, common_embedding_size=C, num_output=O, **kw)


@contextlib.contextmanager
def fused2_route(on: bool):
    """``NOVEL_VQA_FUSED2=1`` inside the block when ``on``, unset when not;
    the caller's setting afterwards."""
    old = os.environ.pop("NOVEL_VQA_FUSED2", None)
    if on:
        os.environ["NOVEL_VQA_FUSED2"] = "1"
    try:
        yield
    finally:
        os.environ.pop("NOVEL_VQA_FUSED2", None)
        if old is not None:
            os.environ["NOVEL_VQA_FUSED2"] = old


def run_route_agreement(K2, dev):
    """Loss and gradients of one reference-width batch at dropout 0."""
    from novel_vqa_torch.core.tree import tree_leaves, value_and_grad
    from novel_vqa_torch.models.vqa import arch1

    cfg = ref_cfg(dropout=0.0)
    params = arch1.init_params(cfg, torch.Generator().manual_seed(SEED + 2), device=dev)
    rs = np.random.RandomState(SEED + 2)
    tokens = np.zeros((BATCH, T), np.int32)
    for i, n in enumerate(question_lengths(rs, BATCH)):
        tokens[i, T - n:] = rs.randint(1, V + 1, size=n)  # right-aligned
    image = np.maximum(rs.randn(BATCH, F), 0).astype(np.float32)
    image /= np.linalg.norm(image, axis=1, keepdims=True)
    labels = rs.randint(1, O + 1, size=BATCH).astype(np.int32)
    batch = [torch.from_numpy(a).to(dev) for a in (tokens, image, labels)]

    res = {}
    for route in ("default", "fused2"):
        with fused2_route(route == "fused2"):
            K2.lstm_seq2.launches = 0
            loss, grads = value_and_grad(arch1.loss_fn)(params, cfg, *batch, None)
            torch.cuda.synchronize()
            res[route] = (float(loss), grads, K2.lstm_seq2.launches)
    if (res["default"][2], res["fused2"][2]) != (0, 1):
        raise AssertionError(f"seq2 launches {res['default'][2]} (default), {res['fused2'][2]} (FUSED2): expected 0, 1")
    loss_rel = abs(res["fused2"][0] - res["default"][0]) / abs(res["default"][0])
    grad_rel = {}
    for block in params:
        pairs = zip(tree_leaves(res["fused2"][1][block]), tree_leaves(res["default"][1][block]))
        grad_rel[block] = max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
    if loss_rel > ROUTE_TOL or max(grad_rel.values()) > ROUTE_TOL:
        raise AssertionError(f"FUSED2 vs default route: loss {loss_rel}, grads {grad_rel} outside {ROUTE_TOL}")
    return {"loss_default": res["default"][0], "loss_fused2": res["fused2"][0],
            "loss_rel_err": loss_rel, "grad_rel_err_by_block": grad_rel, "tol": ROUTE_TOL}


# --------------------------------------------------------------------------
# phase 8: the train CLI at the reference width, both routes
# --------------------------------------------------------------------------

def loss_emas(ckpt: str):
    with open(os.path.join(ckpt, "save", "logFile.txt")) as f:
        return [float(ln.split()[2]) for ln in f if ln.startswith("training loss:")]


def time_train_steps(K2, dev, tmp):
    """Train-step time per route at the reference width (CUDA events): one
    ``train_step_indexed`` and, per step, ``train_steps_scan`` of 10; each
    route's step device time by kernel from torch.profiler."""
    from novel_vqa_torch.data.vqa import VQAData
    from novel_vqa_torch.models.vqa import arch1

    data = VQAData(*(os.path.join(tmp, n) for n in ("data_prepro.h5", "data_img.h5", "data_prepro.json")))
    store = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in data.split_store("train").items()}
    cfg = ref_cfg()
    params = arch1.init_params(cfg, torch.Generator().manual_seed(SEED + 4), device=dev)
    tx = arch1.make_optimizer()
    opt_state = tx.init(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    qinds = torch.randint(0, N_TRAIN, (BATCH,), generator=gen, device=dev)
    out = {}
    for route in ("default", "fused2"):
        with fused2_route(route == "fused2"):
            def step():
                arch1.train_step_indexed(cfg, tx, params, opt_state, store, qinds, gen)

            out[f"{route}_step_ms"] = time_ms(step, reps=10, warmup=2)
            out[f"{route}_scan10_ms_per_step"] = time_ms(
                lambda: arch1.train_steps_scan(cfg, tx, params, opt_state, store, 10, BATCH, gen),
                reps=3, warmup=1) / 10
            out[f"{route}_step_profile"] = profile(step, top=12)
            # the multi-step loop never waits for the card: any synchronising
            # call inside it raises here
            torch.cuda.set_sync_debug_mode("error")
            try:
                arch1.train_steps_scan(cfg, tx, params, opt_state, store, 10, BATCH, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            out[f"{route}_scan10_sync_free"] = True
    return out


def run_train_slice(K, K2, dev):
    from novel_vqa_torch.train import eval_vqa_arch1, train_vqa_arch1

    n_val_batches = -(-N_VAL // BATCH)
    out = {"iters": TRAIN_ITERS, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_split(tmp, np.random.RandomState(SEED + 3),
                    {"train": N_TRAIN, "val": N_VAL, "test": N_TEST_TRAIN})
        out["setup_s"] = time.perf_counter() - t0
        for route in ("default", "fused2"):
            for spd in (1, 10):
                ckpt = os.path.join(tmp, f"{route}_{spd}")
                argv = data_argv(tmp) + [
                    "--checkpoint_path", ckpt + "/", "--max_iters", str(TRAIN_ITERS),
                    "--steps_per_dispatch", str(spd), "--log_every", "10", "--device", dev.type]
                with fused2_route(route == "fused2"):
                    K.lstm_seq.launches = K.lstm_step.launches = K2.lstm_seq2.launches = 0
                    t0 = time.perf_counter()
                    train_vqa_arch1.main(argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches,
                                "lstm_seq2": K2.lstm_seq2.launches}
                # one validation (iteration 0) through the seq kernel, and
                # under FUSED2 one seq2 launch per training iteration
                expected = {"lstm_seq": L * n_val_batches, "lstm_step": 0,
                            "lstm_seq2": TRAIN_ITERS if route == "fused2" else 0}
                if launches != expected:
                    raise AssertionError(f"train {route} spd={spd}: launches {launches}, expected {expected}")
                emas = loss_emas(ckpt)
                if len(emas) != TRAIN_ITERS // 10 or not all(np.isfinite(emas)):
                    raise AssertionError(f"train {route} spd={spd}: loss EMAs {emas}")
                out["runs"][f"{route}_spd{spd}"] = {"wall_s": wall, "launches": launches, "loss_ema": emas}

        res = os.path.join(tmp, "result")
        K.lstm_seq.launches = 0
        eval_vqa_arch1.main(data_argv(tmp) + ["--model_path", os.path.join(tmp, "fused2_1", "lstm.h5"),
                                              "--out_path", res, "--device", dev.type])
        torch.cuda.synchronize()
        files = sorted(os.listdir(res))
        for name in files:
            with open(os.path.join(res, name)) as f:
                if len(json.load(f)) != N_TEST_TRAIN:
                    raise AssertionError(f"{name}: wrong number of entries")
        if len(files) != 2 or K.lstm_seq.launches != L * -(-N_TEST_TRAIN // BATCH):
            raise AssertionError(f"eval of the trained lstm.h5: files {files}, {K.lstm_seq.launches} seq launches")
        out["eval_trained"] = {"files": files, "lstm_seq_launches": K.lstm_seq.launches}
        out.update(time_train_steps(K2, dev, tmp))
    return out


# --------------------------------------------------------------------------
# phase 9: VGG-16 fc7 extraction at full width
# --------------------------------------------------------------------------

def decoder_probe() -> dict:
    """Which host decoders this machine has: PIL, and the native decoder
    (built here from native/imagepipe.cpp, or why it could not be)."""
    import importlib.util

    from novel_vqa_torch.data import native_images

    native = native_images.available()
    return {"pil": importlib.util.find_spec("PIL") is not None, "native": native,
            "native_reason": native_images.unavailable_reason()}


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG with the standard library alone."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    raw = b"".join(b"\0" + row.tobytes() for row in rgb)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_images(folder: str, n: int, rs: np.random.RandomState, copies: int = 0):
    """``n`` PNGs of a few sizes around 240x320 (so every decode resizes);
    the last ``copies`` are byte copies of the first ones.  Returns the
    file names."""
    os.makedirs(folder, exist_ok=True)
    names = [f"im{i}.png" for i in range(n)]
    for i, name in enumerate(names):
        if i >= n - copies:
            with open(os.path.join(folder, names[i - (n - copies)]), "rb") as src:
                blob = src.read()
            with open(os.path.join(folder, name), "wb") as dst:
                dst.write(blob)
        else:
            write_png(os.path.join(folder, name),
                      rs.randint(0, 256, (240 + 8 * (i % 3), 320, 3), dtype=np.uint8))
    return names


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, per the JAX package's vision parity
    tests (tests/test_vision_torch_parity.py)."""
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def stage_profile(fn, top: int = 6) -> dict:
    """Device ms by stage over one call of the extraction forward, from
    torch.profiler: each ``record_function`` range of the forward
    (extract.prepro, vgg.block1..5, vgg.fc6, vgg.fc7) sums the device time
    of the kernels launched inside it (Inception's: inception.stem, .mixed5,
    .mixed6, .mixed7, .pool); beside it the total kernel time (the
    ranges' own device-side annotations left out, which would count each
    kernel twice) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    stages = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
              if e.key.startswith(("extract.", "vgg.", "inception."))
              and e.device_type == torch.autograd.DeviceType.CPU}
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    total = sum(ms for ms, _ in by_name.values())
    return {"device_ms_total": total, "stages_ms": stages,
            "stages_share": {k: v / total for k, v in stages.items()} if total else {},
            "top": [{"name": n[:80], "ms": ms, "count": c}
                    for n, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]}


def extract_batches(rs: np.random.RandomState, n_batches: int, missing_row: int):
    """``n_batches`` predecoded (u8, missing, real) host batches of random
    pixels at the full width; one row of the first batch is a missing file."""
    out = []
    for bi in range(n_batches):
        u8 = rs.randint(0, 256, (EXTRACT_BATCH, EXTRACT_SIZE, EXTRACT_SIZE, 3), dtype=np.uint8)
        missing = np.zeros(EXTRACT_BATCH, bool)
        if bi == 0:
            missing[missing_row] = True
        out.append((u8, missing, EXTRACT_BATCH))
    return out


def run_extract(K, K2, dev, smi: str, probe: dict):
    """(a) the pipelined loop on predecoded batches, both routes: images/s,
    device time by stage, the bound; (b) the card's fc7 against the port's
    CPU fp32 forward, the missing-row quirk; (c) the CLI end to end with the
    decoder this machine has.  Returns (phase output, the float32 route's
    features)."""
    from novel_vqa_torch.core.tree import tree_map
    from novel_vqa_torch.data import images as I
    from novel_vqa_torch.models.vision import vgg
    from novel_vqa_torch.models.vision.layers import bf16_storage_cast
    from novel_vqa_torch.train import extract_features as X

    t0 = time.perf_counter()
    f32, size, _, ndims = X.build_model("vgg16", "", "fc7", SEED, image_size=EXTRACT_SIZE, device=dev)
    forwards = {"float32": f32, "bfloat16": X.Extractor(
        bf16_storage_cast(f32.params), f32.cfg, f32.tap, f32.prepro, ndims, dev)}
    batches = extract_batches(np.random.RandomState(SEED + 20), EXTRACT_BATCHES, missing_row=1)
    n = EXTRACT_BATCH * EXTRACT_BATCHES
    out = {"card": smi, "model": "vgg16", "tap": "fc7", "image_size": size,
           "batch": EXTRACT_BATCH, "batches": EXTRACT_BATCHES, "setup_s": time.perf_counter() - t0,
           "routes": {}}
    flops = vgg.forward_flops(f32.cfg, "fc7") * EXTRACT_BATCH

    # (b)'s reference: the port's own forward on the CPU, same weights,
    # the first two images (the second one missing)
    cpu = X.Extractor(tree_map(lambda t: t.cpu(), f32.params), f32.cfg, "fc7", f32.prepro, ndims,
                      torch.device("cpu"))
    u8_0, miss_0 = (torch.from_numpy(a[:2]) for a in batches[0][:2])
    ref = cpu(u8_0, miss_0)

    # the missing-row quirk through the card's prepro: the constants exactly
    x0 = I.vgg_device_prepro(u8_0.to(dev), miss_0.to(dev))
    quirk = torch.tensor(I.VGG_MISSING_BGR, device=dev).view(3, 1, 1).expand(3, size, size)
    if not torch.equal(x0[1], quirk) or not torch.equal(x0[0].cpu(), I.vgg_device_prepro(u8_0, miss_0)[0]):
        raise AssertionError("vgg_device_prepro on the card: the missing row or a decoded row differs")

    feats = {}
    for route, fwd in forwards.items():
        K.lstm_seq.launches = K.lstm_step.launches = K2.lstm_seq2.launches = 0
        runs = []
        for _ in range(4):  # the first warms cuDNN's heuristics and the allocator
            got = np.empty((n, ndims), np.float32)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            X.run_pipelined_extraction([(fwd, size, False, ndims)], [""] * n, EXTRACT_BATCH, 1,
                                       feats=got, depth=4, predecoded=batches)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches,
                    "lstm_seq2": K2.lstm_seq2.launches}
        feats[route] = got
        got_t = torch.from_numpy(got)
        if not bool(torch.isfinite(got_t).all()) or float(got_t.min()) < 0:
            raise AssertionError(f"extract {route}: fc7 not finite or negative")
        errs_ = [rel_err(got_t[r], ref[r]) for r in range(2)]
        tol = EXTRACT_REL_TOL[route]
        if not max(errs_) <= tol:
            raise AssertionError(f"extract {route}: fc7 of the first images off the CPU forward by {errs_} > {tol}")
        loop_ms = statistics.median(runs[1:])
        d_u8, d_miss = (torch.from_numpy(a).to(dev) for a in batches[1][:2])
        forward_ms = time_ms(lambda: fwd(d_u8, d_miss), reps=10, warmup=2)
        weight_bytes = sum(t.numel() * t.element_size() for t in
                           [c[k] for c in fwd.params["conv"] for k in "wb"]
                           + [fwd.params[b][k] for b in ("fc6", "fc7") for k in "wb"])
        bound_ms, bound_by = bound(flops, d_u8.numel() + weight_bytes + 4 * EXTRACT_BATCH * ndims,
                                   FP32_FLOPS if route == "float32" else BF16_FLOPS)
        prof = stage_profile(lambda: fwd(d_u8, d_miss))
        out["routes"][route] = {
            "images_per_s": n / (loop_ms / 1e3), "loop_ms": loop_ms, "loop_runs_ms": runs,
            "ms_per_batch": loop_ms / EXTRACT_BATCHES, "forward_ms_per_batch": forward_ms,
            "bound_ms_per_batch": bound_ms, "bound_by": bound_by, "gflop_per_batch": flops / 1e9,
            "rel_err_vs_cpu_fp32": errs_, "tol": tol, "launches": launches, "profile": prof,
            "device_idle_share": 1 - prof["device_ms_total"] / forward_ms,
        }
    out["cpu_reference"] = "the port's fp32 forward on the CPU, images 0-1 (1 missing), rel per row"
    out["cli"] = run_extract_cli(dev, probe, forwards["float32"])
    return out, feats["float32"]


def run_extract_cli(dev, probe: dict, f32) -> dict:
    """(c): the extraction CLI over EXTRACT_CLI_IMAGES synthetic PNGs, vgg16
    and then vggembed + vgg19; the stores read back through core/h5.py."""
    from novel_vqa_torch.core.h5 import H5Reader
    from novel_vqa_torch.data import images as I
    from novel_vqa_torch.train import extract_features as X

    if not (probe["native"] or probe["pil"]):
        return {"ran": False, "reason": f"no decoder on this machine: no PIL, and the native "
                                        f"decoder did not build ({probe['native_reason']})"}
    out = {"ran": True, "decoder": I.default_decoder(), "images": EXTRACT_CLI_IMAGES,
           "identical_copies": EXTRACT_CLI_COPIES}
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "img")
        names = write_images(folder, EXTRACT_CLI_IMAGES, np.random.RandomState(SEED + 21),
                             copies=EXTRACT_CLI_COPIES)
        with open(os.path.join(tmp, "data_prepro.json"), "w") as f:
            json.dump({"unique_img_test": names}, f)
        base = ["--input_json", os.path.join(tmp, "data_prepro.json"), "--image_root", folder,
                "--seed", str(SEED), "--image_size", str(EXTRACT_SIZE), "--device", dev.type]
        for key, extra, width in (("vgg16", ["--model", "vgg16"], 4096),
                                  ("vggembed+vgg19", ["--model", "vggembed", "--model2", "vgg19"], 4800 + 4096)):
            store = os.path.join(tmp, f"{key}.h5")
            t0 = time.perf_counter()
            X.main(base + extra + ["--out_name", store])
            wall = time.perf_counter() - t0
            with H5Reader(store) as h5:
                keys, feats = h5.keys(), h5["images_test"]
            if keys != ["images_test"] or feats.shape != (EXTRACT_CLI_IMAGES, width) or feats.dtype != np.float32:
                raise AssertionError(f"CLI {key}: store {keys} {feats.shape} {feats.dtype}")
            if not np.isfinite(feats).all():
                raise AssertionError(f"CLI {key}: non-finite features")
            first = EXTRACT_CLI_IMAGES - EXTRACT_CLI_COPIES
            if not np.array_equal(feats[first:], feats[:EXTRACT_CLI_COPIES]):
                raise AssertionError(f"CLI {key}: identical images gave different rows")
            out[key] = {"shape": list(feats.shape), "wall_s": wall,
                        "images_per_s_wall": EXTRACT_CLI_IMAGES / wall}
            if key == "vgg16":
                # (a)'s forward on the same decoded pixels; the host decode
                # alone, and the CLI's loop (decode and device) without the
                # CLI's weight init and store write
                paths = [os.path.join(folder, n_) for n_ in names]
                pool = I.DecodePool(EXTRACT_SIZE)
                try:
                    t0 = time.perf_counter()
                    decoded = list(pool.iter_batches(paths, EXTRACT_BATCH))
                    decode_s = time.perf_counter() - t0
                finally:
                    pool.close()
                rows = [f32(torch.from_numpy(u8).to(dev), torch.from_numpy(m).to(dev))[:real].cpu()
                        for u8, m, real in decoded]
                err = rel_err(torch.from_numpy(feats), torch.cat(rows))
                if not err <= EXTRACT_REL_TOL["float32"]:
                    raise AssertionError(f"CLI vgg16 features off (a)'s forward by {err}")
                _, loop_s = X.run_pipelined_extraction([(f32, EXTRACT_SIZE, False, 4096)], paths,
                                                       EXTRACT_BATCH, 8, depth=4)
                out[key].update(rel_err_vs_forward=err,
                                decode_only_images_per_s=EXTRACT_CLI_IMAGES / decode_s,
                                loop_images_per_s=EXTRACT_CLI_IMAGES / loop_s)
    return out


# --------------------------------------------------------------------------
# phase 10: images to accuracy
# --------------------------------------------------------------------------

def write_annotations(tmp: str, rs: np.random.RandomState, qids, img_pos, results, mc_choices, ix_to_ans):
    """Annotations and questions that match the split: each question's ten
    human answers hold its OpenEnded answer k1 times and its MultipleChoice
    answer k2 times (k1 + k2 <= 10, at random) and draws from the answer
    table otherwise; answer and question types drawn at random.  Returns
    the file paths and the annotations."""
    oe, mc = ({r["question_id"]: r["answer"] for r in results[t]} for t in ("OpenEnded", "MultipleChoice"))
    answers = list(ix_to_ans.values())
    anns = []
    for q, img in zip(qids, img_pos):
        k1 = rs.randint(0, 11)
        k2 = rs.randint(0, 11 - k1)
        given = [oe[q]] * k1 + [mc[q]] * k2 + [answers[j] for j in rs.randint(0, len(answers), 10 - k1 - k2)]
        rs.shuffle(given)
        anns.append({"question_id": q, "image_id": img, "multiple_choice_answer": given[0],
                     "question_type": ["what is", "how many", "is the"][rs.randint(3)],
                     "answer_type": ["other", "number", "yes/no"][rs.randint(3)],
                     "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": i + 1}
                                 for i, a in enumerate(given)]})
    head = {"info": {}, "data_type": "mscoco", "data_subtype": "val2014", "license": {}}
    paths = {"ann": os.path.join(tmp, "ann.json")}
    with open(paths["ann"], "w") as f:
        json.dump({**head, "annotations": anns}, f)
    for task, task_type in (("OpenEnded", "Open-Ended"), ("MultipleChoice", "Multiple Choice")):
        ques = [{"question_id": q, "image_id": img, "question": "what is this?"}
                for q, img in zip(qids, img_pos)]
        if task == "MultipleChoice":
            for entry, row in zip(ques, mc_choices):
                entry["multiple_choices"] = [ix_to_ans[str(int(c))] for c in row if c]
        paths[task] = os.path.join(tmp, f"{task}_questions.json")
        with open(paths[task], "w") as f:
            json.dump({**head, "task_type": task_type, "questions": ques}, f)
    return paths, anns


def direct_accuracy(anns, res, qids=None) -> dict:
    """The VQA accuracy counted here, independently of eval/: per question
    the mean over its ten answers of min(1, matches among the other nine /
    3), in percent, rounded to 2 places; overall and per answer type.  The
    answers hold no punctuation, digits words or articles, so the
    evaluator's normalisation leaves them as they are."""
    pred = {r["question_id"]: r["answer"] for r in res}
    by_q = {a["question_id"]: a for a in anns}
    accs, by_type = [], {}
    for q in (qids if qids is not None else [a["question_id"] for a in anns]):
        given = [x["answer"] for x in by_q[q]["answers"]]
        acc = sum(min(1.0, float(sum(g == pred[q] for j, g in enumerate(given) if j != i)) / 3)
                  for i in range(len(given))) / len(given)
        accs.append(acc)
        by_type.setdefault(by_q[q]["answer_type"], []).append(acc)
    out = {"overall": round(100 * float(sum(accs)) / len(accs), 2)}
    for t in ("other", "number", "yes/no"):
        v = by_type.get(t)
        out[t] = round(100 * float(sum(v)) / len(v), 2) if v else None
    return out


def run_chain(K, dev, smi: str, probe: dict, stored_feats: np.ndarray) -> dict:
    """Images to accuracy: extract fc7 for CHAIN_IMAGES synthetic images with
    the CLI (or, with no decoder, take (a)'s features), eval a
    CHAIN_QUESTIONS split over them with eval_vqa_arch1 at the reference
    width, write matching annotations and questions, run eval.drivers on
    both result files and hold its accuracies to a direct count."""
    from novel_vqa_torch.core.checkpoint import arch1_to_flat, save_flat_h5
    from novel_vqa_torch.core.convert import arch1_params_to_numpy
    from novel_vqa_torch.core.h5 import H5Reader, write_h5
    from novel_vqa_torch.eval import drivers
    from novel_vqa_torch.models.vqa import arch1
    from novel_vqa_torch.train import eval_vqa_arch1
    from novel_vqa_torch.train import extract_features as X

    out = {"card": smi, "images": CHAIN_IMAGES, "questions": CHAIN_QUESTIONS}
    rs = np.random.RandomState(SEED + 30)
    with tempfile.TemporaryDirectory() as tmp:
        write_split(tmp, rs, {"test": CHAIN_QUESTIONS}, n_img=CHAIN_IMAGES, empty_mc_row=False)
        store = os.path.join(tmp, "data_img.h5")
        t0 = time.perf_counter()
        if probe["native"] or probe["pil"]:
            folder = os.path.join(tmp, "img")
            write_images(folder, CHAIN_IMAGES, rs)
            X.main(["--input_json", os.path.join(tmp, "data_prepro.json"), "--image_root", folder,
                    "--out_name", store, "--seed", str(SEED), "--image_size", str(EXTRACT_SIZE),
                    "--device", dev.type])
            out["features"] = "extraction CLI"
        else:
            write_h5(store, {"images_test": stored_feats[:CHAIN_IMAGES]})
            out["features"] = "the extract phase's float32 run (no decoder)"
        out["extract_s"] = time.perf_counter() - t0
        with H5Reader(store) as h5:
            if h5["images_test"].shape != (CHAIN_IMAGES, F):
                raise AssertionError(f"chain store {h5['images_test'].shape}")

        cfg = ref_cfg()
        params = arch1.init_params(cfg, torch.Generator().manual_seed(SEED + 31), device=dev)
        model = os.path.join(tmp, "lstm.h5")
        save_flat_h5(model, arch1_to_flat(arch1_params_to_numpy(params)))
        res = os.path.join(tmp, "result")
        K.lstm_seq.launches = K.lstm_step.launches = 0
        eval_vqa_arch1.main(data_argv(tmp) + ["--model_path", model, "--out_path", res, "--device", dev.type])
        torch.cuda.synchronize()
        out["eval_launches"] = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches}
        if out["eval_launches"]["lstm_seq"] != L * -(-CHAIN_QUESTIONS // BATCH):
            raise AssertionError(f"chain eval: {out['eval_launches']} launches")

        with H5Reader(os.path.join(tmp, "data_prepro.h5")) as h5:
            qids = [int(q) for q in h5["question_id_test"]]
            img_pos = [int(p) for p in h5["img_pos_test"]]
            mc_choices = h5["MC_ans_test"]
        with open(os.path.join(tmp, "data_prepro.json")) as f:
            ix_to_ans = json.load(f)["ix_to_ans"]
        results = {}
        for task in ("OpenEnded", "MultipleChoice"):
            with open(os.path.join(res, f"{task}_mscoco_val2014_lstm_novel_new_2_results.json")) as f:
                results[task] = json.load(f)
        paths, anns = write_annotations(tmp, rs, qids, img_pos, results, mc_choices, ix_to_ans)
        novel = qids[: CHAIN_QUESTIONS // 5]
        with open(os.path.join(tmp, "ques_id_hist.json"), "w") as f:
            json.dump({"0": novel}, f)
        for task in ("OpenEnded", "MultipleChoice"):
            acc_json = os.path.join(tmp, f"{task}_acc.json")
            drivers.main(["--data_dir", tmp, "--task_type", task, "--ann_file", paths["ann"],
                          "--ques_file", paths[task],
                          "--res_file", os.path.join(res, f"{task}_mscoco_val2014_lstm_novel_new_2_results.json"),
                          "--ques_id_hist", os.path.join(tmp, "ques_id_hist.json"), "--out_json", acc_json])
            with open(acc_json) as f:
                got = json.load(f)
            want = direct_accuracy(anns, results[task])
            want["novel"] = direct_accuracy(anns, results[task], novel)["overall"]
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"chain {task}: eval.drivers {got} != the direct count {want}")
            out[task] = {k: got[k] for k in want}
        out["accuracies_equal_direct_count"] = True
    return out


# --------------------------------------------------------------------------
# phase 12: the text autoencoder at the reference width
# --------------------------------------------------------------------------

def write_corpus(folder: str, rs: np.random.RandomState, vocab: int, sizes, image_side: int = 0) -> tuple:
    """A synthetic corpus in the prepro_book_corpus schema
    (000_prepro_book_corpus.py:343-368): ``labels/<split>`` (n, T) uint32,
    left-aligned sentences of 1..T words, and ``label_length/<split>``;
    with ``image_side``, the weak-paired loader's ``images/<split>`` (n, 3,
    side, side) uint8 (DataLoaderWeakPaired.lua:72); written through the
    port's own h5 writer.  Returns (h5, json) paths."""
    from novel_vqa_torch.core.h5 import write_h5

    os.makedirs(folder, exist_ok=True)
    arrays = {}
    for split, n in sizes.items():
        lengths = rs.randint(1, T + 1, size=n)
        labels = np.zeros((n, T), np.uint32)
        words = np.arange(T)[None, :] < lengths[:, None]
        labels[words] = rs.randint(1, vocab + 1, size=int(words.sum()))
        arrays[f"labels/{split}"] = labels
        arrays[f"label_length/{split}"] = lengths.astype(np.uint32)
        if image_side:
            arrays[f"images/{split}"] = rs.randint(0, 256, (n, 3, image_side, image_side), dtype=np.uint8)
    h5, meta = os.path.join(folder, "data.h5"), os.path.join(folder, "data.json")
    write_h5(h5, arrays)
    with open(meta, "w") as f:
        json.dump({"ix_to_word": {str(i): f"w{i}" for i in range(1, vocab + 1)},
                   **{f"num_{split}": n for split, n in sizes.items()}}, f)
    return h5, meta


def ae_eval_batches(n_val: int, batch: int, use: int) -> int:
    """The batches one ``eval_split`` reads: the loader's iterator from 0
    until a batch wraps (the head re-read included) or ``use`` sentences
    were read (train_text_ae.eval_split, DataLoader.lua:58-88)."""
    it, n, batches = 0, 0, 0
    while True:
        batches += 1
        n += batch
        if it + batch > n_val:
            return batches
        it += batch
        if 0 <= use <= n:
            return batches


def ae_evals(iters: int, spd: int, every: int) -> int:
    """The validations of one ``train_text_ae`` run: its loop's cadence."""
    it, evals = 0, 0
    while True:
        it += spd - 1
        if it % every < spd or it >= iters - 1:
            evals += 1
        it += 1
        if iters <= it:
            return evals


def plain_greedy(params, cfg, state):
    """``autoencoder.sample``'s greedy loop written out with the plain step,
    called here directly: the tokens (L, N) and each step's top-2 logprob
    gap (L, N).  The text_nostart lookup in eval mode is tanh(W[token])."""
    from novel_vqa_torch.kernels.lstm import lstm_step_plain
    from novel_vqa_torch.ops.embedding import embedding_lookup

    dec = params["decoder"]
    c, h = state
    tokens = torch.full((c.shape[1],), cfg.start_token, dtype=torch.long, device=c.device)
    out, gaps, lp = [], [], None
    for t in range(cfg.seq_length + 1):
        if t > 0:
            top2 = torch.topk(lp, 2, dim=1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            tokens = torch.argmax(lp, dim=1) + 1
            out.append(tokens)
        x = torch.tanh(embedding_lookup(params["lookup"], tokens))
        nc, nh = [], []
        for li, la in enumerate(dec["layers"]):
            c_l, h_l = lstm_step_plain(x, h[li], c[li], la["wx"], la["wh"], la["bx"] + la["bh"])
            nc.append(c_l)
            nh.append(h_l)
            x = h_l
        c, h = torch.stack(nc), torch.stack(nh)
        lp = torch.log_softmax(h[-1] @ dec["proj_w"] + dec["proj_b"], dim=1)
    return torch.stack(out), torch.stack(gaps)


def greedy_agreement(K, params, cfg, seq) -> dict:
    """Greedy tokens of one batch through the step kernel (the CLI's
    ``greedy_tokens``) against the plain step.  Each row is compared up to
    its first differing token, which must fall where the plain path's top-2
    gap is under AE_TIE (a tie); after it the rows feed different tokens."""
    from novel_vqa_torch.models.seq import autoencoder as ae
    from novel_vqa_torch.train import train_text_ae

    got = train_text_ae.greedy_tokens(cfg, params, seq)
    with torch.inference_mode(), mock.patch.object(K, "lstm_step", K.lstm_step_plain):
        ref, gaps = plain_greedy(params, cfg, ae.encode(params, cfg, seq))
    differ = got != ref
    rows = differ.any(dim=0)
    first = torch.argmax(differ.int(), dim=0)
    first_gaps = gaps[first, torch.arange(seq.shape[1], device=seq.device)][rows]
    if bool((first_gaps >= AE_TIE).any()):
        raise AssertionError(f"greedy tokens differ from the plain step where it has no tie: gaps {first_gaps.tolist()}")
    return {"rows": seq.shape[1], "rows_identical": int((~rows).sum()), "rows_split_at_a_tie": int(rows.sum()),
            "tie": AE_TIE}


def run_ae(K, dev, smi: str) -> dict:
    """The text AE at the reference width: the train CLI at
    ``--steps_per_dispatch`` 1 and 10 with language eval, its validation's
    step-kernel launches against the count its loop implies, the greedy
    tokens and the fused NLL of a val batch against the plain step, the
    train step's time, rate, device time by kernel and peak memory, the
    10-step loop without a host sync; then convert_ae and an arch1 run from
    the converted file."""
    from novel_vqa_torch.core.checkpoint import load_npz, lstm_params_to_flat
    from novel_vqa_torch.core.h5 import H5Reader
    from novel_vqa_torch.data.corpus import CorpusLoader
    from novel_vqa_torch.models.seq import autoencoder as ae
    from novel_vqa_torch.train import convert_ae, train_text_ae, train_vqa_arch1

    out = {"card": smi, "vocab": AE_V, "width": AE_E, "batch": AE_BATCH, "iters": AE_ITERS, "runs": {}}
    val_batches = ae_eval_batches(AE_N_VAL, AE_BATCH, train_text_ae.AETrainConfig.val_sentences_use)
    # per val batch: apply_nll (T encoder + T+1 decoder steps) and encode +
    # sample (T encoder steps, START + T greedy steps), one layer
    per_val_batch = (AE_T + (AE_T + 1)) + (AE_T + (AE_T + 1))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        h5, meta = write_corpus(os.path.join(tmp, "corpus"), np.random.RandomState(SEED + 6), AE_V,
                                {"train": AE_N_TRAIN, "val": AE_N_VAL, "test": AE_N_VAL})
        out["setup_s"] = time.perf_counter() - t0
        for spd in (1, 10):
            ckpt = os.path.join(tmp, f"ae_{spd}")
            K.lstm_seq.launches = K.lstm_step.launches = 0
            t0 = time.perf_counter()
            train_text_ae.main(["--input_h5", h5, "--input_json", meta, "--checkpoint_path", ckpt,
                                "--rnn_size", str(AE_E), "--input_encoding_size", str(AE_E),
                                "--batch_size", str(AE_BATCH),
                                "--max_iters", str(AE_ITERS), "--steps_per_dispatch", str(spd),
                                "--save_checkpoint_every", "10", "--losses_log_every", "5",
                                "--sample_print", "2", "--language_eval", "1", "--device", dev.type])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            evals = ae_evals(AE_ITERS, spd, 10)
            expected = {"lstm_seq": 0, "lstm_step": evals * val_batches * per_val_batch}
            launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches}
            if launches != expected:
                raise AssertionError(f"train_text_ae spd={spd}: launches {launches}, expected {expected}")
            with open(os.path.join(ckpt, "model_id.json")) as f:
                log = json.load(f)
            losses = list(log["loss_history"].values()) + list(log["val_loss_history"].values())
            if len(log["val_loss_history"]) != evals or not np.isfinite(losses).all():
                raise AssertionError(f"train_text_ae spd={spd}: losses {log['loss_history']}, "
                                     f"{log['val_loss_history']}")
            out["runs"][f"spd{spd}"] = {"wall_s": wall, "launches": launches, "evals": evals,
                                        "val_batches_per_eval": val_batches,
                                        "loss_history": log["loss_history"],
                                        "val_loss_history": log["val_loss_history"]}
        out["launches_val"] = out["runs"]["spd1"]["launches"]["lstm_step"]

        # the train step, its device time and memory; a val batch against
        # the plain step
        cfg = ae.AEConfig(vocab_size=AE_V, input_encoding_size=AE_E, rnn_size=AE_E, seq_length=AE_T)
        params = ae.init_params(cfg, torch.Generator().manual_seed(SEED + 6), dev)
        tx = train_text_ae.make_tx(train_text_ae.AETrainConfig())
        opt_state = tx.init(params)
        loader = CorpusLoader(h5, meta)
        train_rows = torch.from_numpy(loader.split_rows("train")).to(dev)
        val_seq = torch.from_numpy(loader.get_batch("val", AE_BATCH)[0]).to(dev)
        loader.close()
        seq = train_rows[:AE_BATCH].t().contiguous()
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)

        def step():
            return train_text_ae.train_step(cfg, tx, params, opt_state, seq, gen)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step()
        torch.cuda.synchronize()
        out["train_step_peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["train_step_ms"] = time_ms(step, reps=10, warmup=1)
        out["text_ae_train_throughput"] = AE_BATCH / (out["train_step_ms"] / 1e3)
        out["text_ae_train_throughput_unit"] = "sentences/s"
        out["train_step_profile"] = profile(step, top=10)
        out["train_step_device_idle_share"] = 1 - out["train_step_profile"]["device_ms_total"] / out["train_step_ms"]
        offset = torch.zeros((), dtype=torch.int64, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, _, losses = train_text_ae.train_steps_scan(
                cfg, tx, params, opt_state, train_rows, offset, 10, AE_BATCH, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"train_steps_scan losses {losses.tolist()}")
        out["scan10_sync_free"] = True
        out["scan10_losses"] = losses.tolist()

        out["greedy_vs_plain"] = greedy_agreement(K, params, cfg, val_seq)
        got = train_text_ae.val_nll(cfg, params, val_seq)
        with mock.patch.object(K, "lstm_step", K.lstm_step_plain):
            ref = train_text_ae.val_nll(cfg, params, val_seq)
        out["val_nll_vs_plain"] = {"kernel": float(got), "plain": float(ref), "abs_err": abs(float(got - ref))}
        if not torch.allclose(got, ref, **TOL):
            raise AssertionError(f"fused NLL through the step kernel {float(got)} != plain {float(ref)}")

        def val_batch():
            train_text_ae.val_nll(cfg, params, val_seq)
            train_text_ae.greedy_tokens(cfg, params, val_seq)

        out["val_batch_ms"] = time_ms(val_batch, reps=5, warmup=1)
        out["val_batch_profile"] = profile(val_batch, top=6)

        # convert the spd-1 checkpoint; arch1 from the converted file
        npz = os.path.join(tmp, "ae_1", "model_id.npz")
        conv = os.path.join(tmp, "converted.h5")
        convert_ae.main(["--ae_model", npz, "--out", conv, "--device", dev.type])
        flat, _ = load_npz(npz)
        with H5Reader(conv) as f:
            lookup, encoder = f["lookup"], f["encoder"]
        layer = [{p: flat[f"encoder/0/{p}"] for p in ("wx", "bx", "wh", "bh")}]
        if not (np.array_equal(lookup, flat["lookup"].T) and np.array_equal(encoder, lstm_params_to_flat(layer))):
            raise AssertionError("convert_ae: lookup or encoder differs from the checkpoint")
        vqa = os.path.join(tmp, "vqa")
        os.makedirs(vqa)
        write_split(vqa, np.random.RandomState(SEED + 8), {"train": N_TEST_TRAIN, "val": BATCH}, vocab=AE_V)
        ckpt = os.path.join(tmp, "arch1") + "/"
        train_vqa_arch1.main(data_argv(vqa) + ["--init_from", conv, "--input_encoding_size", str(AE_E),
                                               "--rnn_size", str(AE_E), "--rnn_layer", "1",
                                               "--nhimage", str(F), "--num_output", str(O),
                                               "--batch_size", str(BATCH), "--max_iters", "2", "--log_every", "1",
                                               "--checkpoint_path", ckpt, "--device", dev.type])
        emas = loss_emas(ckpt)
        if len(emas) != 2 or not np.isfinite(emas).all():
            raise AssertionError(f"arch1 from the converted AE: loss EMAs {emas}")
        out["convert"] = {"lookup_shape": list(lookup.shape), "encoder_size": int(encoder.size),
                          "arrays_equal_checkpoint": True, "arch1_init_from_loss_ema": emas}
    return out


# --------------------------------------------------------------------------
# phase 13: arch2 at the reference width
# --------------------------------------------------------------------------

def run_arch2(K, dev, smi: str) -> dict:
    """arch2 at the reference width: an arch2 AE trained a few iterations
    on a corpus over the VQA vocabulary, train_vqa_arch2 from it at
    ``--steps_per_dispatch`` 1 and 10, eval_vqa_arch2 on its lstm.h5 in
    both store modes over a split whose row 0 is its longest question and
    whose final short batch is shorter; the step kernel's launches, the
    first batch against the plain step, ms per batch, device time by kernel
    and the device's idle share; the train step's time."""
    from novel_vqa_torch.core.checkpoint import arch2_from_flat, load_flat_h5
    from novel_vqa_torch.core.convert import arch2_params_from_numpy
    from novel_vqa_torch.data.vqa import VQAData
    from novel_vqa_torch.models.vqa import arch2
    from novel_vqa_torch.train import eval_vqa_arch2, train_text_ae, train_vqa_arch2
    from novel_vqa_torch.train.eval_loop import run_full_split

    steps = T + 2  # image, START, T tokens; one layer
    n_batches = -(-N_TEST // BATCH)
    out = {"card": smi, "vocab": V, "width": A2_E, "batch": BATCH, "iters": TRAIN_ITERS, "runs": {}}
    width = ["--input_encoding_size", str(A2_E), "--rnn_size", str(A2_E), "--nhimage", str(F),
             "--num_output", str(O), "--batch_size", str(BATCH)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rs = np.random.RandomState(SEED + 9)
        write_split(tmp, rs, {"train": N_TRAIN, "val": N_VAL, "test": N_TEST}, vocab=V, long_first=True)
        h5, meta = write_corpus(os.path.join(tmp, "corpus"), rs, V,
                                {"train": A2_AE_SENTENCES, "val": AE_BATCH, "test": AE_BATCH})
        out["setup_s"] = time.perf_counter() - t0

        ae_dir = os.path.join(tmp, "ae")
        K.lstm_step.launches = 0
        train_text_ae.main(["--input_h5", h5, "--input_json", meta, "--variant", "arch2",
                            "--checkpoint_path", ae_dir, "--max_iters", str(A2_AE_ITERS),
                            "--val_sentences_use", str(AE_BATCH), "--batch_size", str(AE_BATCH),
                            "--input_encoding_size", str(A2_E), "--rnn_size", str(A2_E),
                            "--device", dev.type])
        # two validations (iterations 0 and the last) of one batch: apply_nll
        # over T+2 encoder and T+1 decoder steps
        expected = 2 * (steps + T + 1)
        if K.lstm_step.launches != expected:
            raise AssertionError(f"arch2 AE: {K.lstm_step.launches} step launches, expected {expected}")
        out["ae_launches_val"] = K.lstm_step.launches

        model = None
        for spd in (1, 10):
            ckpt = os.path.join(tmp, f"arch2_{spd}") + "/"
            K.lstm_seq.launches = K.lstm_step.launches = 0
            t0 = time.perf_counter()
            train_vqa_arch2.main(data_argv(tmp) + width + [
                "--init_from", os.path.join(ae_dir, "model_id.npz"), "--checkpoint_path", ckpt,
                "--max_iters", str(TRAIN_ITERS), "--steps_per_dispatch", str(spd), "--log_every", "10",
                "--device", dev.type])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches}
            # one validation (iteration 0), each val batch through the step kernel
            expected = {"lstm_seq": 0, "lstm_step": steps * -(-N_VAL // BATCH)}
            if launches != expected:
                raise AssertionError(f"train_vqa_arch2 spd={spd}: launches {launches}, expected {expected}")
            emas = loss_emas(ckpt)
            if len(emas) != TRAIN_ITERS // 10 or not np.isfinite(emas).all():
                raise AssertionError(f"train_vqa_arch2 spd={spd}: loss EMAs {emas}")
            out["runs"][f"spd{spd}"] = {"wall_s": wall, "launches": launches, "loss_ema": emas}
            model = model or os.path.join(ckpt, "lstm.h5")

        answers = {}
        for hbm in (1, 0):
            res = os.path.join(tmp, f"result_{hbm}")
            K.lstm_step.launches = 0
            t0 = time.perf_counter()
            eval_vqa_arch2.main(data_argv(tmp) + width + [
                "--model_path", model, "--out_path", res, "--hbm_resident", str(hbm), "--device", dev.type])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if K.lstm_step.launches != steps * n_batches:
                raise AssertionError(f"eval_vqa_arch2 hbm_resident={hbm}: {K.lstm_step.launches} step "
                                     f"launches, expected {steps * n_batches}")
            answers[hbm] = {}
            for name in sorted(os.listdir(res)):
                with open(os.path.join(res, name), "rb") as f:
                    answers[hbm][name] = f.read()
                if len(json.loads(answers[hbm][name])) != N_TEST:
                    raise AssertionError(f"{name}: wrong number of entries")
            out[f"eval_hbm_resident_{hbm}"] = {"wall_s": wall, "lstm_step_launches": K.lstm_step.launches}
        if answers[0] != answers[1] or len(answers[1]) != 2:
            raise AssertionError("eval_vqa_arch2: the two store modes wrote different result JSONs")
        out["store_modes_identical"] = True
        out["launches_eval"] = out["eval_hbm_resident_1"]["lstm_step_launches"]

        data = VQAData(*(os.path.join(tmp, n) for n in ("data_prepro.h5", "data_img.h5", "data_prepro.json")),
                       load_test=True, align="left")
        lengths = (data.d["question_test"] != 0).sum(1)
        if not lengths[0] > lengths[n_batches * BATCH - BATCH:].max():
            raise AssertionError("the test split's row 0 is not longer than its final batch")
        cfg = arch2.Arch2Config(vocab_size=V, input_encoding_size=A2_E, rnn_size=A2_E, nhimage=F,
                                num_output=O, seq_length=T)
        params = arch2_params_from_numpy(arch2_from_flat(load_flat_h5(model), cfg), dev)
        store = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in data.split_store("test").items()}
        qinds = torch.arange(BATCH, device=dev)
        tokens = store["tokens"][qinds]
        image = store["image"][store["img_pos"][qinds].long() - 1]
        with torch.inference_mode():
            got = arch2.apply(params, cfg, tokens, image)
            with mock.patch.object(K, "lstm_step", K.lstm_step_plain):
                ref = arch2.apply(params, cfg, tokens, image)
        out["first_batch_vs_plain"] = {"max_abs_err": float((got - ref).abs().max())}
        check_close("arch2 first batch vs the plain step", (got,), (ref,))
        # the scores behind the JSONs: both store modes run the same batches
        # (the final one padded with the last row), so they agree exactly
        scores = [run_full_split(arch2, cfg, params, data, "test", BATCH, device=dev, hbm_resident=hbm,
                                 want="scores")[2] for hbm in (True, False)]
        out["scores_store_modes_max_abs_diff"] = float(np.abs(scores[0] - scores[1]).max())
        if out["scores_store_modes_max_abs_diff"] != 0.0:
            raise AssertionError(f"arch2 scores differ between store modes by {out['scores_store_modes_max_abs_diff']}")

        def whole_split():
            arch2.eval_predict_scan(cfg, params, store, n_batches, BATCH)

        split_ms = time_ms(whole_split, reps=5, warmup=1)
        out["eval_ms_per_batch_on_card"] = split_ms / n_batches
        out["eval_questions_per_s_on_card"] = N_TEST / (split_ms / 1e3)
        out["batches"] = n_batches
        out["profile_top"] = profile(whole_split)
        out["device_idle_share"] = 1 - out["profile_top"]["device_ms_total"] / split_ms

        # the train step at dropout 0.5 on the train split
        train = VQAData(*(os.path.join(tmp, n) for n in ("data_prepro.h5", "data_img.h5", "data_prepro.json")),
                        align="left")
        tstore = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in train.split_store("train").items()}
        tx = arch2.make_optimizer()
        opt_state = tx.init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        tq = torch.randint(0, N_TRAIN, (BATCH,), generator=gen, device=dev)

        def step():
            arch2.train_step_indexed(cfg, tx, params, opt_state, tstore, tq, gen)

        out["train_step_ms"] = time_ms(step, reps=10, warmup=2)
        out["train_scan10_ms_per_step"] = time_ms(
            lambda: arch2.train_steps_scan(cfg, tx, params, opt_state, tstore, 10, BATCH, gen),
            reps=3, warmup=1) / 10
        out["train_step_profile"] = profile(step, top=8)
    return out


# --------------------------------------------------------------------------
# phase 14: Inception-v3 pool extraction at full width
# --------------------------------------------------------------------------

def run_inception(K, K2, dev, smi: str, probe: dict) -> dict:
    """Inception-v3's 2048-d pool at 299x299, batch 32, He-init weights:
    (a) the pipelined loop on predecoded batches, float32 (TF32 off) and
    bf16: images/s, the forward's ms against its bound, device ms by stage,
    the idle share; (b) the first two images' features against the port's
    CPU fp32 forward; (c) the CLI, ``--model inception``, on synthetic PNGs
    (center square crop, resized to 299), its rows against (a)'s forward on
    the same decoded pixels."""
    from novel_vqa_torch.core.h5 import H5Reader
    from novel_vqa_torch.core.tree import tree_map
    from novel_vqa_torch.data import images as I
    from novel_vqa_torch.models.vision import inception
    from novel_vqa_torch.models.vision.layers import bf16_storage_cast
    from novel_vqa_torch.train import extract_features as X

    t0 = time.perf_counter()
    f32, size, crop, ndims = X.build_model("inception", "", "pool", SEED, device=dev)
    if (size, crop, ndims) != (INC_SIZE, True, 2048):
        raise AssertionError(f"inception route: size {size}, crop {crop}, {ndims} dims")
    forwards = {"float32": f32, "bfloat16": X.Extractor(
        bf16_storage_cast(f32.params), f32.cfg, f32.tap, f32.prepro, ndims, dev)}
    rs = np.random.RandomState(SEED + 30)
    batches = [(rs.randint(0, 256, (EXTRACT_BATCH, INC_SIZE, INC_SIZE, 3), dtype=np.uint8),
                np.zeros(EXTRACT_BATCH, bool), EXTRACT_BATCH) for _ in range(INC_BATCHES)]
    n = EXTRACT_BATCH * INC_BATCHES
    out = {"card": smi, "model": "inception", "tap": "pool", "image_size": size, "batch": EXTRACT_BATCH,
           "batches": INC_BATCHES, "setup_s": time.perf_counter() - t0, "routes": {}}
    flops = inception.forward_flops(f32.cfg) * EXTRACT_BATCH
    cpu = X.Extractor(tree_map(lambda t: t.cpu(), f32.params), f32.cfg, "pool", f32.prepro, ndims,
                      torch.device("cpu"))
    u8_0, miss_0 = (torch.from_numpy(a[:2]) for a in batches[0][:2])
    ref = cpu(u8_0, miss_0)
    for route, fwd in forwards.items():
        K.lstm_seq.launches = K.lstm_step.launches = K2.lstm_seq2.launches = 0
        runs = []
        for _ in range(4):  # the first warms cuDNN's heuristics and the allocator
            got = np.empty((n, ndims), np.float32)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            X.run_pipelined_extraction([(fwd, size, crop, ndims)], [""] * n, EXTRACT_BATCH, 1,
                                       feats=got, depth=4, predecoded=batches)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches,
                    "lstm_seq2": K2.lstm_seq2.launches}
        got_t = torch.from_numpy(got)
        if not bool(torch.isfinite(got_t).all()) or float(got_t.min()) < 0:
            raise AssertionError(f"inception {route}: pool features not finite or negative")
        errs_ = [rel_err(got_t[r], ref[r]) for r in range(2)]
        tol = INC_REL_TOL[route]
        if not max(errs_) <= tol:
            raise AssertionError(f"inception {route}: features off the CPU forward by {errs_} > {tol}")
        loop_ms = statistics.median(runs[1:])
        d_u8, d_miss = (torch.from_numpy(a).to(dev) for a in batches[-1][:2])
        forward_ms = time_ms(lambda: fwd(d_u8, d_miss), reps=10, warmup=2)
        weight_bytes = sum(t.numel() * t.element_size() for t in
                           [u["conv"]["w"] for u in inception.iter_conv_bn(fwd.params)])
        bound_ms, bound_by = bound(flops, d_u8.numel() + weight_bytes + 4 * EXTRACT_BATCH * ndims,
                                   FP32_FLOPS if route == "float32" else BF16_FLOPS)
        prof = stage_profile(lambda: fwd(d_u8, d_miss))
        out["routes"][route] = {
            "images_per_s": n / (loop_ms / 1e3), "loop_ms": loop_ms, "loop_runs_ms": runs,
            "ms_per_batch": loop_ms / INC_BATCHES, "forward_ms_per_batch": forward_ms,
            "bound_ms_per_batch": bound_ms, "bound_by": bound_by, "gflop_per_batch": flops / 1e9,
            "rel_err_vs_cpu_fp32": errs_, "tol": tol, "launches": launches, "profile": prof,
            "device_idle_share": 1 - prof["device_ms_total"] / forward_ms,
        }
    out["cpu_reference"] = "the port's fp32 forward on the CPU, images 0-1, rel per row"

    if not (probe["native"] or probe["pil"]):
        out["cli"] = {"ran": False, "reason": "no decoder on this machine"}
        return out
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "img")
        names = write_images(folder, INC_CLI_IMAGES, np.random.RandomState(SEED + 31), copies=INC_CLI_COPIES)
        with open(os.path.join(tmp, "data_prepro.json"), "w") as f:
            json.dump({"unique_img_test": names}, f)
        store = os.path.join(tmp, "inc.h5")
        t0 = time.perf_counter()
        X.main(["--input_json", os.path.join(tmp, "data_prepro.json"), "--image_root", folder,
                "--seed", str(SEED), "--model", "inception", "--out_name", store, "--device", dev.type])
        wall = time.perf_counter() - t0
        with H5Reader(store) as h5:
            keys, feats = h5.keys(), h5["images_test"]
        if keys != ["images_test"] or feats.shape != (INC_CLI_IMAGES, 2048) or not np.isfinite(feats).all():
            raise AssertionError(f"inception CLI: store {keys} {feats.shape}")
        first = INC_CLI_IMAGES - INC_CLI_COPIES
        if not np.array_equal(feats[first:], feats[:INC_CLI_COPIES]):
            raise AssertionError("inception CLI: identical images gave different rows")
        pool = I.DecodePool(INC_SIZE, center_crop_square=True)
        try:
            decoded = list(pool.iter_batches([os.path.join(folder, n_) for n_ in names], EXTRACT_BATCH))
        finally:
            pool.close()
        rows = [f32(torch.from_numpy(u8).to(dev), torch.from_numpy(m).to(dev))[:real].cpu()
                for u8, m, real in decoded]
        err = rel_err(torch.from_numpy(feats), torch.cat(rows))
        if not err <= INC_REL_TOL["float32"]:
            raise AssertionError(f"inception CLI features off (a)'s forward by {err}")
        out["cli"] = {"ran": True, "decoder": pool.decoder, "images": INC_CLI_IMAGES, "wall_s": wall,
                      "images_per_s_wall": INC_CLI_IMAGES / wall, "rel_err_vs_forward": err}
    return out


# --------------------------------------------------------------------------
# phase 15: the weak-paired CNN+AE trainer at the reference width
# --------------------------------------------------------------------------

def wp_evals(iters: int, every: int) -> int:
    """The validations of one ``train_weakpaired_ae`` run: its cadence."""
    return sum(1 for it in range(iters) if it % every == 0 or it == iters - 1)


def wp_run(dev, h5: str, meta: str, ckpt: str, variant: str, trunk: str, iters: int, finetune_after: int,
           extra=()) -> dict:
    """One ``train_weakpaired_ae`` CLI run at the phase's width; its json
    log, every logged loss finite and one validation per cadence point."""
    from novel_vqa_torch.train import train_weakpaired_ae

    t0 = time.perf_counter()
    train_weakpaired_ae.main(["--input_h5", h5, "--input_json", meta, "--checkpoint_path", ckpt,
                              "--variant", variant, "--cnn_arch", trunk,
                              "--nhimage", "4096" if trunk == "vgg16" else "2048",
                              "--rnn_size", str(WP_E), "--input_encoding_size", str(WP_E),
                              "--batch_size", str(WP_BATCH), "--image_size", str(WP_SIDE),
                              "--crop_size", str(WP_CROP), "--max_iters", str(iters),
                              "--finetune_cnn_after", str(finetune_after),
                              "--save_checkpoint_every", str(WP_EVERY), "--losses_log_every", "1",
                              "--device", dev.type, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(ckpt, "model_id.json")) as f:
        log = json.load(f)
    losses = list(log["loss_history"].values()) + list(log["val_loss_history"].values())
    if (len(log["loss_history"]) != iters or len(log["val_loss_history"]) != wp_evals(iters, WP_EVERY)
            or not np.isfinite(losses).all()):
        raise AssertionError(f"train_weakpaired_ae {variant}/{trunk}: {log['loss_history']}, "
                             f"{log['val_loss_history']}")
    return {"wall_s": wall, "loss_history": log["loss_history"], "val_loss_history": log["val_loss_history"]}


def run_weakpaired(K, dev, smi: str) -> dict:
    """The weak-paired trainer at bench.py's reference width: the mean LSTM
    vector of a random text AE over the phase's corpus (compute_mean_vectors,
    its step launches and its mean against the plain route's); the vqa_arch
    VGG-16 CLI run through both finetune phases, validation's step launches
    against the count its loop implies; each phase's step (CUDA events, its
    device time by kernel, idle share, peak memory) and the trunk in both
    compute dtypes, a validation batch; a short null run on the Inception
    trunk."""
    from novel_vqa_torch.core.checkpoint import save_npz
    from novel_vqa_torch.core.convert import ae_params_to_numpy
    from novel_vqa_torch.core.h5 import H5Reader
    from novel_vqa_torch.data.weakpaired import (
        WeakPairedLoader,
        center_crop_offsets,
        prepro_wp_images,
        random_crop_offsets,
    )
    from novel_vqa_torch.models.seq import autoencoder as ae
    from novel_vqa_torch.train import compute_mean_vectors
    from novel_vqa_torch.train import train_weakpaired_ae as W

    out = {"card": smi, "vocab": WP_V, "width": WP_E, "batch": WP_BATCH, "crop": WP_CROP, "iters": WP_ITERS,
           "finetune_cnn_after": WP_FINETUNE_AFTER}
    val_batches = ae_eval_batches(WP_N_VAL, WP_BATCH, W.WPTrainConfig.val_sentences_use)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rs = np.random.RandomState(SEED + 40)
        h5, meta = write_corpus(os.path.join(tmp, "corpus"), rs, WP_V,
                                {"train": WP_N_TRAIN, "val": WP_N_VAL, "test": WP_N_VAL}, image_side=WP_SIDE)
        out["setup_s"] = time.perf_counter() - t0

        # the mean LSTM sentence vector the vqa_arch run reads, from a text AE
        text_cfg = ae.AEConfig(vocab_size=WP_V, input_encoding_size=WP_E, rnn_size=WP_E, seq_length=T)
        text_ae = os.path.join(tmp, "text_ae.npz")
        save_npz(text_ae, ae_params_to_numpy(ae.init_params(text_cfg, torch.Generator().manual_seed(SEED + 41),
                                                             "cpu")), meta={"cfg": text_cfg._asdict()})
        mean_argv = ["lstm", "--ae_model", text_ae, "--input_h5", h5, "--input_json", meta,
                     "--batch_size", str(MV_BATCH), "--device", dev.type]
        K.lstm_step.launches = 0
        compute_mean_vectors.main(mean_argv + ["--out", os.path.join(tmp, "lstm_mean.h5")])
        torch.cuda.synchronize()
        mv_launches = K.lstm_step.launches
        expected = -(-WP_N_TRAIN // MV_BATCH) * T  # one layer, T steps per batch, the last one wraps
        if mv_launches != expected:
            raise AssertionError(f"compute_mean_vectors: {mv_launches} step launches, expected {expected}")
        with mock.patch.object(K, "lstm_step", K.lstm_step_plain):
            compute_mean_vectors.main(mean_argv + ["--out", os.path.join(tmp, "lstm_mean_plain.h5")])
        with H5Reader(os.path.join(tmp, "lstm_mean.h5")) as f, \
                H5Reader(os.path.join(tmp, "lstm_mean_plain.h5")) as g:
            mean, mean_plain = f["mean_vector"], g["mean_vector"]
        err = float(np.abs(mean - mean_plain).max())
        if mean.shape != (1, 2 * WP_E) or not err <= TOL["atol"]:
            raise AssertionError(f"mean LSTM vector {mean.shape} off the plain route's by {err}")
        out["mean_vectors"] = {"launches": mv_launches, "expected": expected, "batch": MV_BATCH,
                               "sentences": WP_N_TRAIN, "max_abs_err_vs_plain": err}

        # the vqa_arch VGG-16 run through both phases; its validations
        per_val_batch = T + (T + 1)  # encoder, then decoder steps; one layer
        K.lstm_seq.launches = K.lstm_step.launches = 0
        run = wp_run(dev, h5, meta, os.path.join(tmp, "wp"), "vqa_arch", "vgg16", WP_ITERS, WP_FINETUNE_AFTER,
                     ["--lstm_average_path", os.path.join(tmp, "lstm_mean.h5")])
        evals = wp_evals(WP_ITERS, WP_EVERY)
        launches = {"lstm_seq": K.lstm_seq.launches, "lstm_step": K.lstm_step.launches}
        expected = {"lstm_seq": 0, "lstm_step": evals * val_batches * per_val_batch}
        if launches != expected:
            raise AssertionError(f"train_weakpaired_ae: launches {launches}, expected {expected}")
        out["run"] = {**run, "launches": launches, "evals": evals, "val_batches_per_eval": val_batches,
                      "launches_per_val_batch": per_val_batch}
        out["launches_val"] = launches["lstm_step"]

        # each phase's step, the trunk in both dtypes, a validation batch
        loader = WeakPairedLoader(h5, meta)
        labels, images, _ = loader.get_batch_with_images("train", WP_BATCH)
        val_labels, val_images, _ = loader.get_batch_with_images("val", WP_BATCH)
        loader.close()
        cfg = ae.AEConfig(vocab_size=WP_V, input_encoding_size=WP_E, rnn_size=WP_E, seq_length=T,
                          variant="vqa_arch", nhimage=4096)
        ae_params = ae.init_params(cfg, torch.Generator().manual_seed(SEED + 42), dev)
        seq = torch.from_numpy(labels).to(dev)
        u8 = torch.from_numpy(images).to(dev)
        offsets = torch.from_numpy(random_crop_offsets(np.random.default_rng(SEED), WP_BATCH, WP_SIDE,
                                                       WP_CROP)).to(dev)
        zeros = torch.zeros(WP_BATCH, 2 * WP_E, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 42)
        steps, trunk_ms = {}, {}
        for dtype in ("float32", "bfloat16"):
            opt = W.WPTrainConfig(compute_dtype=dtype, rnn_size=WP_E, input_encoding_size=WP_E,
                                  image_size=WP_SIDE, crop_size=WP_CROP, device=dev.type)
            cnn_params, cnn_apply, _ = W.build_cnn(opt, False, torch.Generator().manual_seed(SEED + 43), dev)
            ae_tx, cnn_tx = W.make_ae_tx(opt), W.make_cnn_tx(opt)
            ae_state, cnn_state = ae_tx.init(ae_params), cnn_tx.init(cnn_params)
            step = W.make_train_step(cfg, "vqa_arch", WP_CROP, cnn_apply, ae_tx, cnn_tx)
            for finetune in (False, True):
                def run_step():
                    return step(False, finetune, ae_params, ae_state, cnn_params, cnn_state, u8, offsets, seq,
                                zeros, seq, gen)

                run_step()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                loss = run_step()[4]
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(dev)
                ms = time_ms(run_step, reps=10, warmup=1)
                prof = profile(run_step, top=10)
                steps[f"{dtype}_{'finetune' if finetune else 'frozen'}"] = {
                    "ms": ms, "peak_memory_bytes": peak, "loss": float(loss), "profile": prof,
                    "device_idle_share": 1 - prof["device_ms_total"] / ms}
            x = prepro_wp_images(u8, offsets, WP_CROP)
            with torch.no_grad():
                trunk_ms[dtype] = time_ms(lambda: cnn_apply(cnn_params, x), reps=10, warmup=2)
            if dtype == "float32":
                val_u8 = torch.from_numpy(val_images).to(dev)
                val_seq = torch.from_numpy(val_labels).to(dev)
                val_off = torch.from_numpy(center_crop_offsets(WP_BATCH, WP_SIDE, WP_CROP)).to(dev)

                def val():
                    return W.val_step(cfg, "vqa_arch", WP_CROP, cnn_apply, ae_params, cnn_params, val_u8,
                                      val_off, val_seq)

                got = val()
                with mock.patch.object(K, "lstm_step", K.lstm_step_plain):
                    ref = val()
                if not torch.allclose(got, ref, **TOL):
                    raise AssertionError(f"weak-paired val NLL through the step kernel {float(got)} != "
                                         f"plain {float(ref)}")
                out["val_nll_vs_plain"] = {"kernel": float(got), "plain": float(ref),
                                           "abs_err": abs(float(got - ref))}
                out["val_batch_ms"] = time_ms(val, reps=5, warmup=1)
                out["val_batch_profile"] = profile(val, top=6)
            del cnn_params, cnn_state, step
        out["steps"] = steps
        out["trunk_forward_ms"] = trunk_ms
        out["step_unit"] = f"ms per train step (CUDA events, median of 10), batch {WP_BATCH}"

        # a short null run on the Inception trunk at crop 224
        K.lstm_step.launches = 0
        inc = wp_run(dev, h5, meta, os.path.join(tmp, "wp_inc"), "null", "inception", WP_INC_ITERS,
                     WP_INC_FINETUNE_AFTER)
        expected = wp_evals(WP_INC_ITERS, WP_EVERY) * val_batches * ((T + 2) + (T + 1))
        if K.lstm_step.launches != expected:
            raise AssertionError(f"inception null run: {K.lstm_step.launches} step launches, expected {expected}")
        out["inception_null_run"] = {**inc, "launches": K.lstm_step.launches}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seq2-mutants", action="store_true",
                        help="only show that the seq2 check rejects kernels that round otherwise")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from novel_vqa_torch.kernels import build
    from novel_vqa_torch.kernels import lstm as K
    from novel_vqa_torch.kernels import lstm2 as K2

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = {src: fut.result()[1] for src, fut in
                [(src, pool.submit(build.build, src)) for src in SOURCES]}
    ptxas = {src: ptxas_lines(log) for src, log in logs.items()}
    # the step kernel's variants (16- and 4-byte copies) spill nothing; an
    # empty report means the libraries were built before this run
    step_ptxas = ptxas_report(ptxas["lstm.cu"], "lstm_step_kernel")
    if any(v.get("spill_bytes") != 0 for v in step_ptxas):
        raise AssertionError(f"the step kernel spills: {step_ptxas}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "step_kernel_ptxas": step_ptxas or "not built in this run"})

    if opts.seq2_mutants:
        out = run_seq2_mutants(K2, dev)
        emit({"phase": "seq2_mutants", **out})
        print(nvidia_smi(), flush=True)
        passed = not any(r["failed"] for r in out["kernel"].values())
        rejected = all(m["rejected"] for m in out["mutants"].values())
        emit({"seq2_check": {"kernel_passes": passed, "every_mutant_rejected": rejected}})
        return 0 if passed and rejected else 1

    gen = torch.Generator(device=dev).manual_seed(SEED)
    seq_rows = [seq_case(K, *case, gen, dev) for case in SEQ_CASES]
    step_rows = [step_case(K, *case, gen, dev) for case in STEP_CASES]
    seq2_rows = [seq2_case(K2, *case, gen, dev) for case in SEQ2_CASES]
    for row in seq_rows + step_rows + seq2_rows:
        emit({"phase": "kernel_check", **row})
    emit({"phase": "autograd_refusal", **run_autograd_refusal(K, K2, dev)})

    slice_out = run_slice(K, dev)
    emit({"phase": "slice", **slice_out})
    step_out = run_step_route(K, dev, gen)
    emit({"phase": "step_route", **step_out})
    emit({"phase": "route_agreement", **run_route_agreement(K2, dev)})
    train_out = run_train_slice(K, K2, dev)
    emit({"phase": "train_slice", **train_out})

    probe = decoder_probe()
    emit({"phase": "decoders", "card": smi, **probe})
    extract_out, extract_feats = run_extract(K, K2, dev, smi, probe)
    emit({"phase": "extract", **extract_out})
    emit({"phase": "chain", **run_chain(K, dev, smi, probe, extract_feats)})
    ae_out = run_ae(K, dev, smi)
    emit({"phase": "ae", **ae_out})
    arch2_out = run_arch2(K, dev, smi)
    emit({"phase": "arch2", **arch2_out})
    emit({"phase": "inception", **run_inception(K, K2, dev, smi, probe)})
    wp_out = run_weakpaired(K, dev, smi)
    emit({"phase": "weakpaired", **wp_out})

    def entry(name, rows, launches, replaces, source=SOURCE):
        timed = [r for r in rows if "kernel_ms" in r]
        main = [r for r in timed if r["main"]]
        out = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # one launch at each main-path shape (for seq and step, In = 200
            # and 512), summed
            "ms": sum(r["kernel_ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": main[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in main),
        }
        for key in ("device_ms", "plain_device_ms", "library_device_ms"):
            if key in main[0]:
                out[key] = sum(r[key] for r in main)
        out["shapes"] = [{k: r[k] for k in ("N", "In", "H", "mask", "keep", "kernel_ms", "plain_ms", "bound_ms",
                                            "library_ms", "device_ms", "plain_device_ms", "library_device_ms",
                                            "launch", "steps_skipped") if k in r}
                         for r in timed]
        return out

    kernels = [
        entry("lstm_seq", seq_rows, slice_out["launches"]["lstm_seq"], SEQ_REPLACES),
        entry("lstm_step", step_rows, step_out["launches"]["lstm_step"], STEP_REPLACES),
        entry("lstm_seq2", seq2_rows, train_out["runs"]["fused2_spd1"]["launches"]["lstm_seq2"],
              SEQ2_REPLACES, SEQ2_SOURCE),
    ]
    kernels[2]["replay_err_ratio"] = max(max(r["replay_err_ratio"].values()) for r in seq2_rows)
    # the step kernel's launches on the later slices' paths: one arch2 eval
    # run (18 per batch), one AE training run's validations, one weak-paired
    # run's validations (33 per batch) and one compute_mean_vectors run
    kernels[1]["launches_arch2_eval"] = arch2_out["launches_eval"]
    kernels[1]["launches_ae_val"] = ae_out["launches_val"]
    kernels[1]["launches_wp_val"] = wp_out["launches_val"]
    kernels[1]["launches_mean_vectors"] = wp_out["mean_vectors"]["launches"]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
