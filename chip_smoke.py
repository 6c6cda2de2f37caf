#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: nvcc builds every kernel source of the port into build/;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the eval path's shapes and at odd shapes (atol/rtol 1e-5),
     with its time, its plain version's time, one PyTorch library call's
     time as a yardstick, and its bound on an H100 SXM;
  4. slice: arch1 test-split inference through the eval CLI at the
     reference width (vocab 12782, E=200, 2x512 LSTM, 4096-d fc7, common
     1024, 1000 answers, T=16, batch 500) on a synthetic split with random
     seeded weights, in both store modes; the seq kernel's launch count,
     identical result JSONs, and the scores of the first batches against a
     forward through the plain LSTM;
  5. step route: ``lstm_encode(return_sequence=True)`` at the same width,
     which steps cell by cell through the step kernel, against the plain
     step.
Then a line with nvidia-smi's name and power limit, one JSON line listing
every kernel, and as the last line ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without a card it exits non-zero at
once.  Imports torch, numpy, the standard library and the port only.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = 1e-4
SEED = 1234
REPS = 20

SOURCE = "novel_vqa_torch/csrc/lstm.cu"  # both kernels
SEQ_REPLACES = "novel_vqa_tpu/ops/pallas_lstm.py:173 (_seq_kernel)"
STEP_REPLACES = "novel_vqa_tpu/ops/pallas_lstm.py:40 (_fused_step_kernel)"

# the reference width (EvalConfig defaults, 002_train_baseline.lua:33-38)
V, E, H, L, F, C, O, T, BATCH = 12782, 200, 512, 2, 4096, 1024, 1000, 16, 500
N_TEST, N_IMG, N_MC = 4950, 2000, 18


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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    return (torch.arange(T_, device=dev)[:, None] >= (T_ - lengths)[None, :]).float()


def uniform(gen, dev, *shape, scale=1.0):
    return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale


def seq_case(K, N, In, H_, gen, dev, timed):
    xs = uniform(gen, dev, T, N, In)
    mask = ragged_mask(T, N, gen, dev)
    wx, wh = uniform(gen, dev, In, 4 * H_, scale=0.08), uniform(gen, dev, H_, 4 * H_, scale=0.08)
    b = uniform(gen, dev, 4 * H_, scale=0.16)
    got = K.lstm_seq(xs, mask, wx, wh, b)
    torch.cuda.synchronize()
    ref = K.lstm_seq_plain(xs, mask, wx, wh, b)
    check_close(f"lstm_seq N={N} In={In} H={H_}", got, ref)
    row = {"kernel": "lstm_seq", "N": N, "T": T, "In": In, "H": H_, "max_abs_err": max_err(got, ref),
           "errs": errs(("c", "h", "hs"), got, ref)}
    if timed:
        active = float(mask.sum())
        flops = 2.0 * (In + H_) * 4 * H_ * active
        nbytes = 4.0 * (xs.numel() + mask.numel() + wx.numel() + wh.numel() + b.numel()
                        + 2 * N * H_ + T * N * H_)
        lstm = torch.nn.LSTM(In, H_).to(dev)
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


def step_case(K, N, In, H_, gen, dev, timed):
    x, h, c = uniform(gen, dev, N, In), uniform(gen, dev, N, H_), uniform(gen, dev, N, H_)
    wx, wh = uniform(gen, dev, In, 4 * H_, scale=0.08), uniform(gen, dev, H_, 4 * H_, scale=0.08)
    b = uniform(gen, dev, 4 * H_, scale=0.16)
    got = K.lstm_step(x, h, c, wx, wh, b)
    torch.cuda.synchronize()
    ref = K.lstm_step_plain(x, h, c, wx, wh, b)
    check_close(f"lstm_step N={N} In={In} H={H_}", got, ref)
    row = {"kernel": "lstm_step", "N": N, "In": In, "H": H_, "max_abs_err": max_err(got, ref),
           "errs": errs(("c", "h"), got, ref)}
    if timed:
        flops = 2.0 * N * (In + H_) * 4 * H_
        nbytes = 4.0 * (x.numel() + 2 * h.numel() + wx.numel() + wh.numel() + b.numel() + 2 * N * H_)
        w_ih, w_hh, b_hh = wx.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
        row.update(
            kernel_ms=time_ms(lambda: K.lstm_step(x, h, c, wx, wh, b)),
            plain_ms=time_ms(lambda: K.lstm_step_plain(x, h, c, wx, wh, b)),
            library_ms=time_ms(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)),
            library="torch.lstm_cell (fp32)",
        )
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    return row


# --------------------------------------------------------------------------
# phase 4: the slice at the reference width
# --------------------------------------------------------------------------

def write_split(tmp: str, rs: np.random.RandomState) -> None:
    """A synthetic test split in the data_prepro.{h5,json} / data_img.h5
    schema (000_prepro_vqa.py:273-293), test keys only."""
    from novel_vqa_torch.core.h5 import write_h5

    # question lengths around the VQA mean of ~6 words, capped at T
    lengths = np.clip(rs.poisson(5.2, N_TEST) + 1, 1, T).astype(np.uint32)
    ques = np.zeros((N_TEST, T), np.uint32)
    for i, n in enumerate(lengths):
        ques[i, :n] = rs.randint(1, V + 1, size=n)
    mc = np.stack([rs.choice(O, N_MC, replace=False) + 1 for _ in range(N_TEST)]).astype(np.uint32)
    mc[::97, N_MC // 2:] = 0  # some rows with fewer choices
    mc[5] = 0  # a row with none: MC falls back to the OE answer
    write_h5(os.path.join(tmp, "data_prepro.h5"), {
        "ques_test": ques,
        "ques_length_test": lengths,
        "question_id_test": np.arange(N_TEST, dtype=np.uint32) * 10 + 7,
        "img_pos_test": rs.randint(1, N_IMG + 1, size=N_TEST).astype(np.uint32),
        "MC_ans_test": mc,
    })
    # fc7 features are post-ReLU: non-negative
    fc7 = np.maximum(rs.randn(N_IMG, F), 0).astype(np.float32)
    write_h5(os.path.join(tmp, "data_img.h5"), {"images_test": fc7})
    meta = {
        "ix_to_word": {str(i): f"w{i}" for i in range(1, V + 1)},
        "ix_to_ans": {str(i): f"a{i}" for i in range(1, O + 1)},
        "unique_img_test": [f"im{i}.jpg" for i in range(N_IMG)],
    }
    with open(os.path.join(tmp, "data_prepro.json"), "w") as f:
        json.dump(meta, f)


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
        write_split(tmp, np.random.RandomState(SEED))
        cfg = arch1.Arch1Config(vocab_size=V, input_encoding_size=E, rnn_size=H, rnn_layer=L,
                                nhimage=F, common_embedding_size=C, num_output=O)
        params = arch1.init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
        model = os.path.join(tmp, "lstm.h5")
        save_flat_h5(model, arch1_to_flat(arch1_params_to_numpy(params)))
        out["setup_s"] = time.perf_counter() - t0

        answers = {}
        for hbm in (1, 0):
            res = os.path.join(tmp, f"result_{hbm}")
            argv = ["--input_img_h5", os.path.join(tmp, "data_img.h5"),
                    "--input_ques_h5", os.path.join(tmp, "data_prepro.h5"),
                    "--input_json", os.path.join(tmp, "data_prepro.json"),
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
    return out


def profile(fn, top: int = 8):
    """Device time by kernel name over one call, from torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in events)
    events.sort(key=lambda e: -e.device_time_total)
    return {"device_ms_total": total / 1e3,
            "top": [{"name": e.key[:80], "ms": e.device_time_total / 1e3, "count": e.count}
                    for e in events[:top]]}


# --------------------------------------------------------------------------
# phase 5: the per-step route through the step kernel
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from novel_vqa_torch.kernels import build
    from novel_vqa_torch.kernels import lstm as K

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
    _, log = build.build("lstm.cu")  # the port's one source
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the main path's shapes, then odd ones: ragged row and unit tiles, and
    # (H=600) more hidden units than threads in a seq-kernel block
    odd = ((13, 24, 40), (13, 24, 600))
    seq_rows = [seq_case(K, BATCH, In, H, gen, dev, timed=True) for In in (E, H)]
    seq_rows += [seq_case(K, *shape, gen, dev, timed=False) for shape in odd]
    step_rows = [step_case(K, BATCH, In, H, gen, dev, timed=True) for In in (E, H)]
    step_rows += [step_case(K, *shape, gen, dev, timed=False) for shape in odd]
    for row in seq_rows + step_rows:
        emit({"phase": "kernel_check", **row})

    slice_out = run_slice(K, dev)
    emit({"phase": "slice", **slice_out})
    step_out = run_step_route(K, dev, gen)
    emit({"phase": "step_route", **step_out})

    def entry(name, rows, launches, replaces):
        timed = [r for r in rows if "kernel_ms" in r]
        return {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # one launch at each main-path shape (In = 200 and 512), summed
            "ms": sum(r["kernel_ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": timed[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in timed),
            "shapes": [{k: r[k] for k in ("N", "In", "H", "kernel_ms", "plain_ms", "bound_ms", "library_ms")}
                       for r in timed],
        }

    kernels = [
        entry("lstm_seq", seq_rows, slice_out["launches"]["lstm_seq"], SEQ_REPLACES),
        entry("lstm_step", step_rows, step_out["launches"]["lstm_step"], STEP_REPLACES),
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
