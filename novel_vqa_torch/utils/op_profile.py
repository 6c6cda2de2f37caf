"""Kernel-level device profile of a training or extraction workload (port
of ``novel_vqa_tpu.utils.op_profile``).

Runs a workload under ``torch.profiler`` and prints the per-step device
time and the top kernels by total time, per stream: the tool behind the
PERF.md step breakdowns.

Usage (on the card; ``--device cpu`` for a dry run, which has no device
plane and prints host ops and wall time instead):
  python -m novel_vqa_torch.utils.op_profile --workload arch1 \\
      [--batch_size 500] [--scan_steps 25] [--chunks 2] [--top 40]

Workloads: ``arch1`` (the multi-step train loop at the reference width,
``arch1.train_steps_scan``; ``NOVEL_VQA_FUSED2=1`` takes the seq2 kernel,
as the trainer does), ``text_ae`` (the AE pretraining loop), ``inception``
/ ``vgg16`` (the extraction forward).
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch


def _log(*a):
    print(*a, file=sys.stderr)


def build_arch1(batch_size: int, scan_steps: int, device):
    """The bench's train loop: arch1 at the reference width over a
    resident split of 200,000 questions and 20,000 images."""
    from novel_vqa_torch.models.vqa import arch1

    cfg = arch1.Arch1Config(vocab_size=12782)
    params = arch1.init_params(cfg, torch.Generator().manual_seed(123), device)
    tx = arch1.make_optimizer()
    opt_state = tx.init(params)
    n_questions, n_images = 200_000, 20_000
    rs = np.random.RandomState(0)
    lengths = rs.randint(3, 17, size=n_questions)
    cols = np.arange(16)[None, :]
    tokens_h = np.where(
        cols >= (16 - lengths[:, None]),
        rs.randint(1, cfg.vocab_size, size=(n_questions, 16)),
        0,
    ).astype(np.int64)
    image_h = rs.randn(n_images, cfg.nhimage).astype(np.float32)
    image_h /= np.linalg.norm(image_h, axis=1, keepdims=True)
    data = {
        "tokens": torch.from_numpy(tokens_h).to(device),
        "image": torch.from_numpy(image_h).to(device),
        "img_pos": torch.from_numpy(rs.randint(1, n_images + 1, size=n_questions)).to(device),
        "answers": torch.from_numpy(rs.randint(1, 1001, size=n_questions)).to(device),
    }
    state = [params, opt_state]
    generator = torch.Generator(device=device).manual_seed(0)

    def step_fn():
        state[0], state[1], losses = arch1.train_steps_scan(
            cfg, tx, state[0], state[1], data, scan_steps, batch_size, generator,
        )
        return losses

    return step_fn


def build_text_ae(batch_size: int, scan_steps: int, device):
    """The AE pretraining loop at the reference width (vocab 20,000,
    E = H = 512) over a resident corpus of 50,000 sentences."""
    from novel_vqa_torch.models.seq import autoencoder as ae
    from novel_vqa_torch.train.train_text_ae import AETrainConfig, make_tx, train_steps_scan

    cfg = ae.AEConfig(vocab_size=20000, input_encoding_size=512, rnn_size=512, num_layers=1,
                      seq_length=16, variant="text_nostart")
    tx = make_tx(AETrainConfig())
    params = ae.init_params(cfg, torch.Generator().manual_seed(123), device)
    rs = np.random.RandomState(0)
    lengths = rs.randint(3, 17, size=50_000)
    cols = np.arange(16)[None, :]
    rows = np.where(cols < lengths[:, None], rs.randint(1, 20001, size=(50_000, 16)), 0)
    train_rows = torch.from_numpy(rows.astype(np.int64)).to(device)
    state = [params, tx.init(params), torch.zeros((), dtype=torch.int64, device=device)]
    generator = torch.Generator(device=device).manual_seed(0)

    def step_fn():
        state[0], state[1], state[2], losses = train_steps_scan(
            cfg, tx, state[0], state[1], train_rows, state[2], scan_steps, batch_size, generator,
        )
        return losses

    return step_fn


def build_extraction(model: str, batch_size: int, compute_dtype: str, device):
    """One extraction forward (VGG-16 fc7 or Inception-v3's pool) on a
    batch of random pixels, random seeded weights."""
    from novel_vqa_torch.train.extract_features import build_model

    forward, size, _, _ = build_model(
        model, "", "fc7" if model.startswith("vgg") else "pool", 123,
        compute_dtype=compute_dtype, device=device,
    )
    rs = np.random.RandomState(0)
    u8 = torch.from_numpy(rs.randint(0, 256, size=(batch_size, size, size, 3), dtype=np.uint8))
    u8 = u8.to(device)
    missing = torch.zeros(batch_size, dtype=torch.bool, device=device)

    def step_fn():
        return forward(u8, missing)

    return step_fn


def profile_workload(workload: str = "arch1", batch_size: int = 0, scan_steps: int = 25,
                     chunks: int = 2, top: int = 40, compute_dtype: str = "float32",
                     trace_dir: str = "", device: str | torch.device = "cuda") -> dict:
    """Warm the workload up, trace ``chunks`` calls of it and return
    ``{"workload", "batch_size", "steps", "per_step_us", "device_plane",
    "streams": {stream: [{"name", "us_per_step", "count"}, ...]}}``, the top
    ``top`` kernels per stream.  Without a device plane (a CPU run)
    ``per_step_us`` is the wall clock's and ``streams`` holds host ops."""
    from novel_vqa_torch.core import device_bench as db
    from novel_vqa_torch.core.device import resolve_device

    device = resolve_device(device)
    if workload == "arch1":
        bs = batch_size or 500
        fn = build_arch1(bs, scan_steps, device)
        denom = chunks * scan_steps
    elif workload == "text_ae":
        bs = batch_size or 1000
        fn = build_text_ae(bs, scan_steps, device)
        denom = chunks * scan_steps
    elif workload in ("vgg16", "inception"):
        bs = batch_size or 32
        fn = build_extraction(workload, bs, compute_dtype, device)
        denom = chunks
    else:
        raise ValueError(f"unknown --workload {workload}")

    _log("warm-up…")
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="nvqa_opprof_")
    _log(f"tracing {chunks} calls into {trace_dir} …")
    timing = db.measure_device_time(fn, chunks, trace_dir=trace_dir)
    plane = timing.summary.has_device_plane
    total_us = timing.summary.total().total_us if plane else timing.wall_s * 1e6
    streams = {}
    for stream, table in sorted(db.parse_trace_ops(trace_dir, host=not plane).items()):
        rows = sorted(table.values(), key=lambda s: -s.total_us)[:top]
        streams[stream] = [{"name": st.name, "us_per_step": st.total_us / denom, "count": st.count}
                           for st in rows]
    return {"workload": workload, "batch_size": bs, "steps": denom,
            "per_step_us": total_us / max(1, denom), "device_plane": timing.summary.device_plane,
            "kernels_per_step": timing.summary.total().count / max(1, denom),
            "streams": streams}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="arch1",
                    choices=["arch1", "text_ae", "vgg16", "inception"])
    ap.add_argument("--batch_size", type=int, default=0)
    ap.add_argument("--scan_steps", type=int, default=25)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--trace_dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = profile_workload(args.workload, args.batch_size, args.scan_steps, args.chunks,
                           args.top, args.compute_dtype, args.trace_dir, args.device)
    what = f"({rec['workload']}, bs={rec['batch_size']})"
    if rec["device_plane"]:
        print(f"# per-step device time: {rec['per_step_us']:.1f} us  {what} on "
              f"{rec['device_plane']}, {rec['kernels_per_step']:g} kernels per step")
    else:
        print(f"# per-step wall time: {rec['per_step_us']:.1f} us  {what}; no device plane "
              "(a CPU run): host ops below")
    for stream, rows in rec["streams"].items():
        total = sum(r["us_per_step"] for r in rows)
        print(f"\n== {stream}  ({len(rows)} ops shown, {total:.1f} us/step)")
        for r in rows:
            print(f"  {r['us_per_step']:10.1f} us/step  x{r['count']:<6d} {r['name'][:110]}")


if __name__ == "__main__":
    main()
