"""The trainers' ``--profile_dir`` and ``--debug_nans`` (port of
``novel_vqa_tpu.core.profiling``'s ``trace`` and ``nan_guard``):
``torch.profiler`` in place of ``jax.profiler``,
``torch.autograd.detect_anomaly`` in place of ``jax_debug_nans``."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(out_dir: str, device: torch.device):
    """A ``torch.profiler`` trace of the enclosed block, written to
    ``<out_dir>/trace.json``; nothing when ``out_dir`` is empty."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


@contextlib.contextmanager
def nan_guard(on: bool):
    """Autograd's anomaly detection around the block when ``on``: a NaN in
    a backward raises, naming the forward op that made it."""
    with torch.autograd.detect_anomaly() if on else contextlib.nullcontext():
        yield
