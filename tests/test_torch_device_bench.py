"""The port's device-time layer (``novel_vqa_torch/core/device_bench.py``).

The Chrome-trace parser is pinned against a synthetic trace shaped like
``torch.profiler``'s export (kernel events on the device with their stream,
host ops and runtime calls beside them, a copy and a user annotation on the
device); the live path runs on the CPU, whose trace has no device plane, as
tests/test_device_bench.py's CPU smoke test."""

import gzip
import json

import pytest
import torch

from novel_vqa_torch.core import device_bench as db


def _kernel(name, dur, stream=7, device=0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": device, "tid": stream,
            "ts": 0, "dur": dur, "args": {"device": device, "stream": stream,
                                          "grid": [256, 1, 1], "block": [128, 1, 1]}}


def _synthetic_trace(n_exec=3, dur_us=150.0):
    events = [
        {"ph": "M", "name": "process_name", "pid": 4242, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "args": {"labels": "GPU 0"}},
        # host-side events that must NOT be counted
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242,
         "ts": 0, "dur": 1e9},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
         "tid": 4242, "ts": 0, "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "vgg.block1", "pid": 4242,
         "tid": 4242, "ts": 0, "dur": 1e6},
        # device-side events that are not kernels
        {"ph": "X", "cat": "gpu_user_annotation", "name": "vgg.block1", "pid": 0,
         "tid": 7, "ts": 0, "dur": 1e6, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "pid": 0, "tid": 7, "ts": 0, "dur": 40.0, "args": {"device": 0, "stream": 7}},
        # a flow arrow between a launch and its kernel
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 0, "id": 1},
    ]
    events += [_kernel("lstm_seq_kernel", dur_us) for _ in range(n_exec)]
    events.append(_kernel("ampere_sgemm_128x64_nn", 10.0, stream=13))
    return {"schemaVersion": 1, "traceEvents": events}


def test_parse_trace_events_counts_kernels_only():
    s = db.parse_trace_events(_synthetic_trace(n_exec=4, dur_us=250.0))
    assert s.has_device_plane and s.device_plane == "cuda:0"
    st = s.module("lstm_seq")
    assert (st.count, st.total_us) == (4, pytest.approx(1000.0))
    # the host ops, runtime calls, annotations and the copy are excluded
    assert s.total().total_us == pytest.approx(1010.0)
    assert s.total().count == 5
    assert s.module("aten::") is None and s.module("Memcpy") is None


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_parse_trace_dir_and_ops_roundtrip(tmp_path, gz):
    d = tmp_path / "nested"
    d.mkdir()
    if gz:
        with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
            json.dump(_synthetic_trace(n_exec=2), f)
    else:
        (d / "trace.json").write_text(json.dumps(_synthetic_trace(n_exec=2)))
    assert db.parse_trace_dir(str(tmp_path)).module("lstm_seq").count == 2
    ops = db.parse_trace_ops(str(tmp_path))
    # grouped by stream; the copy rides on its stream, no host op appears
    assert sorted(ops) == ["cuda:0 stream 13", "cuda:0 stream 7"]
    assert sorted(ops["cuda:0 stream 7"]) == ["Memcpy HtoD (Pinned -> Device)", "lstm_seq_kernel"]
    assert ops["cuda:0 stream 7"]["lstm_seq_kernel"].count == 2
    assert ops["cuda:0 stream 13"]["ampere_sgemm_128x64_nn"].total_us == pytest.approx(10.0)


def test_parse_trace_dir_empty(tmp_path):
    s = db.parse_trace_dir(str(tmp_path))
    assert not s.has_device_plane and s.total().count == 0
    assert db.parse_trace_ops(str(tmp_path)) == {}


def test_measure_device_time_on_the_cpu_has_no_device_plane(tmp_path):
    """A real torch.profiler trace of a CPU run: wall time, the calls
    counted, no device plane (tests/test_device_bench.py:123)."""
    x = torch.ones(64, 64)
    timing = db.measure_device_time(lambda: x @ x, 3, trace_dir=str(tmp_path))
    assert timing.wall_s > 0 and timing.n_calls == 3
    assert (tmp_path / "trace.json").exists()
    assert not timing.summary.has_device_plane
    assert timing.module_seconds("") == (None, 0)


def test_peak_flops_by_name():
    assert db.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert db.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert db.peak_flops("NVIDIA GeForce RTX 4090") is None
    assert db.peak_flops("cpu") is None
    with pytest.raises(ValueError):
        db.peak_flops("NVIDIA H100 80GB HBM3", "float16")
    if not torch.cuda.is_available():
        assert db.peak_flops() is None  # no card: unknown, not the CPU's


def test_bound_takes_the_larger_time():
    ms, by = db.bound(67e9, 1.0)  # 1 ms of fp32 operations, ~0 bytes
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = db.bound(1.0, 3.35e9)  # 1 ms of bytes
    assert (ms, by) == (pytest.approx(1.0), "bytes")
