"""The two LSTM kernels: plain versions, wrappers and launch counts.

``lstm_seq`` replaces ``novel_vqa_tpu/ops/pallas_lstm.py::_seq_kernel`` (one
masked layer over all T steps) and ``lstm_step`` replaces
``_fused_step_kernel`` (one fused cell step); both CUDA kernels are in
``csrc/lstm.cu``.  Each wrapper runs its plain PyTorch version when the
tensor it is given lies on the CPU, and on a CUDA tensor launches its kernel
or raises: there is no fallback.  Each wrapper counts its launches in a
plain integer attribute (``lstm_seq.launches``), so a run can show that its
path went through the kernel.

The seq kernel is bound by its fp32 FMA products (67 TFLOP/s on an H100).
It runs a thread-block cluster of 4 CTAs per tile of rows, the CTAs
splitting the gate columns and exchanging each step's h through
distributed shared memory.  The launch picks the fewest rows per tile
whose clusters the card holds at once, so 500 rows run in one wave on
100 SMs (one block per 16-row tile used 32).  It skips the products of a
step on which no row of its tile is active.  :func:`lstm_seq_launch_info`
reports its launch at a shape, with the clusters the card holds at once.

The step kernel is bound by its fp32 FMA products too.  A CTA computes a
tile of batch rows by 32 hidden units, all four gates of each, so the cell
runs in its epilogue; inputs and weights pass through shared memory in a
ring of ``cp.async`` stages, and each thread keeps its rows x 2 units x 4
gates in registers.  The launch takes 64-row tiles (8 rows per thread),
or 32-row tiles (4 per thread) when the 64-row grid would not give the
card's SMs more than one CTA each: at N=500, H=512, 256 CTAs of 32 rows in
one wave.  :func:`lstm_step_launch_info` reports its launch at a shape,
with the CTAs an SM holds at once.

``lstm_seq_backward`` is the reverse scan of the seq kernel's gradient,
the JAX package's ``_seq_bwd`` (pallas_lstm.py:279-374, an XLA scan
there): from the gate pre-activations it rebuilds c and carries (dh, dc)
from the last step to the first, giving the gate derivatives, in one
launch per layer (``csrc/lstm.cu``'s seq backward kernel, a cluster kernel
as the seq kernel; its plain version issues some 30 small operations a
step).  :func:`lstm_seq_backward_launch_info` reports its launch.

The kernels' outputs carry no ``grad_fn``.  So on a CUDA tensor each
wrapper raises when grad mode is on and an input requires grad, rather
than hand a training graph outputs that would cut it (:func:`refuse_grad`).
Training reaches these kernels only through an autograd Function whose
backward is written out: ``ops/lstm_vjp.FusedSeq``
(``NOVEL_VQA_SEQ_TRAIN=1``, its backward through ``lstm_seq_backward``), as
``ops/lstm2.Fused2`` does the seq2 kernel.

Both take ``b = bx + bh`` (the Pallas kernels' convention) and weights
stored (in, 4H), gate order i, f, o, g.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from novel_vqa_torch.kernels.build import library

SOURCE = "lstm.cu"


def gate_activations(gates: torch.Tensor):
    """Gate pre-activations (..., 4H) -> the activated i, f, o, g (..., H)."""
    H = gates.shape[-1] // 4
    i = torch.sigmoid(gates[..., 0 * H : 1 * H])
    f = torch.sigmoid(gates[..., 1 * H : 2 * H])
    o = torch.sigmoid(gates[..., 2 * H : 3 * H])
    g = torch.tanh(gates[..., 3 * H : 4 * H])
    return i, f, o, g


def cell(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused-gate cell: gate pre-activations (N, 4H) and c -> (c', h')."""
    i, f, o, g = gate_activations(gates)
    c_new = f * c + i * g
    return c_new, o * torch.tanh(c_new)


def lstm_step_plain(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell step (ops/lstm.py:106-122 of the JAX package):
    returns (c', h')."""
    return cell(x @ wx + h @ wh + b, c)


def lstm_seq_plain(xs, mask, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One masked layer over all T steps from a zero state
    (``_xla_seq_reference``, pallas_lstm.py:244-266): xs (T, N, In), mask
    (T, N); returns the final (c, h) and the (T, N, H) post-mask hidden
    sequence."""
    T, N, _ = xs.shape
    H = wh.shape[0]
    c = xs.new_zeros(N, H)
    h = xs.new_zeros(N, H)
    hs = []
    for t in range(T):
        c_new, h_new = cell(xs[t] @ wx + h @ wh + b, c)
        m = mask[t][:, None] > 0
        c = torch.where(m, c_new, c)
        h = torch.where(m, h_new, h)
        hs.append(h)
    return c, h, torch.stack(hs)


def check(name: str, t: torch.Tensor, shape, device: torch.device,
          dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}; this CUDA kernel takes {dtype} here")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel's outputs would enter an autograd graph: the CUDA
    kernels write through raw pointers, so their outputs carry no
    ``grad_fn`` and every gradient behind them would be lost silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad under grad mode, but the CUDA "
            "kernel computes a forward only and its outputs would cut the "
            "graph; call it under torch.no_grad()/inference_mode(), or train "
            "through a route with a backward (ops/lstm.py): NOVEL_VQA_SEQ_TRAIN=1 "
            "(ops/lstm_vjp.FusedSeq) or NOVEL_VQA_FUSED2=1 (ops/lstm2.Fused2)"
        )


def raise_on(lib, err: int, what: str) -> None:
    """Raise on a failed launch; a shape whose staged rows need more shared
    memory than the card offers fails here, at ``cudaFuncSetAttribute``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.nvqa_cuda_error_string(err).decode()}")


def lstm_seq(xs, mask, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seq kernel wrapper: (c, h, hs) of one masked layer, as
    :func:`lstm_seq_plain`."""
    if xs.device.type == "cpu":
        return lstm_seq_plain(xs, mask, wx, wh, b)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {xs.device}")
    refuse_grad("lstm_seq", xs, mask, wx, wh, b)
    T, N, In = xs.shape
    H = wh.shape[0]
    if T < 1 or N < 1:
        raise ValueError(f"lstm_seq: empty input of shape {tuple(xs.shape)}")
    dev = xs.device
    for name, t, shape in (
        ("xs", xs, (T, N, In)), ("mask", mask, (T, N)), ("wx", wx, (In, 4 * H)),
        ("wh", wh, (H, 4 * H)), ("b", b, (4 * H,)),
    ):
        check(name, t, shape, dev)
    lib = library(SOURCE)
    c = torch.empty(N, H, device=dev)
    h = torch.empty(N, H, device=dev)
    hs = torch.empty(T, N, H, device=dev)
    with torch.cuda.device(dev):
        err = lib.nvqa_lstm_seq_forward(
            xs.data_ptr(), mask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            b.data_ptr(), c.data_ptr(), h.data_ptr(), hs.data_ptr(),
            T, N, In, H, torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, err, f"lstm_seq launch (T={T}, N={N}, In={In}, H={H})")
    lstm_seq.launches += 1
    return c, h, hs


lstm_seq.launches = 0

LAUNCH_INFO_KEYS = ("cluster_ctas", "rows_per_cluster", "ctas", "max_active_clusters",
                    "threads", "smem_bytes")
STEP_LAUNCH_INFO_KEYS = ("rows_per_cta", "units_per_cta", "rows_per_thread", "ctas", "threads",
                         "smem_bytes", "stages", "k_per_stage", "ctas_per_sm", "sms", "copy_bytes")


def launch_info(lib, kernel: str, N: int, In: int, H: int, device=None,
                keys=LAUNCH_INFO_KEYS) -> dict:
    """A kernel's launch at (N, In, H) on a card, from the C entry point
    ``nvqa_<kernel>_launch_info`` of ``lib``, launching nothing, as a dict
    of ``keys``.  For the cluster kernels (the default keys): CTAs per
    cluster, rows per cluster, CTAs in the grid, the clusters the card can
    hold at once (``cudaOccupancyMaxActiveClusters``), threads and dynamic
    shared memory per CTA; ``clusters`` is the grid's count."""
    info = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        err = getattr(lib, f"nvqa_{kernel}_launch_info")(N, In, H, ctypes.addressof(info))
    raise_on(lib, err, f"{kernel} launch info (N={N}, In={In}, H={H})")
    out = dict(zip(keys, info))
    if "cluster_ctas" in out:
        out["clusters"] = out["ctas"] // out["cluster_ctas"]
    return out


def lstm_seq_launch_info(N: int, In: int, H: int, device=None) -> dict:
    """The seq kernel's launch at (N, In, H), as :func:`launch_info`."""
    return launch_info(library(SOURCE), "lstm_seq", N, In, H, device)


def lstm_seq_backward_plain(gates, mask, wh, dhs, dh_fin, dc_fin) -> torch.Tensor:
    """The reverse half of ``_seq_bwd`` (pallas_lstm.py:279-374) for one
    masked layer from a zero state: the gate pre-activations (T, N, 4H),
    the mask (T, N), ``wh`` (H, 4H), the cotangents of the hidden sequence
    (T, N, H) and of the final (h, c) -> the gate derivatives (T, N, 4H).
    An elementwise forward scan rebuilds c, then a reverse scan carries
    (dh, dc) with one (N, 4H) x (4H, H) product a step."""
    T = gates.shape[0]
    m = mask[..., None]  # (T, N, 1)
    i, f, o, g = gate_activations(gates)
    # the pre-mask candidates c_new and the post-mask c_{t-1}
    c = torch.zeros_like(i[0])
    c_new_seq, c_prev_seq = [], []
    for t in range(T):
        c_new = f[t] * c + i[t] * g[t]
        c_new_seq.append(c_new)
        c_prev_seq.append(c)
        c = torch.where(m[t] > 0, c_new, c)
    c_prev = torch.stack(c_prev_seq)
    tanh_c = torch.tanh(torch.stack(c_new_seq))
    # the reverse scan
    wh_t = wh.t()
    dh_c, dc_c = dh_fin, dc_fin
    dgates = [None] * T
    for t in reversed(range(T)):
        dh_t = dhs[t] + dh_c
        dc_t = dc_c
        dh_new = m[t] * dh_t
        dc_new = m[t] * dc_t + dh_new * o[t] * (1.0 - tanh_c[t] * tanh_c[t])
        do = dh_new * tanh_c[t]
        di = dc_new * g[t]
        df = dc_new * c_prev[t]
        dg = dc_new * i[t]
        dgates[t] = torch.cat(
            [di * i[t] * (1.0 - i[t]), df * f[t] * (1.0 - f[t]),
             do * o[t] * (1.0 - o[t]), dg * (1.0 - g[t] * g[t])], dim=-1)
        dc_c = dc_new * f[t] + (1.0 - m[t]) * dc_t
        dh_c = dgates[t] @ wh_t + (1.0 - m[t]) * dh_t
    return torch.stack(dgates)


def lstm_seq_backward(gates, mask, wh, dhs, dh_fin, dc_fin) -> torch.Tensor:
    """Seq backward kernel wrapper: the gate derivatives of
    :func:`lstm_seq_backward_plain`.  On a card they are written over
    ``gates``, which is returned: the caller's pre-activations are
    consumed.  Every device checks the shapes and contiguity; the kernel
    takes f32 and H a multiple of 128, at most 2048."""
    if gates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_seq_backward: unsupported device {gates.device}")
    if gates.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"lstm_seq_backward: gates {tuple(gates.shape)}, wh {tuple(wh.shape)}")
    T, N, _ = gates.shape
    H = wh.shape[0]
    if T < 1 or N < 1:
        raise ValueError(f"lstm_seq_backward: empty input of shape {tuple(gates.shape)}")
    dev = gates.device
    for name, t, shape in (
        ("gates", gates, (T, N, 4 * H)), ("mask", mask, (T, N)), ("wh", wh, (H, 4 * H)),
        ("dhs", dhs, (T, N, H)), ("dh_fin", dh_fin, (N, H)), ("dc_fin", dc_fin, (N, H)),
    ):
        check(name, t, shape, dev, gates.dtype if dev.type == "cpu" else torch.float32)
    if dev.type == "cpu":
        return lstm_seq_backward_plain(gates, mask, wh, dhs, dh_fin, dc_fin)
    refuse_grad("lstm_seq_backward", gates, mask, wh, dhs, dh_fin, dc_fin)
    if H % 128 or H > 2048:
        raise ValueError(f"lstm_seq_backward: H={H}; the kernel takes a multiple of 128, at most 2048")
    lib = library(SOURCE)
    wh_t = wh.t().contiguous()
    c_seq = torch.empty(T, N, H, device=dev)
    with torch.cuda.device(dev):
        err = lib.nvqa_lstm_seq_backward(
            gates.data_ptr(), mask.data_ptr(), wh_t.data_ptr(), dhs.data_ptr(),
            dh_fin.data_ptr(), dc_fin.data_ptr(), c_seq.data_ptr(), T, N, H,
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, err, f"lstm_seq_backward launch (T={T}, N={N}, H={H})")
    lstm_seq_backward.launches += 1
    return gates


lstm_seq_backward.launches = 0


def lstm_seq_backward_launch_info(N: int, H: int, device=None) -> dict:
    """The seq backward kernel's launch at (N, H), as :func:`launch_info`."""
    return launch_info(library(SOURCE), "lstm_seq_backward", N, 0, H, device)


def lstm_step(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step kernel wrapper: (c', h') of one cell step, as
    :func:`lstm_step_plain`."""
    if x.device.type == "cpu":
        return lstm_step_plain(x, h, c, wx, wh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step: unsupported device {x.device}")
    refuse_grad("lstm_step", x, h, c, wx, wh, b)
    N, In = x.shape
    H = wh.shape[0]
    if N < 1:
        raise ValueError("lstm_step: empty batch")
    dev = x.device
    for name, t, shape in (
        ("x", x, (N, In)), ("h", h, (N, H)), ("c", c, (N, H)),
        ("wx", wx, (In, 4 * H)), ("wh", wh, (H, 4 * H)), ("b", b, (4 * H,)),
    ):
        check(name, t, shape, dev)
    lib = library(SOURCE)
    c_out = torch.empty(N, H, device=dev)
    h_out = torch.empty(N, H, device=dev)
    with torch.cuda.device(dev):
        err = lib.nvqa_lstm_step_forward(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
            wh.data_ptr(), b.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
            N, In, H, torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, err, f"lstm_step launch (N={N}, In={In}, H={H})")
    lstm_step.launches += 1
    return c_out, h_out


lstm_step.launches = 0


def lstm_step_launch_info(N: int, In: int, H: int, device=None) -> dict:
    """The step kernel's launch at (N, In, H) for operands from PyTorch's
    allocator, launching nothing: rows and hidden units per CTA, batch rows
    per thread, CTAs in the grid, threads, dynamic shared memory, pipeline
    stages and k per stage, the CTAs an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the card's SMs and
    the bytes of each ``cp.async`` copy (16, or 4 when In or H is not a
    multiple of 4)."""
    return launch_info(library(SOURCE), "lstm_step", N, In, H, device, STEP_LAUNCH_INFO_KEYS)
