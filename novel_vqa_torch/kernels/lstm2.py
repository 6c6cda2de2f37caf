"""The fused two-layer LSTM kernel: plain version, wrapper and launch count.

``lstm_seq2`` replaces ``novel_vqa_tpu/ops/pallas_lstm2.py::_seq2_kernel``:
both layers of a 2-layer masked LSTM over all T steps from a zero state,
layer 2 fed ``bf16(f32(bf16(h1)) * f32(drop[t]))``, the inter-layer dropout
multiplier.  Storage is bf16 (inputs, weights, biases, the saved states
``hs1``/``hs2``), products are bf16 x bf16 summed in f32 and the carries
stay f32, as in the Pallas kernel.  The CUDA kernel is in ``csrc/lstm2.cu``:
like the seq kernel, a thread-block cluster of 4 CTAs per tile of rows that
split the gate columns of both layers and exchange bf16(h1), the layer-2
input and bf16(h2) through distributed shared memory, the layers run as the
Pallas kernel's wavefront (layer-2 step t-1 beside layer-1 step t), steps no
row of a tile takes skipped per layer; its products run on the bf16 tensor
cores (``mma.sync``, f32 accumulate) from weights the wrapper packs in
fragment order (:func:`pack_weights`), so its f32 sums run in another order
than the plain version's; :func:`lstm_seq2_launch_info` reports its launch
at a shape.

As in ``kernels/lstm.py``: the wrapper runs the plain version when the
tensor it is given lies on the CPU, and on a CUDA tensor launches the
kernel or raises; it counts launches in ``lstm_seq2.launches``; and since
the kernel computes a forward only, it refuses inputs that require grad
under grad mode.  Training reaches it through ``ops/lstm2.Fused2``, whose
backward is written out.

Arguments: xs (T, N, In), drop (T, N, H), wx1 (In, 4H), wh1, wx2, wh2
(H, 4H), b1, b2 (4H,) all bf16 (``b = bx + bh`` rounded to bf16), mask
(T, N) float32; gate order i, f, o, g.  Returns c1, h1, c2, h2 (N, H)
float32 and hs1, hs2 (T, N, H) bf16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from novel_vqa_torch.kernels.build import library
from novel_vqa_torch.kernels.lstm import cell, check, launch_info, raise_on, refuse_grad

SOURCE = "lstm2.cu"

Seq2Out = Tuple[torch.Tensor, ...]


def lstm_seq2_plain(xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2, saved=None) -> Seq2Out:
    """``_seq2_kernel``'s arithmetic (pallas_lstm2.py:69-119) in PyTorch,
    layer-2 step t right after layer-1 step t (the same numbers as the
    Pallas kernel's wavefront): every product takes bf16-exact operands in
    float32, so it is exact and only the order of the sums differs.

    ``saved=(hs1, hs2)`` replays another run step by step: each step takes
    its bf16 operands (bf16(h1) into Wh1 and into the layer-2 input,
    bf16(h2) into Wh2) from those saved states rather than its own, the
    operands the backward recomputes its gates from (``ops/lstm2.py``)."""
    f32, bf = torch.float32, torch.bfloat16
    T, N, _ = xs.shape
    H = wh1.shape[0]
    wx1, wh1, wx2, wh2 = (w.to(f32) for w in (wx1, wh1, wx2, wh2))
    b1, b2 = b1.to(f32), b2.to(f32)
    c1 = h1 = c2 = h2 = torch.zeros(N, H, dtype=f32, device=xs.device)
    h1b = h2b = torch.zeros(N, H, dtype=bf, device=xs.device)
    hs1, hs2 = [], []
    for t in range(T):
        m = mask[t][:, None] > 0
        c_new, h_new = cell(xs[t].to(f32) @ wx1 + h1b.to(f32) @ wh1 + b1, c1)
        c1 = torch.where(m, c_new, c1)
        h1 = torch.where(m, h_new, h1)
        hs1.append(h1.to(bf))
        h1b = hs1[-1] if saved is None else saved[0][t]
        d = (h1b.to(f32) * drop[t].to(f32)).to(bf)
        c_new, h_new = cell(d.to(f32) @ wx2 + h2b.to(f32) @ wh2 + b2, c2)
        c2 = torch.where(m, c_new, c2)
        h2 = torch.where(m, h_new, h2)
        hs2.append(h2.to(bf))
        h2b = hs2[-1] if saved is None else saved[1][t]
    return c1, h1, c2, h2, torch.stack(hs1), torch.stack(hs2)


# The kernel replayed by the plain version from its own saved states
# (``saved=``) agrees step by step: a last-bit difference in an f32 sum may
# flip a bf16 rounding of h, but the replay takes the flipped value as its
# operand, so no flip is carried forward.  So the f32 finals agree within
# REPLAY_ATOL, the fp32 kernels' tolerance, and each saved bf16 state within
# one bf16 ulp of the replay's plus HS_ATOL (an f32 difference of the sums,
# which exceeds the ulp of values near zero).  A kernel that left out any of
# the bf16 roundings of h1, d or h2 fails them (``chip_smoke.py
# --seq2-mutants`` builds such kernels and shows it on the card).
REPLAY_ATOL = 1e-5
HS_ATOL = 1e-6
OUT_NAMES = ("c1", "h1", "c2", "h2", "hs1", "hs2")


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |ref| (8 significant bits)."""
    mag = ref.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def replay_errors(args, got: Seq2Out) -> Dict[str, float]:
    """Each output of a seq2 run ``got`` on inputs ``args`` against the
    plain version replayed from ``got``'s saved states, as a multiple of its
    tolerance above: every value at most 1 passes."""
    ref = lstm_seq2_plain(*args, saved=got[4:])
    out = {}
    for name, a, b in zip(OUT_NAMES, got, ref):
        err = (a.float() - b.float()).abs()
        if name.startswith("hs"):
            out[name] = float((err / (bf16_ulp(b) + HS_ATOL)).max())
        else:
            out[name] = float(err.max()) / REPLAY_ATOL
    return out


class Seq2Dims(NamedTuple):
    """The layout of the seq2 kernel's packed weights at (In, H)."""

    C: int  # CTAs per cluster
    U: int  # units per CTA, ceil(H / C)
    G: int  # groups of 8 units per CTA, one warp's
    KX: int  # In padded to 16
    KH: int  # H padded to 16


@functools.lru_cache(maxsize=None)
def lstm_seq2_dims(In: int, H: int) -> Seq2Dims:
    """The kernel's own :class:`Seq2Dims` at (In, H)
    (``nvqa_lstm_seq2_dims``), the layout :func:`pack_weights` writes for
    it."""
    lib = library(SOURCE)
    dims = (ctypes.c_int * 5)()
    raise_on(lib, lib.nvqa_lstm_seq2_dims(In, H, ctypes.addressof(dims)), "lstm_seq2 dims")
    return Seq2Dims(*dims)


def pack_weights(wx1, wh1, wx2, wh2, dims: Seq2Dims) -> torch.Tensor:
    """Both layers' weights (wx1 (In, 4H), wh1, wx2, wh2 (H, 4H)) as the
    seq2 kernel's mma A fragments at the layout ``dims``, in one tensor laid
    out (CTA q, unit group, k-chunk of 16, m tile, lane, 8).  The k-chunks
    of a group are layer 1's ``[Wx1; Wh1]`` and then layer 2's ``[Wx2;
    Wh2]``, each matrix padded to a multiple of 16 rows of k (KX, KH); a
    group holds 8 units of CTA q (q * U + u, u < U, padded to 8 G); the
    padding is zeros.  M tile 0 holds gates i and f of the group's 8 units
    (m rows 0-7, 8-15), m tile 1 o and g; lane l = 4 gr + tr holds A rows
    gr and gr + 8 at k 2 tr, 2 tr + 1 and 2 tr + 8, 2 tr + 9 of the chunk,
    in the order of the m16n8k16 A fragment's registers (element 4 kh + 2
    mh + kl is m = gr + 8 mh, k = 2 tr + kl + 8 kh)."""
    H = wh1.shape[0]
    C, U, G, KX, KH = dims

    def part(w, k_pad):  # (k_pad, 4, C, 8 G)
        k = w.shape[0]
        w = w.reshape(k, 4, H)
        if C * U != H:
            w = torch.nn.functional.pad(w, (0, C * U - H))
        w = w.reshape(k, 4, C, U)
        if 8 * G != U or k_pad != k:
            w = torch.nn.functional.pad(w, (0, 8 * G - U, 0, 0, 0, 0, 0, k_pad - k))
        return w

    w = torch.cat([part(wx1, KX), part(wh1, KH), part(wx2, KH), part(wh2, KH)])
    # (chunk, kh, tr, kl, m tile, mh, q, group, gr) -> (q, group, chunk, m
    # tile, gr, tr, kh, mh, kl)
    w = w.reshape(-1, 2, 4, 2, 2, 2, C, G, 8)
    return w.permute(6, 7, 0, 4, 8, 2, 1, 5, 3).contiguous()


def lstm_seq2(xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2) -> Seq2Out:
    """Seq2 kernel wrapper: (c1, h1, c2, h2, hs1, hs2), as
    :func:`lstm_seq2_plain`."""
    if xs.device.type == "cpu":
        return lstm_seq2_plain(xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_seq2: unsupported device {xs.device}")
    refuse_grad("lstm_seq2", xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2)
    T, N, In = xs.shape
    H = wh1.shape[0]
    if T < 1 or N < 1:
        raise ValueError(f"lstm_seq2: empty input of shape {tuple(xs.shape)}")
    dev, bf = xs.device, torch.bfloat16
    for name, t, shape, dtype in (
        ("xs", xs, (T, N, In), bf), ("mask", mask, (T, N), torch.float32),
        ("drop", drop, (T, N, H), bf), ("wx1", wx1, (In, 4 * H), bf),
        ("wh1", wh1, (H, 4 * H), bf), ("b1", b1, (4 * H,), bf),
        ("wx2", wx2, (H, 4 * H), bf), ("wh2", wh2, (H, 4 * H), bf),
        ("b2", b2, (4 * H,), bf),
    ):
        check(name, t, shape, dev, dtype)
    lib = library(SOURCE)
    w = pack_weights(wx1, wh1, wx2, wh2, lstm_seq2_dims(In, H))
    finals = [torch.empty(N, H, device=dev) for _ in range(4)]
    hs1 = torch.empty(T, N, H, device=dev, dtype=bf)
    hs2 = torch.empty(T, N, H, device=dev, dtype=bf)
    with torch.cuda.device(dev):
        err = lib.nvqa_lstm_seq2_forward(
            *(t.data_ptr() for t in (xs, mask, drop, w, b1, b2)),
            *(t.data_ptr() for t in finals), hs1.data_ptr(), hs2.data_ptr(),
            T, N, In, H, torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, err, f"lstm_seq2 launch (T={T}, N={N}, In={In}, H={H})")
    lstm_seq2.launches += 1
    return (*finals, hs1, hs2)


lstm_seq2.launches = 0


def lstm_seq2_launch_info(N: int, In: int, H: int, device=None) -> dict:
    """The seq2 kernel's launch at (N, In, H), as
    :func:`novel_vqa_torch.kernels.lstm.launch_info`."""
    return launch_info(library(SOURCE), "lstm_seq2", N, In, H, device)
