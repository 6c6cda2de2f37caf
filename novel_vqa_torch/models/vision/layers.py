"""Vision building blocks for VGG and Inception-v3: conv, max- and
average-pool, inference-mode batch norm and linear, in NCHW with OIHW conv
weights (the port's counterpart of ``novel_vqa_tpu.models.vision.layers``,
which is NHWC/HWIO).

The convolutions and linears are cuDNN's and cuBLAS's (``F.conv2d``,
``torch.matmul``): the JAX package leaves them to XLA outside any Pallas
kernel.  ``core/convert.py`` carries HWIO weights in as OIHW once, at load;
linears keep the JAX layout, ``(in, out)``.

One dtype policy for every layer (``raw_conv``, ``linear``):
  * the input follows the weight dtype;
  * f32 weights give an f32 result, with an f32 sum: on a card that needs
    TF32 off, which ``fp32_exact`` turns off for the block it scopes;
  * bf16 convs give a bf16 result (cuDNN sums in f32 and rounds the output);
  * ``linear`` returns f32 even with bf16 weights (the JAX package's
    ``preferred_element_type=float32``, ``ops/precision.dot_f32``), and
    its bias adds in f32;
  * batch norm's units stay f32 under ``bf16_storage_cast``, so a bf16
    conv's output leaves ``batch_norm`` as f32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from novel_vqa_torch.ops.precision import dot_f32


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN convolutions and for matmuls inside the block, the
    caller's settings restored after it.  A float32 product on the card
    otherwise may round its operands to TF32 (cuDNN's default), which keeps
    about three decimal digits."""
    matmul = torch.backends.cuda.matmul
    old = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """He-style init for random benchmarks: (c_out, c_in, kh, kw) weights;
    real weights come from converted caffemodels (``train/import_caffe.py``).
    The draws differ from ``jax.random``'s."""
    std = (2.0 / (kh * kw * c_in)) ** 0.5
    w = torch.randn(c_out, c_in, kh, kw, generator=gen) * std
    return {"w": w.to(device), "b": torch.zeros(c_out, device=device)}


def linear_init(gen: torch.Generator, n_in: int, n_out: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    std = (2.0 / n_in) ** 0.5
    w = torch.randn(n_in, n_out, generator=gen) * std
    return {"w": w.to(device), "b": torch.zeros(n_out, device=device)}


def _same_pad(kh: int, kw: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding as a symmetric pad.  Every SAME window of VGG
    and Inception is odd and runs at stride 1, where XLA pads k // 2 on each
    side; any other would need an asymmetric pad, which no net here has."""
    if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME padding of a {kh}x{kw} window at stride {stride} is not symmetric")
    return kh // 2, kw // 2


def raw_conv(w: torch.Tensor, x: torch.Tensor, b: torch.Tensor | None = None,
             stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """NCHW conv at ``stride`` with XLA's ``"SAME"`` or ``"VALID"`` padding,
    under the dtype policy of the module docstring, with the optional bias
    ``b`` (in the weight dtype)."""
    pad = _same_pad(w.shape[2], w.shape[3], stride) if padding == "SAME" else 0
    return F.conv2d(x.to(w.dtype), w, b, stride=stride, padding=pad)


def conv2d(params: Dict[str, torch.Tensor], x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    y = raw_conv(params["w"], x, params["b"])
    # the conv's output is fresh and its backward reads only x and w
    return F.relu(y, inplace=True) if relu else y


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max-pool, as the JAX package's ``max_pool``."""
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: int, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Average pool dividing by the window's count of real inputs (the JAX
    package's ``avg_pool`` sums a window of ones over the same padding):
    ``count_include_pad=False``."""
    pad = _same_pad(window, window, stride) if padding == "SAME" else 0
    return F.avg_pool2d(x, window, stride, padding=pad, count_include_pad=False)


def bn_init(c: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(c, device=device), "offset": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def batch_norm(params: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Inference-mode batch norm over NCHW's channels with folded running
    stats (the reference Inception t7 always runs in evaluate mode), in the
    JAX package's order of operations."""
    def ch(t):
        return t.view(1, -1, 1, 1)

    inv = torch.rsqrt(params["var"] + eps)
    return (x - ch(params["mean"])) * ch(inv) * ch(params["scale"]) + ch(params["offset"])


def conv_bn(conv_p: Dict[str, torch.Tensor], bn_p: Dict[str, torch.Tensor], x: torch.Tensor,
            stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """conv (no bias: BN holds the shift) -> BN -> ReLU."""
    y = batch_norm(bn_p, raw_conv(conv_p["w"], x, conv_p.get("b"), stride, padding))
    # BN's output is fresh and the add that made it saves nothing
    return F.relu(y, inplace=True)


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    w = params["w"]
    y = dot_f32(x.to(w.dtype), w) + params["b"].float()
    return F.relu(y, inplace=True) if relu else y


def bf16_storage_cast(params: Any) -> Any:
    """Conv and linear weights cast to bf16 storage (a new tree; the
    layers then cast their inputs to bf16, so activations are stored bf16).
    BatchNorm units ({scale, offset, mean, var}) stay f32."""
    if isinstance(params, dict):
        if set(params) == {"scale", "offset", "mean", "var"}:
            return params
        return {k: bf16_storage_cast(v) for k, v in params.items()}
    if isinstance(params, list):
        return [bf16_storage_cast(v) for v in params]
    return params.to(torch.bfloat16)
