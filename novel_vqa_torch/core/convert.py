"""Weights carried between the JAX package and the port.

Both packages keep params as nested dicts (lists for LSTM layers and VGG
convs) in the same layout, linear weights stored (in, out), so the
conversion is a leaf-wise copy: numpy arrays (``jax.device_get(params)`` on
the JAX side, or a ``.npz`` read with ``core.checkpoint.load_npz`` /
``unflatten_like``) to float32 tensors on a device, and back.  The one
change of layout: VGG conv weights are HWIO in the JAX package and OIHW in
the port, transposed here once, at load.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.tree import tree_map


def _to_tensor(device):
    device = resolve_device(device)
    # a copy: the source may be a read-only view of a JAX buffer
    return lambda a: torch.tensor(np.asarray(a, np.float32), device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """JAX params (arch1, arch2 or an autoencoder's) as numpy arrays -> the
    port's dict of float32 tensors on ``device``: the layouts are the same."""
    return tree_map(_to_tensor(device), tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy`."""
    return tree_map(_to_numpy, params)


arch1_params_from_numpy = arch2_params_from_numpy = ae_params_from_numpy = params_from_numpy
arch1_params_to_numpy = arch2_params_to_numpy = ae_params_to_numpy = params_to_numpy


def lstm_params_from_numpy(
    layers: Sequence[Dict[str, np.ndarray]], device
) -> List[Dict[str, torch.Tensor]]:
    """A list of JAX LSTM layer dicts ({wx, bx, wh, bh}) -> tensors."""
    return tree_map(_to_tensor(device), list(layers))


def lstm_params_to_numpy(
    layers: Sequence[Dict[str, torch.Tensor]]
) -> List[Dict[str, np.ndarray]]:
    return tree_map(_to_numpy, list(layers))


def vgg_params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """JAX VGG params (HWIO convs, (in, out) linears) as numpy arrays -> the
    port's tree of float32 tensors on ``device`` (OIHW convs)."""
    to_t = _to_tensor(device)
    out = {k: tree_map(to_t, v) for k, v in tree.items() if k != "conv"}
    out["conv"] = [{"w": to_t(np.transpose(c["w"], (3, 2, 0, 1))), "b": to_t(c["b"])}  # HWIO -> OIHW
                   for c in tree["conv"]]
    return out


def vgg_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`vgg_params_from_numpy`: HWIO convs, float32."""
    out = {k: tree_map(_to_numpy, v) for k, v in params.items() if k != "conv"}
    out["conv"] = [{"w": np.ascontiguousarray(np.transpose(_to_numpy(c["w"]), (2, 3, 1, 0))),
                    "b": _to_numpy(c["b"])} for c in params["conv"]]
    return out
