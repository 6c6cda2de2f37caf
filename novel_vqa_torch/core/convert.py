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


def _leaf_from_hwio(device):
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
        return torch.tensor(np.ascontiguousarray(a), device=device)

    return leaf


def _leaf_to_hwio(t: torch.Tensor) -> np.ndarray:
    a = _to_numpy(t)
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) if a.ndim == 4 else a


def vision_params_from_numpy(tree: Any, device) -> Any:
    """JAX vision params (VGG, Inception, or the weak-paired trainer's
    ``cnn`` tree and its optimizer states) as numpy arrays -> the port's
    tensors on ``device``: every 4-D leaf is a conv weight, HWIO in the JAX
    package and OIHW in the port; float leaves become float32, others (an
    optimizer's step count) keep their dtype."""
    return tree_map(_leaf_from_hwio(device), tree)


def vision_params_to_numpy(params: Any) -> Any:
    """Inverse of :func:`vision_params_from_numpy`: HWIO convs."""
    return tree_map(_leaf_to_hwio, params)


vgg_params_from_numpy = inception_params_from_numpy = vision_params_from_numpy
vgg_params_to_numpy = inception_params_to_numpy = vision_params_to_numpy
