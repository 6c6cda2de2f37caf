"""Weights carried between the JAX package and the port.

Both packages keep params as nested dicts (lists for LSTM layers) in the
same layout, weights stored (in, out), so the conversion is a leaf-wise
copy: numpy arrays (``jax.device_get(params)`` on the JAX side) to float32
tensors on a device, and back.
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


def arch1_params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """JAX arch1 params as numpy arrays -> the port's dict of tensors."""
    return tree_map(_to_tensor(device), tree)


def arch1_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`arch1_params_from_numpy`."""
    return tree_map(_to_numpy, params)


def lstm_params_from_numpy(
    layers: Sequence[Dict[str, np.ndarray]], device
) -> List[Dict[str, torch.Tensor]]:
    """A list of JAX LSTM layer dicts ({wx, bx, wh, bh}) -> tensors."""
    return tree_map(_to_tensor(device), list(layers))


def lstm_params_to_numpy(
    layers: Sequence[Dict[str, torch.Tensor]]
) -> List[Dict[str, np.ndarray]]:
    return tree_map(_to_numpy, list(layers))
