"""Checkpoint formats: Torch flat-vector (``getParameters()``) interop,
native npz files and AE transfer dumps.

Copy of ``novel_vqa_tpu.core.checkpoint`` without its orbax backend, so the
same files load into both packages:
  * ``lstm.h5`` ({encoder_w_q, embedding_w_q, multimodal_w}, as saved by
    002_train_vqa_arch1/002_train_baseline.lua:419-420);
  * npz files keyed by tree path (``lstm.npz``, ``train_state.npz``),
    NamedTuple fields by name, so optimizer states cross as well;
  * arch2's ``lstm.h5`` ({cnn_w, encoder_w_q, multimodal_w},
    003_train_vqa_arch2/003_train_ae_based.lua:406);
  * converted-AE transfer h5 files ({lookup^T, encoder, [multimodal]},
    002_convert_text_model_arch1_as_h5.lua:39-42).
The h5 files go through the port's own reader and writer (``core/h5.py``).

Layout conventions:
  * ``nn.Linear(in, out)`` stores ``weight`` as (out, in) row-major followed
    by ``bias`` (out,); params here store the transpose (in, out), so flat
    export writes ``w.T`` flattened;
  * each LSTM layer contributes [i2h.weight, i2h.bias, h2h.weight, h2h.bias]
    (LSTM_encoder.lua:32-33), layers in order; gate order [i, f, o, g].
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from novel_vqa_torch.core.h5 import H5Reader, write_h5


# ---------------------------------------------------------------------------
# trees <-> npz
# ---------------------------------------------------------------------------

def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_tree(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        # NamedTuple (optimizer states): key by field name
        for name, v in zip(tree._fields, tree):
            out.update(_flatten_tree(v, f"{prefix}{name}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_tree(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_npz(path: str, tree: Any, meta: Dict[str, Any] | None = None) -> None:
    flat = _flatten_tree(tree)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Returns (flat dict keyed by path, meta)."""
    with np.load(path) as f:
        data = dict(f)
    meta = {}
    if "__meta__" in data:
        meta = json.loads(bytes(data.pop("__meta__").tobytes()).decode())
    return data, meta


def unflatten_like(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    """The tree of ``template``'s structure with its leaves read from
    ``flat`` (numpy arrays)."""
    if isinstance(template, dict):
        return {k: unflatten_like(template[k], flat, f"{prefix}{k}/") for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            unflatten_like(v, flat, f"{prefix}{name}/")
            for name, v in zip(template._fields, template)
        ))
    if isinstance(template, (list, tuple)):
        return type(template)(
            unflatten_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)
        )
    return flat[prefix.rstrip("/")]


# ---------------------------------------------------------------------------
# flat-vector (Torch getParameters) interop
# ---------------------------------------------------------------------------


def _linear_to_flat(w_in_out: np.ndarray, b: np.ndarray) -> List[np.ndarray]:
    """(in, out) weight + bias -> Torch [weight(out,in) row-major, bias]."""
    return [np.ascontiguousarray(np.asarray(w_in_out).T).ravel(), np.asarray(b).ravel()]


def _linear_from_flat(vec: np.ndarray, off: int, n_in: int, n_out: int):
    w = vec[off : off + n_out * n_in].reshape(n_out, n_in).T.copy()
    off += n_out * n_in
    b = vec[off : off + n_out].copy()
    off += n_out
    return w, b, off


def lstm_params_to_flat(layers: Sequence[Dict[str, np.ndarray]]) -> np.ndarray:
    """[i2h.w, i2h.b, h2h.w, h2h.b] per layer (LSTM_encoder.lua:32-33)."""
    parts: List[np.ndarray] = []
    for layer in layers:
        parts += _linear_to_flat(layer["wx"], layer["bx"])
        parts += _linear_to_flat(layer["wh"], layer["bh"])
    return np.concatenate([np.asarray(p, np.float32) for p in parts])


def lstm_params_from_flat(
    vec: np.ndarray, input_size: int, rnn_size: int, num_layers: int
) -> List[Dict[str, np.ndarray]]:
    off = 0
    layers = []
    for i in range(num_layers):
        in_size = input_size if i == 0 else rnn_size
        wx, bx, off = _linear_from_flat(vec, off, in_size, 4 * rnn_size)
        wh, bh, off = _linear_from_flat(vec, off, rnn_size, 4 * rnn_size)
        layers.append({"wx": wx, "bx": bx, "wh": wh, "bh": bh})
    if off != vec.size:
        raise ValueError(f"flat LSTM vector size mismatch: used {off} of {vec.size}")
    return layers


def arch1_to_flat(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Arch1 numpy params -> the three flat vectors of
    002_train_baseline.lua:419-420."""
    emb = params["embedding"]
    embedding_w_q = np.concatenate(_linear_to_flat(emb["w"], emb["b"]))
    encoder_w_q = lstm_params_to_flat(params["encoder"])
    fus = params["fusion"]
    cls = params["classifier"]
    multimodal_w = np.concatenate(
        _linear_to_flat(fus["wq"], fus["bq"])
        + _linear_to_flat(fus["wi"], fus["bi"])
        + _linear_to_flat(cls["w"], cls["b"])
    )
    return {
        "encoder_w_q": encoder_w_q.astype(np.float32),
        "embedding_w_q": embedding_w_q.astype(np.float32),
        "multimodal_w": multimodal_w.astype(np.float32),
    }


def arch1_from_flat(vectors: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """The three flat vectors -> arch1 numpy params for ``cfg``'s widths."""
    V, E = cfg.vocab_size, cfg.input_encoding_size
    H, L = cfg.rnn_size, cfg.rnn_layer
    C, F, O = cfg.common_embedding_size, cfg.nhimage, cfg.num_output

    ev = np.asarray(vectors["embedding_w_q"], np.float32)
    w, b, off = _linear_from_flat(ev, 0, V, E)
    if off != ev.size:
        raise ValueError(f"embedding_w_q size mismatch: used {off} of {ev.size}")
    embedding = {"w": w, "b": b}

    encoder = lstm_params_from_flat(
        np.asarray(vectors["encoder_w_q"], np.float32), E, H, L
    )

    mv = np.asarray(vectors["multimodal_w"], np.float32)
    wq, bq, off = _linear_from_flat(mv, 0, 2 * H * L, C)
    wi, bi, off = _linear_from_flat(mv, off, F, C)
    cw, cb, off = _linear_from_flat(mv, off, C, O)
    if off != mv.size:
        raise ValueError(f"multimodal_w size mismatch: used {off} of {mv.size}")
    return {
        "embedding": embedding,
        "encoder": encoder,
        "fusion": {"wq": wq, "bq": bq, "wi": wi, "bi": bi},
        "classifier": {"w": cw, "b": cb},
    }


def _lstm_flat_size(input_size: int, rnn_size: int, num_layers: int) -> int:
    return sum(
        4 * rnn_size * (input_size if i == 0 else rnn_size) + 4 * rnn_size
        + 4 * rnn_size * rnn_size + 4 * rnn_size
        for i in range(num_layers)
    )


def arch2_to_flat(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Arch2 numpy params -> {cnn_w, encoder_w_q, multimodal_w}.
    ``encoder_w_q`` is ``nn.Encoder``'s getParameters order: the LSTM
    layers, then the lookup table's weight (Encoder_lstm.lua builds the
    encoder first, the lookup second)."""
    cnn = params["cnn_proj"]
    cls = params["classifier"]
    encoder_w_q = np.concatenate(
        [lstm_params_to_flat(params["encoder"]), np.asarray(params["lookup"], np.float32).ravel()]
    )
    return {
        "cnn_w": np.concatenate(_linear_to_flat(cnn["w"], cnn["b"])).astype(np.float32),
        "encoder_w_q": encoder_w_q.astype(np.float32),
        "multimodal_w": np.concatenate(_linear_to_flat(cls["w"], cls["b"])).astype(np.float32),
    }


def arch2_from_flat(vectors: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """The three flat vectors -> arch2 numpy params for ``cfg``'s widths."""
    V, E, H, L = cfg.vocab_size, cfg.input_encoding_size, cfg.rnn_size, cfg.num_layers
    cv = np.asarray(vectors["cnn_w"], np.float32)
    w, b, off = _linear_from_flat(cv, 0, cfg.nhimage, E)
    if off != cv.size:
        raise ValueError(f"cnn_w size mismatch: used {off} of {cv.size}")
    ev = np.asarray(vectors["encoder_w_q"], np.float32)
    lstm_size = _lstm_flat_size(E, H, L)
    if ev.size != lstm_size + (V + 1) * E:
        raise ValueError(
            f"encoder_w_q size mismatch: {ev.size}, expected {lstm_size + (V + 1) * E}"
        )
    mv = np.asarray(vectors["multimodal_w"], np.float32)
    cw, cb, off = _linear_from_flat(mv, 0, H, cfg.num_output)
    if off != mv.size:
        raise ValueError(f"multimodal_w size mismatch: used {off} of {mv.size}")
    return {
        "cnn_proj": {"w": w, "b": b},
        "lookup": ev[lstm_size:].reshape(V + 1, E).copy(),
        "encoder": lstm_params_from_flat(ev[:lstm_size], E, H, L),
        "classifier": {"w": cw, "b": cb},
    }


def save_flat_h5(path: str, vectors: Dict[str, np.ndarray]) -> None:
    write_h5(path, {k: np.asarray(v, np.float32) for k, v in vectors.items()})


def load_flat_h5(path: str) -> Dict[str, np.ndarray]:
    with H5Reader(path) as f:
        return {k: f[k] for k in f.keys()}


def ae_transfer_to_h5(
    path: str,
    lookup: np.ndarray,  # (vocab+1, E) embedding table
    encoder_layers: Sequence[Dict[str, np.ndarray]],
    multimodal_flat: np.ndarray | None = None,
) -> None:
    """Write the converted-AE interchange h5
    (002_convert_text_model_arch1_as_h5.lua:39-42): ``lookup`` stored
    transposed to (E, vocab+1), as the reference converter's ``lookup:t()``;
    ``encoder`` the flat LSTM vector; ``multimodal`` the weak-paired AE's
    flat AxB vector when given."""
    arrays = {
        "lookup": np.asarray(lookup, np.float32).T,
        "encoder": lstm_params_to_flat(encoder_layers),
    }
    if multimodal_flat is not None:
        arrays["multimodal"] = np.asarray(multimodal_flat, np.float32)
    write_h5(path, arrays)


def ae_transfer_from_h5(
    path: str, input_size: int, rnn_size: int, num_layers: int
) -> Dict[str, Any]:
    """A converted-AE transfer h5 -> {lookup (vocab+1, E), encoder layers,
    [multimodal flat vector]}; the file stores ``lookup`` transposed, as the
    reference converter's ``lookup:t()``."""
    with H5Reader(path) as f:
        out: Dict[str, Any] = {
            "lookup": f["lookup"].T.copy(),
            "encoder": lstm_params_from_flat(
                f["encoder"], input_size, rnn_size, num_layers
            ),
        }
        if "multimodal" in f:
            out["multimodal"] = f["multimodal"]
    return out
