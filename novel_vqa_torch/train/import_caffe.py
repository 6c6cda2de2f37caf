"""Direct .caffemodel -> vision .npz importer, numpy only (copy of
``novel_vqa_tpu.train.import_caffe``; no Torch7 or Caffe runtime).

The reference loads VGG weights straight from a Caffe binary via loadcaffe
(002_train_vqa_arch1/001_prepro_img_vgg.lua:36).  This module parses the
protobuf wire format of ``NetParameter`` by hand (weights only): both the
legacy ``layers`` (field 2, ``V1LayerParameter``) and the modern ``layer``
(field 100, ``LayerParameter``) encodings, and both ``BlobProto`` shape
styles (legacy num/channels/height/width ints and the ``BlobShape``
message).

It writes the JAX package's ``.npz`` keys and layouts, so one file loads
into both packages: convs in network order -> ``conv/{i}/{w,b}`` with the
OIHW->HWIO transpose; the trailing InnerProducts -> ``fc6/fc7/fc8`` with the
(out,in)->(in,out) transpose (caffe's fc6 input is the CHW-flattened pool5).
``core/convert.vgg_params_from_numpy`` turns the conv weights back to OIHW
for the port.

Channel order: caffe VGG nets are BGR-native and the extractor feeds BGR
mean-subtracted inputs, so the default import performs NO channel swap.
``--bgr_to_rgb 1`` applies the first-conv input-channel swap of
001_train_autoencoder/misc/net_utils.lua:25-33 for nets that will be fed
RGB (the weak-paired training prepro path).

    python -m novel_vqa_torch.train.import_caffe VGG_ILSVRC_16_layers.caffemodel --out vgg16.npz
"""

from __future__ import annotations

import argparse
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "parse_message",
    "parse_blob",
    "parse_net_layers",
    "caffemodel_to_npz",
    "main",
]


# ------------------------------------------------------------ wire format


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def parse_message(buf) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over one serialized message.

    wire types: 0 varint (int), 1 fixed64 (bytes), 2 length-delimited
    (memoryview), 5 fixed32 (bytes).  Groups (3/4) are rejected — caffe
    protos never use them.
    """
    buf = memoryview(buf)
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 0x07
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {field}")
        yield field, wt, val


# ------------------------------------------------------------ BlobProto

# caffe.proto BlobProto fields:
#   optional int32 num=1, channels=2, height=3, width=4 (legacy 4-D shape)
#   repeated float data=5 [packed]; repeated float diff=6
#   optional BlobShape shape=7  (message: repeated int64 dim=1)
#   repeated double double_data=8


def _parse_blob_shape(buf) -> List[int]:
    dims: List[int] = []
    for field, wt, val in parse_message(buf):
        if field == 1:
            if wt == 0:
                dims.append(int(val))
            elif wt == 2:  # packed int64 dims
                mv = memoryview(val)
                pos = 0
                while pos < len(mv):
                    d, pos = _read_varint(mv, pos)
                    dims.append(int(d))
    return dims


def parse_blob(buf) -> np.ndarray:
    legacy = {}
    dims: Optional[List[int]] = None
    chunks: List[np.ndarray] = []
    dbl_chunks: List[np.ndarray] = []
    for field, wt, val in parse_message(buf):
        if field in (1, 2, 3, 4) and wt == 0:
            legacy[field] = int(val)
        elif field == 5:
            if wt == 2:  # packed floats
                chunks.append(np.frombuffer(val, dtype="<f4"))
            elif wt == 5:  # unpacked single float
                chunks.append(np.frombuffer(val, dtype="<f4"))
        elif field == 7 and wt == 2:
            dims = _parse_blob_shape(val)
        elif field == 8:
            if wt == 2:
                dbl_chunks.append(np.frombuffer(val, dtype="<f8"))
            elif wt == 1:
                dbl_chunks.append(np.frombuffer(val, dtype="<f8"))
    if chunks:
        data = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    elif dbl_chunks:
        data = np.concatenate(dbl_chunks).astype(np.float32)
    else:
        data = np.zeros((0,), np.float32)
    if dims is None:
        dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    shape = tuple(dims) if dims else (data.size,)
    if int(np.prod(shape)) != data.size:
        raise ValueError(f"blob shape {shape} != data size {data.size}")
    return np.asarray(data, np.float32).reshape(shape)


# ------------------------------------------------------------ layers


def _parse_layer(buf, legacy: bool) -> Dict[str, Any]:
    """V1LayerParameter: name=4 (string), type=5 (enum varint), blobs=6.
    LayerParameter:     name=1 (string), type=2 (string),     blobs=7."""
    name_field, type_field, blob_field = (4, 5, 6) if legacy else (1, 2, 7)
    layer: Dict[str, Any] = {"name": "", "type": "", "blobs": []}
    for field, wt, val in parse_message(buf):
        if field == name_field and wt == 2:
            layer["name"] = bytes(val).decode("utf-8", "replace")
        elif field == type_field:
            if legacy and wt == 0:
                layer["type"] = int(val)  # V1LayerType enum
            elif not legacy and wt == 2:
                layer["type"] = bytes(val).decode("utf-8", "replace")
        elif field == blob_field and wt == 2:
            layer["blobs"].append(parse_blob(val))
    return layer


def parse_net_layers(path: str) -> List[Dict[str, Any]]:
    """Parse a .caffemodel and return layers (with any blobs) in network
    order.  NetParameter: name=1, layers=2 (V1, legacy), layer=100 (new)."""
    with open(path, "rb") as f:
        buf = f.read()
    layers: List[Dict[str, Any]] = []
    for field, wt, val in parse_message(buf):
        if field == 2 and wt == 2:
            layers.append(_parse_layer(val, legacy=True))
        elif field == 100 and wt == 2:
            layers.append(_parse_layer(val, legacy=False))
    return [l for l in layers if l["blobs"]]


# ------------------------------------------------------------ mapping


def _squeeze_fc(w: np.ndarray) -> np.ndarray:
    """Legacy FC blobs come as (1, 1, out, in); normalize to (out, in)."""
    while w.ndim > 2 and w.shape[0] == 1:
        w = w.reshape(w.shape[1:])
    return w


def caffemodel_to_npz(
    path: str,
    out_path: str,
    arch: str = "vgg16",
    bgr_to_rgb: bool = False,
) -> Dict[str, np.ndarray]:
    layers = parse_net_layers(path)
    convs: List[Dict[str, Any]] = []
    linears: List[Dict[str, Any]] = []
    for l in layers:
        w = l["blobs"][0]
        # conv weights are a (O, I, KH, KW) filter bank; legacy FC blobs are
        # also 4-D but padded as (1, 1, out, in)
        if w.ndim == 4 and not (w.shape[0] == 1 and w.shape[1] == 1):
            convs.append(l)
        else:
            linears.append(l)
    if arch == "auto":
        # real autodetection from the parsed conv count (13 -> VGG-16,
        # 16 -> VGG-19); anything else falls through to the mismatch error
        arch = {13: "vgg16", 16: "vgg19"}.get(len(convs), "vgg16")
        print(f"auto-detected arch: {arch} ({len(convs)} conv layers)")
    expected = {"vgg16": 13, "vgg19": 16}.get(arch)
    if expected is not None and len(convs) != expected:
        raise ValueError(
            f"{arch} expects {expected} conv layers, parsed {len(convs)} "
            f"({[l['name'] for l in convs]})"
        )
    flat: Dict[str, np.ndarray] = {}
    for i, l in enumerate(convs):
        w = l["blobs"][0]  # caffe conv weight: (O, I, KH, KW)
        if i == 0 and bgr_to_rgb:
            # misc/net_utils.lua:25-33 recipe: swap the B and R input slices
            w = w[:, ::-1, :, :]
        flat[f"conv/{i}/w"] = np.ascontiguousarray(
            np.transpose(w, (2, 3, 1, 0))
        ).astype(np.float32)  # HWIO
        if len(l["blobs"]) > 1:
            flat[f"conv/{i}/b"] = np.asarray(l["blobs"][1], np.float32).reshape(-1)
    fc_names = ["fc6", "fc7", "fc8"]
    if len(linears) > len(fc_names):
        raise ValueError(f"expected <=3 InnerProduct layers, got {len(linears)}")
    for name, l in zip(fc_names, linears):
        w = _squeeze_fc(l["blobs"][0])  # (out, in)
        flat[f"{name}/w"] = np.ascontiguousarray(w.T).astype(np.float32)
        if len(l["blobs"]) > 1:
            flat[f"{name}/b"] = np.asarray(l["blobs"][1], np.float32).reshape(-1)
    np.savez(out_path, **flat)
    print(
        f"wrote {out_path}: {len(convs)} convs, {len(linears)} linears "
        f"(bgr_to_rgb={int(bgr_to_rgb)})"
    )
    return flat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("caffemodel")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--arch", default="vgg16", choices=["vgg16", "vgg19", "auto"])
    ap.add_argument(
        "--bgr_to_rgb", default=0, type=int,
        help="apply net_utils.lua:25-33 first-conv BGR->RGB swap (use when "
        "the net will be fed RGB; the reference extraction path feeds BGR "
        "and needs no swap)",
    )
    args = ap.parse_args(argv)
    caffemodel_to_npz(
        args.caffemodel, args.out, arch=args.arch, bgr_to_rgb=bool(args.bgr_to_rgb)
    )


if __name__ == "__main__":
    main()
