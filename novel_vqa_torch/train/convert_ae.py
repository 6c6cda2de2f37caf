"""AE checkpoint -> VQA-init transfer dump (port of
``novel_vqa_tpu.train.convert_ae``).

The reference converters:
  * 001_train_autoencoder/002_convert_text_model_arch1.lua:27-39 (and the
    _as_h5 variant :39-42): {lookup (transposed), encoder (flat)} from a
    text-AE checkpoint;
  * 005_convert_weakpaired_model_arch1.lua:28-43: also the multimodal flat
    vector of a weak-paired AE (``--include_multimodal 1``).

Reads an ``.npz`` AE checkpoint of either package's trainer (a weak-paired
checkpoint's ``ae/`` prefix is stripped) and writes the interchange h5 that
``train_vqa_arch1 --init_from`` reads.  The conversion is host work; the
CLI takes ``--device`` as every entry point of the port does (default
``cuda``, which raises without a card).

    python -m novel_vqa_torch.train.convert_ae --ae_model model_id.npz --out converted.h5
"""

from __future__ import annotations

import dataclasses

import numpy as np

from novel_vqa_torch.core.checkpoint import _linear_to_flat, ae_transfer_to_h5, load_npz
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.device import resolve_device


@dataclasses.dataclass
class ConvertConfig:
    ae_model: str = ""  # .npz AE checkpoint
    out: str = "converted.h5"
    include_multimodal: int = 0  # 1 for weak-paired (005_convert_...)
    device: str = "cuda"


def main(argv=None):
    opt = parse_config(ConvertConfig, argv, description=__doc__)
    resolve_device(opt.device)
    flat, _ = load_npz(opt.ae_model)
    if "lookup" not in flat and any(k.startswith("ae/") for k in flat):
        # weak-paired checkpoints store {"ae": ..., "cnn": ...}
        flat = {k[3:]: v for k, v in flat.items() if k.startswith("ae/")}

    num_layers = len({k.split("/")[1] for k in flat if k.startswith("encoder/")})
    encoder_layers = [
        {p: flat[f"encoder/{i}/{p}"] for p in ("wx", "bx", "wh", "bh")}
        for i in range(num_layers)
    ]
    multimodal = None
    if opt.include_multimodal:
        mm = {k.split("/")[-1]: v for k, v in flat.items() if k.startswith("multimodal/")}
        multimodal = np.concatenate(
            _linear_to_flat(mm["wq"], mm["bq"]) + _linear_to_flat(mm["wi"], mm["bi"])
        ).astype(np.float32)

    ae_transfer_to_h5(opt.out, flat["lookup"], encoder_layers, multimodal_flat=multimodal)
    print("wrote", opt.out)


if __name__ == "__main__":
    main()
