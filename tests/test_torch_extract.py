"""The port's extraction path on the CPU: its CLI against the JAX CLI on the
same image files and weights (store names, shapes, dtype, features within
1e-4 relative), the pipelined loop's decode-free control, and the port's own
build of the native decoder (hashed name under ``build/``, atomic rename,
built at first use and once per process)."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from novel_vqa_tpu.core.checkpoint import save_npz as jsave_npz
from novel_vqa_tpu.data import images as jimages
from novel_vqa_tpu.models.vision import vgg as jvgg
from novel_vqa_tpu.train import extract_features as jextract
from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.data import images as timages
from novel_vqa_torch.data import native_images
from novel_vqa_torch.train import extract_features as textract

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Three PNGs at the net's input size (so both packages' decoders, PIL
    or native, give the same pixels), JPEGs of other sizes, weights for
    vgg16, vggembed and vgg19 saved by the JAX package, and a
    data_prepro.json whose val list names a missing file."""
    d = tmp_path_factory.mktemp("extract")
    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(d / f"im{i}.png")
    for i, shape in enumerate([(50, 70, 3), (64, 64, 3), (120, 40, 3)]):
        Image.fromarray(rs.randint(0, 255, shape, dtype=np.uint8)).save(d / f"ph{i}.jpg", quality=95)
    for seed, arch in enumerate(("vgg16", "vggembed", "vgg19")):
        cfg = jvgg.VGGConfig(arch=arch, image_size=SIZE)
        jsave_npz(str(d / f"{arch}.npz"), jax.device_get(jvgg.init_params(jax.random.PRNGKey(seed), cfg)))
    meta = {"unique_img_train": ["im0.png", "im1.png", "im2.png"], "unique_img_test": ["im2.png", "im0.png"],
            "unique_img_val": ["im1.png", "nothere.png"]}
    (d / "data_prepro.json").write_text(json.dumps(meta))
    return d


@pytest.mark.parametrize("model,model2,width", [("vgg16", "", 4096), ("vggembed", "vgg19", 8896)])
def test_extraction_cli_matches_jax_cli(image_dir, model, model2, width):
    d = image_dir
    argv = ["--input_json", str(d / "data_prepro.json"), "--image_root", str(d), "--image_size", str(SIZE),
            "--batch_size", "2", "--pipeline_depth", "2", "--model", model, "--weights", str(d / f"{model}.npz")]
    if model2:
        argv += ["--model2", model2, "--weights2", str(d / f"{model2}.npz")]
    jextract.main(argv + ["--out_name", str(d / "j.h5")])
    textract.main(argv + ["--out_name", str(d / "t.h5"), "--device", "cpu"])
    rows = {"images_train": 3, "images_test": 2, "images_val": 2}
    with h5py.File(d / "j.h5", "r") as j, h5py.File(d / "t.h5", "r") as t:
        assert sorted(t) == sorted(j) == sorted(rows)
        for name, n in rows.items():
            ref, got = j[name][()], t[name][()]
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (n, width)
            assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4, name
        # list order: the test split's [im2, im0] are train rows 2 and 0
        np.testing.assert_array_equal(t["images_test"][()], t["images_train"][()][[2, 0]])
        train = t["images_train"][()]
    with H5Reader(str(d / "t.h5")) as h5:  # and the port reads its own store
        np.testing.assert_array_equal(h5["images_train"], train)


def test_predecoded_control_matches_pooled_loop(image_dir):
    model = textract.build_model("vgg16", "", "fc7", seed=0, image_size=SIZE, device="cpu")
    paths = [str(image_dir / f"ph{i}.jpg") for i in range(3)] + [str(image_dir / "im0.png")]
    pooled, _ = textract.run_pipelined_extraction([model], paths, 3, 2, depth=2)
    pool = timages.DecodePool(SIZE, workers=2)
    try:
        batches = list(pool.iter_batches(paths, 3))
    finally:
        pool.close()
    assert [b[2] for b in batches] == [3, 1] and all(b[0].shape == (3, SIZE, SIZE, 3) for b in batches)
    control, wall = textract.run_pipelined_extraction([model], paths, 3, 2, depth=2, predecoded=batches)
    np.testing.assert_array_equal(control, pooled)
    assert wall > 0
    with pytest.raises(ValueError, match="single model"):
        textract.run_pipelined_extraction([model, model], paths, 3, 2, predecoded=[])


def test_bf16_route_within_1e2_of_float32():
    rs = np.random.RandomState(1)
    u8 = torch.from_numpy(rs.randint(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8))
    missing = torch.tensor([False, False, True, False])
    out = {}
    for dtype in ("float32", "bfloat16"):
        fwd, *_ = textract.build_model("vgg16", "", "fc7", seed=3, image_size=SIZE, compute_dtype=dtype,
                                       device="cpu")
        out[dtype] = fwd(u8, missing)
        assert out[dtype].dtype == torch.float32 and out[dtype].shape == (4, 4096)
    assert float((out["bfloat16"] - out["float32"]).abs().max() / out["float32"].abs().max()) < 1e-2


@pytest.mark.parametrize("kwargs,error,match", [
    ({"name": "inception", "image_size": 64}, ValueError, "at least 75"),
    ({"name": "resnet"}, ValueError, "unknown --model"),
    ({"compute_dtype": "fp8"}, ValueError, "compute_dtype"),
    ({"prepro_mode": "caffe2"}, ValueError, "prepro"),
])
def test_build_model_refuses(kwargs, error, match):
    args = {"name": "vgg16", "weights": "", "tap": "fc7", "seed": 0, "image_size": SIZE, "device": "cpu", **kwargs}
    with pytest.raises(error, match=match):
        textract.build_model(**args)


def test_cli_defaults_to_the_card(image_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        textract.main(["--input_json", str(image_dir / "data_prepro.json"), "--out_name", str(tmp_path / "x.h5")])


def test_decode_pool_records_its_decoder(image_dir):
    paths = [str(image_dir / f"ph{i}.jpg") for i in range(3)] + [str(image_dir / "missing.jpg")]
    pil = timages.DecodePool(48, use_native=False)
    assert pil.decoder == "pil"
    try:
        (imgs, missing, real), = list(pil.iter_batches(paths, 4))
    finally:
        pil.close()
    assert imgs.shape == (4, 48, 48, 3) and real == 4 and list(missing) == [False, False, False, True]
    assert timages.DecodePool(48).decoder == timages.default_decoder()
    # the PIL decode is the JAX package's
    for p in paths[:3]:
        np.testing.assert_array_equal(timages.decode_resize(p, 48)[0], jimages.decode_resize(p, 48)[0])


def _need_compiler():
    if not native_images.available():
        pytest.skip(f"the native decoder cannot be built here: {native_images.unavailable_reason()}")


def test_native_decoder_builds_under_build_and_matches_pil(image_dir):
    _need_compiler()
    lib = native_images.build()
    assert lib.parent == ROOT / "build" and lib.name.startswith("libimagepipe-") and lib.exists()
    for i in range(3):
        p = str(image_dir / f"ph{i}.jpg")
        native, miss_n = native_images.decode_resize_native(p, 64)
        pil, miss_p = timages.decode_resize(p, 64)
        assert not miss_n and not miss_p and native.shape == pil.shape == (64, 64, 3)
        # decode and bilinear rounding differ a little between libjpeg and PIL
        assert np.abs(native.astype(int) - pil.astype(int)).mean() < 12
    png = str(image_dir / "im0.png")  # a lossless file at its own size: identical
    np.testing.assert_array_equal(native_images.decode_resize_native(png, SIZE)[0],
                                  timages.decode_resize(png, SIZE)[0])
    imgs, missing = native_images.decode_batch_native([png, str(image_dir / "no.jpg")], 40, n_threads=2)
    assert imgs.shape == (2, 40, 40, 3) and list(missing) == [False, True] and not imgs[1].any()


def test_native_decoder_reports_why_it_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(native_images.NativeDecoderUnavailable, match="g\\+\\+ is not on PATH"):
        native_images.build(tmp_path)
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'imagepipe.cpp:26:10: fatal error: jpeglib.h: No such file or directory' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(native_images.NativeDecoderUnavailable, match="jpeglib.h not found"):
        native_images.build(tmp_path / "b")
    assert list((tmp_path / "b").iterdir()) == []  # the temporary file is gone


_FIRST_USE = """
import sys
from pathlib import Path
from novel_vqa_torch.data import native_images as n
n.BUILD_DIR = Path(sys.argv[1])
img, missing = n.decode_resize_native(sys.argv[2], 16)
assert not missing and img.shape == (16, 16, 3), (missing, img.shape)
print(n.build().name)
"""


def test_parallel_first_use_never_loads_a_half_written_library(image_dir, tmp_path):
    """Four processes and four threads use the decoder first at once, all
    building into one empty directory: each loads a whole library, and one
    library of one name is left, no temporary file."""
    _need_compiler()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    png = str(image_dir / "im1.png")
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_USE, str(tmp_path / "p"), png], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1 and [f.name for f in (tmp_path / "p").iterdir()] == list(names)

    # threads of one process: the lock builds once
    code = _FIRST_USE.replace("print(n.build().name)", "") + (
        "import threading\n"
        "n._state.clear()\n"
        "errors = []\n"
        "def use():\n"
        "    try:\n"
        "        n.decode_resize_native(sys.argv[2], 16)\n"
        "    except Exception as err:\n"
        "        errors.append(err)\n"
        "ts = [threading.Thread(target=use) for _ in range(4)]\n"
        "[t.start() for t in ts]; [t.join(60) for t in ts]\n"
        "assert not errors and not any(t.is_alive() for t in ts), errors\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "t"), png], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert len(list((tmp_path / "t").iterdir())) == 1


def test_store_is_read_by_h5py_and_the_port(tmp_path):
    """``core/h5.write_h5`` writes 2-D float32 images_* datasets as h5py
    does; an empty split is left out, as the JAX CLI leaves it out."""
    from novel_vqa_torch.core.h5 import write_h5

    feats = {"images_train": np.random.RandomState(2).rand(5, 7).astype(np.float32),
             "images_test": np.zeros((3, 7), np.float32)}
    write_h5(str(tmp_path / "s.h5"), feats)
    with h5py.File(tmp_path / "s.h5", "r") as f:
        assert sorted(f) == ["images_test", "images_train"]
        for k, v in feats.items():
            assert f[k].dtype == np.float32 and f[k].shape == v.shape
            np.testing.assert_array_equal(f[k][()], v)
