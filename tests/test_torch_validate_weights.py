"""The port's weight-validation gate (``novel_vqa_torch/utils/
validate_weights.py``): the JAX tool's dry run (tests/test_validate_weights.py:
record -> check passes, a corrupted conv fails, discovery maps names) on
synthetic weights at a small ``--image_size``, and fixtures recorded by
either package's tool pass the other's check on the same weights and
images, within the tool's rtol and atol of 2e-3."""

import json
import os

import numpy as np
import pytest
import torch

from novel_vqa_tpu.utils import validate_weights as jvw

from novel_vqa_torch.core.checkpoint import load_npz, save_npz
from novel_vqa_torch.core.convert import vision_params_to_numpy
from novel_vqa_torch.models.vision import vgg as tvgg
from novel_vqa_torch.utils import validate_weights as tvw


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host, and full-width CPU work with a
    thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SIZE = ["--image_size", "64"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def synth_vgg16(tmp_path_factory):
    """Synthetic VGG-16 weights at 64x64 in the npz both packages read (HWIO
    convs), made by the port's seeded init."""
    d = tmp_path_factory.mktemp("weights")
    path = os.path.join(d, "vgg16_synth.npz")
    params = tvgg.init_params(tvgg.VGGConfig(arch="vgg16", image_size=64),
                              torch.Generator().manual_seed(7), "cpu")
    save_npz(path, vision_params_to_numpy(params))
    return str(d), path


def test_record_then_check_roundtrip(tmp_path, synth_vgg16):
    d, _ = synth_vgg16
    fx = str(tmp_path / "fixtures.json")
    assert tvw.run(["--weights_dir", d, "--make_fixtures", fx] + SIZE + CPU) == 0
    rec = json.load(open(fx))
    assert rec["schema"] == "novel-vqa-weight-fixtures-v1"
    assert set(rec["models"]["vgg16"]["taps"]) == {"fc7", "fc8"}
    assert rec["image_source"] == "synthetic-v1"
    assert len(rec["models"]["vgg16"]["taps"]["fc8"]["argmax"]) == 4
    assert tvw.run(["--weights_dir", d, "--fixtures", fx] + SIZE + CPU) == 0


def test_corrupted_weights_fail(tmp_path, synth_vgg16):
    _, wpath = synth_vgg16
    fx = str(tmp_path / "fixtures.json")
    assert tvw.run(["--weights", wpath, "--model", "vgg16", "--make_fixtures", fx]
                   + SIZE + CPU) == 0
    flat, _ = load_npz(wpath)
    bad = dict(flat)
    key = next(k for k in sorted(bad) if k.endswith("/w") and "conv" in k)
    bad[key] = np.asarray(bad[key]) + 0.05  # a wrong-topology-scale error
    bad_path = str(tmp_path / "vgg16_bad.npz")
    save_npz(bad_path, bad)
    assert tvw.run(["--weights", bad_path, "--model", "vgg16", "--fixtures", fx]
                   + SIZE + CPU) == 1


def test_discovery_matches_jax(tmp_path):
    for name in ("vgg16.npz", "VGG19_layers.caffemodel", "inception_v3.t7", "readme.txt",
                 "vgg16_backup.caffemodel", "VGG_ILSVRC_16_layers.caffemodel",
                 "vgg_release_2016.txt"):
        (tmp_path / name).write_bytes(b"x")
    found = tvw.discover_weights(str(tmp_path))
    assert found == jvw.discover_weights(str(tmp_path))
    assert found["vgg16"] == str(tmp_path / "vgg16.npz")  # npz preferred


def test_check_mode_fails_cleanly(tmp_path, synth_vgg16):
    """Nothing compared -> rc 2; a fixture without a tap -> rc 1; another
    image source -> rc 1; a schema from elsewhere -> rc 2."""
    d, wpath = synth_vgg16
    fx = str(tmp_path / "fixtures.json")
    assert tvw.run(["--weights", wpath, "--model", "vgg16", "--make_fixtures", fx]
                   + SIZE + CPU) == 0
    rec = json.load(open(fx))
    other = tmp_path / "weights_other"
    other.mkdir()
    (other / "vgg19_synth.npz").write_bytes(open(wpath, "rb").read())
    assert tvw.run(["--weights_dir", str(other), "--fixtures", fx] + SIZE + CPU) == 2
    for edit, rc in ((lambda r: r["models"]["vgg16"]["taps"].pop("fc8"), 1),
                     (lambda r: r.update(image_source="files:deadbeef"), 1),
                     (lambda r: r.update(schema="other"), 2)):
        bad = json.loads(json.dumps(rec))
        edit(bad)
        json.dump(bad, open(fx, "w"))
        assert tvw.run(["--weights", wpath, "--model", "vgg16", "--fixtures", fx]
                       + SIZE + CPU) == rc


@pytest.mark.parametrize("recorder", ["jax", "torch"])
def test_fixtures_cross_between_the_packages(tmp_path, synth_vgg16, recorder):
    """Fixtures recorded by one package's tool pass the other's check."""
    d, _ = synth_vgg16
    fx = str(tmp_path / "fixtures.json")
    if recorder == "jax":
        assert jvw.run(["--weights_dir", d, "--make_fixtures", fx] + SIZE) == 0
        assert tvw.run(["--weights_dir", d, "--fixtures", fx] + SIZE + CPU) == 0
    else:
        assert tvw.run(["--weights_dir", d, "--make_fixtures", fx] + SIZE + CPU) == 0
        assert jvw.run(["--weights_dir", d, "--fixtures", fx] + SIZE) == 0


def test_default_device_is_the_card(tmp_path, synth_vgg16):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    d, _ = synth_vgg16
    with pytest.raises(RuntimeError, match="cuda"):
        tvw.run(["--weights_dir", d, "--make_fixtures", str(tmp_path / "f.json")] + SIZE)
