"""The port's VGG (``novel_vqa_torch.models.vision``), its device prepro
(``data/images.py``), its caffe importer and its weight converters against
the JAX package, on the CPU: the same weights (carried by
``core/convert.py``) and the same numpy-seeded images through both.

Tolerances, as max |port - JAX| over max |JAX| per tap: 1e-4 in float32
(two frameworks sum the convolutions in other orders), 1e-2 in bfloat16
storage (the JAX package's stated bf16 bound, extract_features.py:61-65;
the two round bf16 at different places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.data import images as jimages
from novel_vqa_tpu.models.vision import layers as jlayers
from novel_vqa_tpu.models.vision import vgg as jvgg
from novel_vqa_tpu.train import import_caffe as jcaffe
from novel_vqa_torch.core.checkpoint import load_npz, unflatten_like
from novel_vqa_torch.core.convert import vgg_params_from_numpy, vgg_params_to_numpy
from novel_vqa_torch.data import images as timages
from novel_vqa_torch.models.vision import layers as tlayers
from novel_vqa_torch.models.vision import vgg as tvgg
from novel_vqa_torch.train import import_caffe as tcaffe
from test_import_caffe import _ld, _synthetic_vgg, _v1_layer

TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _jax_params(arch, size, seed=0):
    cfg = jvgg.VGGConfig(arch=arch, image_size=size)
    return cfg, jax.device_get(jvgg.init_params(jax.random.PRNGKey(seed), cfg))


def _taps(arch):
    return ("pool5", "fc6", "fc7", "embed" if arch == "vggembed" else "fc8")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("arch", ["vgg16", "vgg19", "vggembed"])
def test_vgg_taps_match_jax(arch, size, dtype):
    jcfg, jp = _jax_params(arch, size)
    tp = vgg_params_from_numpy(jp, "cpu")
    if dtype == "bfloat16":
        jp = jax.tree_util.tree_map(jnp.asarray, jlayers.bf16_storage_cast(jp))
        tp = tlayers.bf16_storage_cast(tp)
    tcfg = tvgg.VGGConfig(arch=arch, image_size=size)
    x = (np.random.RandomState(1).rand(2, size, size, 3) * 255 - 120).astype(np.float32)
    for tap in _taps(arch):
        ref = np.asarray(jvgg.apply(jp, jcfg, jnp.asarray(x), tap=tap)).astype(np.float32)
        with torch.inference_mode():
            got = tvgg.apply(tp, tcfg, _nchw(x), tap)
        if tap == "pool5":  # NCHW -> the JAX package's NHWC
            got = got.permute(0, 2, 3, 1)
        else:  # linears give f32 in either dtype
            assert got.dtype == torch.float32
        assert got.shape == ref.shape
        assert _rel(got.float().numpy(), ref) < TOL[dtype], tap
        if tap in ("fc6", "fc7"):
            assert float(got.min()) >= 0  # post-ReLU


def test_vgg16_fc7_at_224_matches_jax():
    """One image at the reference extractor's input size."""
    jcfg, jp = _jax_params("vgg16", 224, seed=3)
    x = (np.random.RandomState(2).rand(1, 224, 224, 3) * 255 - 120).astype(np.float32)
    ref = np.asarray(jvgg.apply(jp, jcfg, jnp.asarray(x), tap="fc7"))
    with torch.inference_mode():
        got = tvgg.apply(vgg_params_from_numpy(jp, "cpu"), tvgg.VGGConfig(), _nchw(x), "fc7")
    assert got.shape == (1, 4096)
    assert _rel(got.numpy(), ref) < TOL["float32"]


@pytest.mark.parametrize("arch", ["vgg16", "vgg19", "vggembed"])
def test_forward_flops_match_torch_flop_counter(arch):
    """``forward_flops``, reckoned from the layer shapes, against torch's own
    count of the conv and matmul FLOPs of the forward."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tvgg.VGGConfig(arch=arch, image_size=64)
    params = tvgg.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for tap in _taps(arch):
        with FlopCounterMode(display=False) as counter, torch.inference_mode():
            tvgg.apply(params, cfg, torch.zeros(3, 3, 64, 64), tap)
        assert counter.get_total_flops() == 3 * tvgg.forward_flops(cfg, tap), tap
    # VGG-16 at 224: 15.47 G multiply-adds to fc8, the published figure
    assert tvgg.forward_flops(tvgg.VGGConfig(), "fc8") == 30_940_528_640


@pytest.mark.parametrize("prepro", ["vgg_device_prepro", "torchvision_device_prepro"])
def test_device_prepro_matches_jax(prepro):
    """The prepro math and the missing-file quirk, exactly."""
    rs = np.random.RandomState(4)
    u8 = rs.randint(0, 256, (3, 5, 7, 3)).astype(np.uint8)
    missing = np.array([False, True, False])
    ref = np.asarray(getattr(jimages, prepro)(jnp.asarray(u8), jnp.asarray(missing)))
    got = getattr(timages, prepro)(torch.from_numpy(u8), torch.from_numpy(missing))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 5, 7)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    if prepro == "vgg_device_prepro":
        np.testing.assert_array_equal(got[1].numpy(), np.broadcast_to(
            np.float32(timages.VGG_MISSING_BGR)[:, None, None], (3, 5, 7)))
        assert timages.VGG_MISSING_BGR == jimages.VGG_MISSING_BGR
        assert timages.VGG_MEAN_BGR == jimages.VGG_MEAN_BGR


@pytest.mark.parametrize("k,size", [(3, 9), (3, 8), (1, 7), (5, 6)])
def test_raw_conv_same_padding_matches_jax(k, size):
    """Stride-1 SAME padding of odd kernels, at odd and even sizes."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, size, size + 1, 4).astype(np.float32)
    w = rs.randn(k, k, 4, 6).astype(np.float32)  # HWIO
    ref = np.asarray(jlayers.raw_conv(jnp.asarray(w), jnp.asarray(x)))
    got = tlayers.raw_conv(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), _nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


def test_dtype_policy():
    """Inputs follow the weight dtype; f32 weights give f32; bf16 convs give
    bf16; linear gives f32 with bf16 weights, the widened product."""
    rs = np.random.RandomState(6)
    conv = {"w": torch.from_numpy(rs.randn(4, 3, 3, 3).astype(np.float32)), "b": torch.zeros(4)}
    lin = {"w": torch.from_numpy(rs.randn(8, 5).astype(np.float32)), "b": torch.ones(5)}
    x = torch.from_numpy(rs.randn(2, 3, 6, 6).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, 8).astype(np.float32))
    assert tlayers.conv2d(conv, x).dtype == torch.float32
    assert tlayers.conv2d(tlayers.bf16_storage_cast(conv), x).dtype == torch.bfloat16
    lin16 = tlayers.bf16_storage_cast(lin)
    got = tlayers.linear(lin16, v)
    assert got.dtype == torch.float32
    want = v.bfloat16().double() @ lin16["w"].double() + 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    bn = {"scale": torch.ones(2), "offset": torch.zeros(2), "mean": torch.zeros(2), "var": torch.ones(2)}
    assert tlayers.bf16_storage_cast({"bn": bn})["bn"]["var"].dtype == torch.float32


def test_fp32_exact_restores_the_callers_flags():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (matmul.allow_tf32, cudnn.allow_tf32)
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = True
        with tlayers.fp32_exact():
            assert not matmul.allow_tf32 and not cudnn.allow_tf32
        assert matmul.allow_tf32 and cudnn.allow_tf32
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = old


def test_converters_round_trip_and_layout():
    _, jp = _jax_params("vgg19", 32)
    tp = vgg_params_from_numpy(jp, "cpu")
    assert tp["conv"][0]["w"].shape == (64, 3, 3, 3)  # OIHW
    assert tp["fc6"]["w"].shape == (512, 4096)  # (in, out)
    back = vgg_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("legacy,bgr_to_rgb", [(True, False), (False, False), (True, True)])
def test_caffe_importers_write_equal_npz(tmp_path, legacy, bgr_to_rgb):
    """A synthetic caffemodel (tests/test_import_caffe.py's writer) through
    both importers gives the same arrays under the same keys."""
    net, *_ = _synthetic_vgg(np.random.RandomState(7), legacy=legacy)
    path = tmp_path / "net.caffemodel"
    path.write_bytes(net)
    ref = jcaffe.caffemodel_to_npz(str(path), str(tmp_path / "j.npz"), arch="auto", bgr_to_rgb=bgr_to_rgb)
    got = tcaffe.caffemodel_to_npz(str(path), str(tmp_path / "t.npz"), arch="auto", bgr_to_rgb=bgr_to_rgb)
    j, t = dict(np.load(tmp_path / "j.npz")), dict(np.load(tmp_path / "t.npz"))
    assert sorted(got) == sorted(ref) == sorted(t) == sorted(j)
    for k in ref:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype == np.float32


def test_caffe_import_drives_the_port_vgg_as_the_jax_vgg(tmp_path):
    """A caffemodel encoding the JAX template's weights, imported by the
    port and loaded through ``load_npz``/``unflatten_like``/the converter,
    gives the JAX forward's fc7."""
    jcfg, template = _jax_params("vgg16", 32)
    net = _ld(1, b"roundtrip")
    for i, cp in enumerate(template["conv"]):
        net += _ld(2, _v1_layer(f"conv{i}", [np.transpose(cp["w"], (3, 2, 0, 1)), cp["b"]]))
    for name in ("fc6", "fc7", "fc8"):
        w = np.asarray(template[name]["w"]).T
        net += _ld(2, _v1_layer(name, [w.reshape(1, 1, *w.shape), template[name]["b"]]))
    (tmp_path / "rt.caffemodel").write_bytes(net)
    tcaffe.caffemodel_to_npz(str(tmp_path / "rt.caffemodel"), str(tmp_path / "rt.npz"))
    flat, _ = load_npz(str(tmp_path / "rt.npz"))
    tcfg = tvgg.VGGConfig(image_size=32)
    params = vgg_params_from_numpy(unflatten_like(tvgg.param_template(tcfg), flat), "cpu")
    x = np.random.RandomState(8).randn(1, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jvgg.apply(template, jcfg, jnp.asarray(x), tap="fc7"))
    with torch.inference_mode():
        got = tvgg.apply(params, tcfg, _nchw(x), "fc7")
    assert _rel(got.numpy(), ref) < TOL["float32"]


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tvgg.init_params(tvgg.VGGConfig(image_size=32), torch.Generator())
