"""The port's Inception-v3 (``novel_vqa_torch.models.vision.inception``), its
layers (avg_pool, batch_norm), its device prepro and its extraction route
against the JAX package, on the CPU: the same numpy weights (carried by
``core/convert.py``) and the same numpy-seeded images through both.

Tolerances, as max |port - JAX| over max |JAX| per tap: 1e-4 in float32
(the frameworks sum the convolutions in other orders, and the JAX default
fuses the 1x1 branch heads and pools after BN, a reassociation), 1e-2 in
bfloat16 storage (the JAX package's stated bf16 bound; the two round bf16
at different places).  Image 75 is Inception's smallest input whose VALID
stem and reduction convs all have an output."""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from novel_vqa_tpu.core.checkpoint import save_npz as jsave_npz
from novel_vqa_tpu.data import images as jimages
from novel_vqa_tpu.data import native_images as jnative
from novel_vqa_tpu.models.vision import inception as jinc
from novel_vqa_tpu.models.vision import layers as jlayers
from novel_vqa_tpu.train import extract_features as jextract
from novel_vqa_torch.core.checkpoint import _flatten_tree
from novel_vqa_torch.core.convert import inception_params_from_numpy, inception_params_to_numpy
from novel_vqa_torch.data import images as timages
from novel_vqa_torch.models.vision import inception as tinc
from novel_vqa_torch.models.vision import layers as tlayers
from novel_vqa_torch.train import extract_features as textract

SIZE = 75
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def numpy_units(monkeypatch, seed=0):
    """Make ``jinc.init_params`` draw He-init convs and non-trivial BN stats
    from a numpy RandomState (quick, where ``jax.random`` per unit takes
    seconds on the CPU), keeping the JAX package's own tree and order."""
    rs = np.random.RandomState(seed)

    def cbr_init(rng, kh, kw, c_in, c_out):
        w = rs.randn(kh, kw, c_in, c_out).astype(np.float32) * np.float32((2.0 / (kh * kw * c_in)) ** 0.5)
        bn = {"scale": rs.uniform(0.5, 1.5, c_out), "offset": rs.uniform(-0.2, 0.2, c_out),
              "mean": rs.uniform(-0.2, 0.2, c_out), "var": rs.uniform(0.5, 1.5, c_out)}
        return {"conv": {"w": w}, "bn": {k: v.astype(np.float32) for k, v in bn.items()}}

    def linear_init(rng, n_in, n_out):
        return {"w": (rs.randn(n_in, n_out) * (2.0 / n_in) ** 0.5).astype(np.float32),
                "b": rs.uniform(-0.1, 0.1, n_out).astype(np.float32)}

    monkeypatch.setattr(jinc, "_cbr_init", cbr_init)
    monkeypatch.setattr(jinc, "linear_init", linear_init)
    return rs


@pytest.fixture(scope="module")
def weights():
    """The JAX config and a JAX params tree of numpy arrays, its dicts in
    ``init_params``' definition order (``jax.device_get`` would sort them)."""
    with pytest.MonkeyPatch.context() as mp:
        numpy_units(mp)
        cfg = jinc.InceptionConfig(image_size=SIZE)
        return cfg, jinc.init_params(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", ["1", "0"], ids=["jax_fused_heads", "jax_branches"])
def test_inception_pool_and_logits_match_jax(weights, fuse, dtype, monkeypatch):
    """Both taps at full channel width, batch 2, against the JAX default
    (fused 1x1 heads, pool after BN) and with its branch fusion off.

    In bf16 storage the logits are held from the same pool features: over
    the whole net both packages' bf16 logits are about 1% off their f32
    logits (0.87-0.90% JAX, 1.03% the port, at these inputs), and about 1%
    off each other, the rounding of ~47 stacked bf16 conv outputs (ROADMAP
    section C); the pool features stay within 1e-2."""
    monkeypatch.setenv("NOVEL_VQA_INC_FUSE", fuse)  # read by the JAX package at trace time
    jcfg, jp = weights
    tp = inception_params_from_numpy(jp, "cpu")
    if dtype == "bfloat16":
        jp = jax.tree_util.tree_map(jnp.asarray, jlayers.bf16_storage_cast(jp))
        tp = tlayers.bf16_storage_cast(tp)
    x = (np.random.RandomState(1).rand(2, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)
    ref_pool = np.asarray(jinc.apply(jp, jcfg, jnp.asarray(x), tap="pool"))
    tcfg = tinc.InceptionConfig(image_size=SIZE)
    with torch.inference_mode():
        pool = tinc.apply(tp, tcfg, _nchw(x), "pool")
        logits = tinc.apply(tp, tcfg, _nchw(x), "logits")
        head = tlayers.linear(tp["fc"], torch.tensor(ref_pool))
    assert pool.shape == (2, 2048) and logits.shape == (2, 1000)
    assert pool.dtype == logits.dtype == torch.float32
    assert _rel(pool.numpy(), ref_pool) < TOL[dtype]
    # apply's "logits" tail: the fc head over the pool
    ref_logits = np.asarray(jlayers.linear(jp["fc"], jnp.asarray(ref_pool)))
    assert _rel(head.numpy(), ref_logits) < 1e-6
    if dtype == "float32":
        assert _rel(logits.numpy(), ref_logits) < TOL[dtype]
    else:
        torch.testing.assert_close(logits, tlayers.linear(tp["fc"], pool), rtol=0, atol=0)


def test_param_template_and_iter_conv_bn_follow_jax(weights):
    _, jp = weights
    tcfg = tinc.InceptionConfig(image_size=SIZE)
    template = tinc.param_template(tcfg)
    assert list(_flatten_tree(jax.tree_util.tree_map(lambda a: 0, jp))) == \
        list(_flatten_tree(jax.tree_util.tree_map(lambda a: 0, template)))

    def paths(tree, prefix=""):  # dict insertion order, the order the importers pair on
        if isinstance(tree, dict) and set(tree) != {"conv", "bn"}:
            return [p for k, v in tree.items() for p in paths(v, f"{prefix}{k}/")]
        return [prefix] if isinstance(tree, dict) else []

    assert paths(jp) == paths(template)
    j_units = list(jinc.iter_conv_bn(jp))
    t_units = list(tinc.iter_conv_bn(tinc.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")))
    assert len(t_units) == len(list(tinc.iter_conv_bn(template))) == len(j_units) == 94
    for t, j in zip(t_units, j_units):
        assert tuple(t["conv"]["w"].shape) == tuple(np.transpose(j["conv"]["w"], (3, 2, 0, 1)).shape)
        assert set(t["bn"]) == set(j["bn"])


def test_converters_round_trip(weights):
    _, jp = weights
    tp = inception_params_from_numpy(jp, "cpu")
    assert tp["stem"]["c1"]["conv"]["w"].shape == (32, 3, 3, 3)  # OIHW
    assert tp["mixed6b"]["b7x7_2"]["conv"]["w"].shape == (128, 128, 1, 7)
    assert tp["fc"]["w"].shape == (2048, 1000)
    back = inception_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("window,stride", [(3, 1), (3, 2)])
def test_avg_pool_divides_by_the_real_inputs(window, stride, padding):
    if padding == "SAME" and stride != 1:
        with pytest.raises(ValueError, match="not symmetric"):
            tlayers.avg_pool(torch.zeros(1, 2, 7, 7), window, stride, padding)
        return
    x = np.random.RandomState(2).randn(2, 7, 6, 5).astype(np.float32)
    ref = np.asarray(jlayers.avg_pool(jnp.asarray(x), window, stride, padding))
    got = tlayers.avg_pool(_nchw(x), window, stride, padding).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if padding == "SAME":  # a corner averages its 4 real inputs, not 9 with 5 zeros
        np.testing.assert_allclose(got[0, 0, 0], x[0, :2, :2].mean(axis=(0, 1)), rtol=1e-6)


def test_batch_norm_and_conv_bn_match_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 4, 6).astype(np.float32)
    bn = {"scale": rs.rand(6), "offset": rs.randn(6), "mean": rs.randn(6), "var": rs.rand(6) + 0.1}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    ref = np.asarray(jlayers.batch_norm(jax.tree_util.tree_map(jnp.asarray, bn), jnp.asarray(x)))
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    got = tlayers.batch_norm(tbn, _nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    conv = {"w": (rs.randn(3, 3, 6, 4) * 0.3).astype(np.float32), "b": rs.randn(4).astype(np.float32)}
    for stride, padding in (((1, 1), "SAME"), ((2, 2), "VALID")):
        ref = np.asarray(jlayers.conv_bn(jax.tree_util.tree_map(jnp.asarray, conv),
                                         jax.tree_util.tree_map(jnp.asarray, {k: v[:4] for k, v in bn.items()}),
                                         jnp.asarray(x), stride=stride, padding=padding))
        got = tlayers.conv_bn({"w": torch.from_numpy(np.transpose(conv["w"], (3, 2, 0, 1)).copy()),
                               "b": torch.from_numpy(conv["b"])},
                              {k: v[:4] for k, v in tbn.items()}, _nchw(x), stride[0], padding)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
        assert float(got.min()) >= 0


def test_inception_device_prepro_matches_jax():
    u8 = np.random.RandomState(4).randint(0, 256, (2, 5, 4, 3), dtype=np.uint8)
    u8[0, 0, 0] = [0, 128, 255]
    missing = np.array([False, True])
    ref = np.asarray(jimages.inception_device_prepro(jnp.asarray(u8), jnp.asarray(missing)))
    got = timages.inception_device_prepro(torch.from_numpy(u8), torch.from_numpy(missing))
    assert got.shape == (2, 3, 5, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_forward_flops_at_299():
    # 5.71 G multiply-adds in the convolutions, the published v3 count
    assert abs(tinc.forward_flops(tinc.InceptionConfig()) / 2e9 - 5.71) < 0.01


def test_extraction_cli_matches_jax_cli(weights, tmp_path, monkeypatch):
    """``--model inception`` through both CLIs on the same ``.npz`` weights
    and image files of other sizes than the net's: both center-crop and
    resize, each with PIL (the native decoders resize otherwise)."""
    rs = np.random.RandomState(5)
    for i, shape in enumerate([(90, 120, 3), (80, 80, 3), (130, 77, 3)]):
        Image.fromarray(rs.randint(0, 256, shape, dtype=np.uint8)).save(tmp_path / f"im{i}.png")
    (tmp_path / "data_prepro.json").write_text(json.dumps(
        {"unique_img_train": ["im0.png", "im1.png", "im2.png"], "unique_img_test": ["im2.png"]}))
    jsave_npz(str(tmp_path / "inc.npz"), weights[1])
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(timages, "default_decoder", lambda use_native=True: "pil")
    numpy_units(monkeypatch)  # the JAX CLI's template only: the weights come from the .npz
    argv = ["--input_json", str(tmp_path / "data_prepro.json"), "--image_root", str(tmp_path),
            "--image_size", str(SIZE), "--batch_size", "2", "--model", "inception",
            "--weights", str(tmp_path / "inc.npz")]
    jextract.main(argv + ["--out_name", str(tmp_path / "j.h5")])
    textract.main(argv + ["--out_name", str(tmp_path / "t.h5"), "--device", "cpu"])
    with h5py.File(tmp_path / "j.h5", "r") as j, h5py.File(tmp_path / "t.h5", "r") as t:
        assert sorted(t) == sorted(j) == ["images_test", "images_train"]
        for name, n in (("images_train", 3), ("images_test", 1)):
            ref, got = j[name][()], t[name][()]
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (n, 2048)
            assert _rel(got, ref) < TOL["float32"], name
