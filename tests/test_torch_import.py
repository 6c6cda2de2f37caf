"""The port's weight importers against the JAX package's tools, on the CPU:
its Torch7 reader and writer (``core/t7.py``), the four ``import_t7``
subcommands on synthetic t7 files, and ``import_pth`` on a synthetic
torchvision-named state dict.  Outputs must be equal: the same keys and
equal arrays (bytes, for the t7 files)."""

import functools

import h5py
import numpy as np
import pytest
import torch

from novel_vqa_tpu.core import t7 as jt7
from novel_vqa_tpu.models.vision import inception as jinc
from novel_vqa_tpu.train import import_pth as jpth
from novel_vqa_tpu.train import import_t7 as jimport
from novel_vqa_torch.core import t7 as tt7
from novel_vqa_torch.core.checkpoint import load_npz, unflatten_like
from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.models.vision import inception as tinc
from novel_vqa_torch.train import import_pth as tpth
from novel_vqa_torch.train import import_t7 as timport


def _obj(shared: bool):
    """A t7 object using every wire type the writer has: nested tables
    (dict and list), numbers, strings, booleans, tensors of each dtype;
    with ``shared`` one table referenced twice (written once, then by its
    index; both readers give it back as a list, then as the table)."""
    rs = np.random.RandomState(0)
    obj = {"encoder_w_q": rs.randn(7).astype(np.float32), "w64": rs.randn(2, 3),
           "ints": np.arange(6, dtype=np.int64).reshape(3, 2), "i32": np.arange(4, dtype=np.int32),
           "bytes": np.arange(5, dtype=np.uint8), "name": "lstm", "flag": True, "n": 3, "x": 0.25,
           "nested": {"k": [np.ones((2, 2), np.float32)]}}
    if shared:
        obj["a"] = obj["b"] = [1, 2.5, "x"]
    return obj


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("shared", [False, True])
def test_t7_writers_write_the_same_bytes_and_readers_agree(tmp_path, shared):
    obj = _obj(shared)
    jt7.save(str(tmp_path / "j.t7"), obj)
    tt7.save(str(tmp_path / "t.t7"), obj)
    assert (tmp_path / "t.t7").read_bytes() == (tmp_path / "j.t7").read_bytes()
    # the port reads what JAX wrote, JAX reads what the port wrote, equal to each other
    got, ref = tt7.load(str(tmp_path / "j.t7")), jt7.load(str(tmp_path / "t.t7"))
    _equal(got, ref)
    if not shared:  # and the port's round trip is byte-exact
        _equal(got, obj)
        tt7.save(str(tmp_path / "t2.t7"), got)
        assert (tmp_path / "t2.t7").read_bytes() == (tmp_path / "t.t7").read_bytes()


def test_t7_reader_refuses_an_unknown_typecode(tmp_path):
    (tmp_path / "bad.t7").write_bytes(np.int32(42).tobytes())
    with pytest.raises(ValueError, match="unknown t7 typecode"):
        tt7.load(str(tmp_path / "bad.t7"))


def _run_both(argv_of):
    jimport.main(argv_of("j"))
    timport.main(argv_of("t"))


def test_import_and_export_flat_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    vectors = {k: rs.randn(n).astype(np.float32) for k, n in
               (("encoder_w_q", 40), ("embedding_w_q", 12), ("multimodal_w", 30))}
    jt7.save(str(tmp_path / "lstm.t7"), dict(vectors, opt="not an array"))
    _run_both(lambda p: ["import-flat", "--t7", str(tmp_path / "lstm.t7"),
                         "--out", str(tmp_path / f"{p}.h5")])
    with h5py.File(tmp_path / "j.h5", "r") as j, H5Reader(str(tmp_path / "t.h5")) as t:
        assert sorted(t.keys()) == sorted(j) == sorted(vectors)
        for k in vectors:
            np.testing.assert_array_equal(t[k], j[k][()])
            assert t[k].dtype == j[k].dtype == np.float32
    _run_both(lambda p: ["export-flat", "--h5", str(tmp_path / "t.h5"),
                         "--out", str(tmp_path / f"{p}.t7")])
    assert (tmp_path / "t.t7").read_bytes() == (tmp_path / "j.t7").read_bytes()
    _equal(tt7.load(str(tmp_path / "t.t7")), vectors)


@pytest.mark.parametrize("multimodal", [False, True])
def test_import_ae_transfer_matches_jax(tmp_path, multimodal):
    rs = np.random.RandomState(2)
    obj = {"lookup": rs.randn(6, 11).astype(np.float32), "encoder": rs.randn(50).astype(np.float32)}
    if multimodal:
        obj["multimodal"] = rs.randn(20).astype(np.float32)
    jt7.save(str(tmp_path / "ae.t7"), obj)
    _run_both(lambda p: ["import-ae-transfer", "--t7", str(tmp_path / "ae.t7"),
                         "--out", str(tmp_path / f"{p}.h5")])
    with h5py.File(tmp_path / "j.h5", "r") as j, h5py.File(tmp_path / "t.h5", "r") as t:
        assert sorted(t) == sorted(j) == sorted(obj)
        for k in obj:
            np.testing.assert_array_equal(t[k][()], j[k][()])
            assert t[k].dtype == j[k].dtype == np.float32


def _module(cls, **attrs):
    return tt7.TorchObject(cls, attrs)


class _NetWriter(tt7.T7Writer):
    """The t7 writer plus nn modules (a class header, then the attribute
    table), as Torch7 saves a network; the importers need no writer of
    them."""

    def write_object(self, obj):
        if isinstance(obj, tt7.TorchObject):
            self._write_torch_header(obj.torch_typename)
            super().write_object(obj.attrs)
        else:
            super().write_object(obj)


def _save_net(path, net):
    with open(path, "wb") as f:
        _NetWriter(f).write_object(net)


def _cheap_jax_template(monkeypatch):
    """The JAX importer builds its Inception template with ``jax.random``
    per unit (seconds on the CPU) and then overwrites every leaf: give it
    zeros of the same shapes."""
    monkeypatch.setattr(jinc, "_cbr_init", lambda rng, kh, kw, c_in, c_out: {
        "conv": {"w": np.zeros((kh, kw, c_in, c_out), np.float32)},
        "bn": {k: np.zeros(c_out, np.float32) for k in ("scale", "offset", "mean", "var")}})
    monkeypatch.setattr(jinc, "linear_init", lambda rng, n_in, n_out: {
        "w": np.zeros((n_in, n_out), np.float32), "b": np.zeros(n_out, np.float32)})


@pytest.mark.parametrize("arch,bgr_to_rgb", [("vgg16", 0), ("vgg16", 1), ("vggembed", 0)])
def test_import_vision_vgg_matches_jax(tmp_path, arch, bgr_to_rgb):
    """A small loadcaffe-style nn.Sequential: convs with biases, ReLUs,
    pools and three Linears."""
    rs = np.random.RandomState(3)
    mods = []
    for c_in, c_out in ((3, 4), (4, 5), (5, 5)):
        mods += [_module("nn.SpatialConvolution", weight=rs.randn(c_out, c_in, 3, 3).astype(np.float32),
                         bias=rs.randn(c_out).astype(np.float32)), _module("nn.ReLU")]
    for n_in, n_out in ((20, 8), (8, 8), (8, 6)):
        mods.append(_module("nn.Linear", weight=rs.randn(n_out, n_in).astype(np.float32),
                            bias=rs.randn(n_out).astype(np.float32)))
    _save_net(tmp_path / "vgg.t7", _module("nn.Sequential", modules=mods))
    _run_both(lambda p: ["import-vision", "--t7", str(tmp_path / "vgg.t7"), "--arch", arch,
                         "--bgr_to_rgb", str(bgr_to_rgb), "--out", str(tmp_path / f"{p}.npz")])
    j, t = dict(np.load(tmp_path / "j.npz")), dict(np.load(tmp_path / "t.npz"))
    assert sorted(t) == sorted(j)
    assert ("embed/w" in t) == (arch == "vggembed")
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype == np.float32


@functools.lru_cache(maxsize=None)
def _unit_shapes():
    """The 94 units' OIHW conv shapes, in definition order."""
    params = tinc.init_params(tinc.InceptionConfig(), torch.Generator().manual_seed(0), "cpu")
    return [tuple(u["conv"]["w"].shape) for u in tinc.iter_conv_bn(params)]


def _inception_t7(rs):
    """A t7 Inception graph in definition order (stem first: the order of a
    real v3 graph) and its source tree, in the port's template."""
    tree = tinc.param_template(tinc.InceptionConfig())
    mods = []
    for unit, (c_out, c_in, kh, kw) in zip(tinc.iter_conv_bn(tree), _unit_shapes()):
        unit["conv"]["w"] = rs.randn(kh, kw, c_in, c_out).astype(np.float32)
        unit["bn"] = {k: rs.randn(c_out).astype(np.float32) for k in ("scale", "offset", "mean", "var")}
        mods += [_module("nn.SpatialConvolution", weight=np.transpose(unit["conv"]["w"], (3, 2, 0, 1)).copy()),
                 _module("nn.SpatialBatchNormalization", weight=unit["bn"]["scale"], bias=unit["bn"]["offset"],
                         running_mean=unit["bn"]["mean"], running_var=unit["bn"]["var"]),
                 _module("nn.ReLU")]
    tree["fc"] = {"w": rs.randn(2048, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    mods.append(_module("nn.Linear", weight=tree["fc"]["w"].T.copy(), bias=tree["fc"]["b"]))
    return tree, _module("nn.Sequential", modules=mods)


def test_import_vision_inception_pairs_in_graph_order(tmp_path, monkeypatch):
    """The port places each of the 94 units of a stem-first graph where its
    template says.  The JAX tool pairs them in the sorted-key order of a
    ``jax.device_get`` tree (fc, mixed5b, ..., stem): it puts the graph's
    first conv on ``mixed5b/b1x1`` (ROADMAP section C)."""
    rs = np.random.RandomState(4)
    tree, net = _inception_t7(rs)
    _save_net(tmp_path / "inc.t7", net)
    _cheap_jax_template(monkeypatch)
    _run_both(lambda p: ["import-vision", "--t7", str(tmp_path / "inc.t7"), "--arch", "inception",
                         "--out", str(tmp_path / f"{p}.npz")])
    flat, _ = load_npz(str(tmp_path / "t.npz"))
    got = unflatten_like(tinc.param_template(tinc.InceptionConfig()), flat)
    for a, b in zip(tinc.iter_conv_bn(got), tinc.iter_conv_bn(tree)):
        np.testing.assert_array_equal(a["conv"]["w"], b["conv"]["w"])
        for k in b["bn"]:
            np.testing.assert_array_equal(a["bn"][k], b["bn"][k])
    np.testing.assert_array_equal(got["fc"]["w"], tree["fc"]["w"])
    j = dict(np.load(tmp_path / "j.npz"))
    assert sorted(j) == sorted(flat)
    first = np.transpose(net["modules"][0]["weight"], (2, 3, 1, 0))
    np.testing.assert_array_equal(j["mixed5b/b1x1/conv/w"], first)
    assert not np.array_equal(j["stem/c1/conv/w"], flat["stem/c1/conv/w"])


def test_import_vision_inception_refuses_an_aux_head(tmp_path):
    _, net = _inception_t7(np.random.RandomState(5))
    net["modules"].append(_module("nn.SpatialConvolution", weight=np.zeros((2, 2, 1, 1), np.float32)))
    with pytest.raises(ValueError, match="94 conv"):
        timport.inception_t7_to_npz(net, str(tmp_path / "x.npz"))


def _vgg_state_dict(rs, arch):
    sd, idx = {}, 0
    c_in = 3
    for c_out in [4] * {"vgg16": 13, "vgg19": 16}[arch]:
        sd[f"features.{idx}.weight"] = torch.from_numpy(rs.randn(c_out, c_in, 3, 3).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rs.randn(c_out).astype(np.float32))
        idx += 2  # conv, ReLU (and pools in between: the indices have gaps)
        c_in = c_out
    for i, (n_in, n_out) in zip((0, 3, 6), ((16, 8), (8, 8), (8, 5))):
        sd[f"classifier.{i}.weight"] = torch.from_numpy(rs.randn(n_out, n_in).astype(np.float32))
        sd[f"classifier.{i}.bias"] = torch.from_numpy(rs.randn(n_out).astype(np.float32))
    return sd


def _inception_state_dict(rs):
    """torchvision's names for every unit, the aux head included (dropped)."""
    tree = tinc.param_template(tinc.InceptionConfig())
    sd = {}
    names = [(tv, tree["stem"][ours]) for tv, ours in tpth._STEM_MAP]
    for block in tpth._MIXED:
        for key, unit in tree[block.replace("Mixed_", "mixed").lower()].items():
            names.append((f"{block}.{tpth._tv_branch(key)}", unit))
    by_id = {id(u): s for u, s in zip(tinc.iter_conv_bn(tree), _unit_shapes())}
    for prefix, unit in names:
        c_out = by_id[id(unit)][0]
        sd[f"{prefix}.conv.weight"] = torch.from_numpy(rs.randn(*by_id[id(unit)]).astype(np.float32))
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.bn.{k}"] = torch.from_numpy(rs.randn(c_out).astype(np.float32))
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"] = torch.from_numpy(rs.randn(1000, 2048).astype(np.float32))
    sd["fc.bias"] = torch.from_numpy(rs.randn(1000).astype(np.float32))
    return sd


@pytest.mark.parametrize("arch", ["vgg16", "vgg19", "inception"])
def test_import_pth_matches_jax(tmp_path, arch, monkeypatch):
    _cheap_jax_template(monkeypatch)
    rs = np.random.RandomState(6)
    sd = _inception_state_dict(rs) if arch == "inception" else _vgg_state_dict(rs, arch)
    torch.save(sd, tmp_path / "w.pth")
    for p, mod in (("j", jpth), ("t", tpth)):
        mod.main(["--pth", str(tmp_path / "w.pth"), "--arch", arch, "--out", str(tmp_path / f"{p}.npz")])
    j, t = dict(np.load(tmp_path / "j.npz")), dict(np.load(tmp_path / "t.npz"))
    assert sorted(t) == sorted(j)
    assert len(t) == (94 * 5 + 2 if arch == "inception" else 2 * {"vgg16": 16, "vgg19": 19}[arch])
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype == np.float32


def test_import_pth_refuses_a_wrong_conv_count(tmp_path):
    sd = _vgg_state_dict(np.random.RandomState(7), "vgg16")
    with pytest.raises(ValueError, match="vgg19 expects 16 convs"):
        tpth.import_vgg(sd, "vgg19")
