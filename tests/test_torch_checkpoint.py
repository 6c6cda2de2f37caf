"""The port's own copies of the checkpoint, config and alignment helpers
against the JAX package's, and the weight conversion round trips."""

import dataclasses

import jax
import numpy as np
import pytest

from novel_vqa_tpu.core import checkpoint as jckpt
from novel_vqa_tpu.core.config import add_dataclass_args as j_add_dataclass_args
from novel_vqa_tpu.data.align import right_align
from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.ops.lstm import lstm_layer_init as j_lstm_layer_init

from novel_vqa_torch.core import checkpoint as tckpt
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import (
    arch1_params_from_numpy,
    arch1_params_to_numpy,
    lstm_params_from_numpy,
    lstm_params_to_numpy,
)
from novel_vqa_torch.data.align import right_align_fast
from novel_vqa_torch.models.vqa import arch1 as tarch1

CFG = dict(
    vocab_size=25, input_encoding_size=6, rnn_size=8, rnn_layer=2,
    nhimage=10, common_embedding_size=5, num_output=4,
)


def _jax_params():
    cfg = jarch1.Arch1Config(**CFG)
    return cfg, jax.device_get(jarch1.init_params(jax.random.PRNGKey(0), cfg))


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_arch1_flat_round_trip_and_equality_with_jax():
    cfg, params = _jax_params()
    flat_t = tckpt.arch1_to_flat(params)
    flat_j = jckpt.arch1_to_flat(params)
    _assert_tree_equal(flat_t, flat_j)
    back_t = tckpt.arch1_from_flat(flat_t, tarch1.Arch1Config(**CFG))
    _assert_tree_equal(back_t, jckpt.arch1_from_flat(flat_j, cfg))
    _assert_tree_equal(back_t, params)


def test_lstm_flat_equality_with_jax():
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    layers = [jax.device_get(j_lstm_layer_init(keys[0], 6, 8)),
              jax.device_get(j_lstm_layer_init(keys[1], 8, 8))]
    vec = tckpt.lstm_params_to_flat(layers)
    np.testing.assert_array_equal(vec, jckpt.lstm_params_to_flat(layers))
    _assert_tree_equal(tckpt.lstm_params_from_flat(vec, 6, 8, 2), layers)
    with pytest.raises(ValueError, match="size mismatch"):
        tckpt.lstm_params_from_flat(vec[:-1], 6, 8, 2)


def test_flat_h5_interchange_between_packages(tmp_path):
    cfg, params = _jax_params()
    path = str(tmp_path / "lstm.h5")
    jckpt.save_flat_h5(path, jckpt.arch1_to_flat(params))
    _assert_tree_equal(
        tckpt.arch1_from_flat(tckpt.load_flat_h5(path), tarch1.Arch1Config(**CFG)), params
    )
    path2 = str(tmp_path / "lstm2.h5")
    tckpt.save_flat_h5(path2, tckpt.arch1_to_flat(params))
    _assert_tree_equal(jckpt.load_flat_h5(path2), jckpt.load_flat_h5(path))


def test_params_numpy_round_trip():
    _, params = _jax_params()
    tp = arch1_params_from_numpy(params, "cpu")
    assert tp["encoder"][1]["wh"].dtype.is_floating_point
    assert tuple(tp["fusion"]["wi"].shape) == (CFG["nhimage"], CFG["common_embedding_size"])
    _assert_tree_equal(arch1_params_to_numpy(tp), params)
    layers = params["encoder"]
    _assert_tree_equal(lstm_params_to_numpy(lstm_params_from_numpy(layers, "cpu")), layers)


def test_right_align_fast_matches_jax_loop():
    rs = np.random.RandomState(0)
    seq = rs.randint(1, 9, size=(7, 5)).astype(np.int32)
    lengths = np.array([0, 1, 5, 3, 2, 4, 5])
    for i, n in enumerate(lengths):
        seq[i, n:] = 0
    np.testing.assert_array_equal(right_align_fast(seq, lengths), right_align(seq, lengths))


def test_parse_config_matches_jax_flag_handling():
    import argparse

    @dataclasses.dataclass
    class Cfg:
        batch_size: int = 500
        learning_rate: float = 3e-4
        fusion: str = "axb"
        flag: bool = False

    argv = ["--batch_size", "64", "--learning_rate", "1e-3", "--fusion", "askipb", "--flag", "yes"]
    parser = argparse.ArgumentParser()
    j_add_dataclass_args(parser, Cfg)
    assert dataclasses.asdict(parse_config(Cfg, argv)) == vars(parser.parse_args(argv))
