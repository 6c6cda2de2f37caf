"""The port's LSTM (``novel_vqa_torch.ops.lstm`` and the kernels' plain
versions) against the JAX package: the XLA path and the Pallas kernels run
in interpret mode.  Inputs come from a numpy seed and go to both packages.
Tolerance: rtol/atol 1e-5 forward, as in tests/test_pallas_lstm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.ops import lstm as jlstm
from novel_vqa_tpu.ops.pallas_lstm import pallas_lstm_encode, pallas_lstm_seq, pallas_lstm_step

from novel_vqa_torch.core.convert import lstm_params_from_numpy
from novel_vqa_torch.kernels import lstm as K
from novel_vqa_torch.ops import lstm as tlstm

TOL = dict(rtol=1e-5, atol=1e-5)


def _layers(sizes, seed):
    """JAX-initialized layers as numpy, for both packages."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(sizes))
    return [
        jax.device_get(jlstm.lstm_layer_init(k, i, h)) for k, (i, h) in zip(keys, sizes)
    ]


def _ragged(T, N, In, seed):
    """Right-aligned ragged activity, inputs zeroed before each row's start
    (mirrors tests/test_pallas_lstm.py:56-75)."""
    rs = np.random.RandomState(seed)
    xs = rs.randn(T, N, In).astype(np.float32)
    mask = np.zeros((T, N), np.float32)
    for i in range(N):
        L = rs.randint(1, T + 1)
        mask[T - L :, i] = 1.0
        xs[: T - L, i] = 0.0
    return xs, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def test_seq_plain_matches_pallas_seq_interpret():
    (layer,) = _layers([(8, 16)], seed=3)
    xs, mask = _ragged(6, 10, 8, seed=3)
    c_j, h_j, hs_j = pallas_lstm_seq(layer, jnp.asarray(xs), jnp.asarray(mask), tile_n=8, interpret=True)
    b = _t(layer["bx"] + layer["bh"])
    c_t, h_t, hs_t = K.lstm_seq_plain(_t(xs), _t(mask), _t(layer["wx"]), _t(layer["wh"]), b)
    for a, ref in ((c_t, c_j), (h_t, h_j), (hs_t, hs_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("pattern", ["leading", "interior", "none_active"])
def test_seq_plain_keeps_the_state_through_steps_no_row_takes(pattern):
    """A step on which no row is active leaves c and h as they are, for any
    mask: the seq kernel skips such a step's products and writes
    hs[t] = h.  The plain version against the Pallas kernel (interpret
    mode) on masks with such steps first, in the middle, and throughout."""
    (layer,) = _layers([(8, 16)], seed=5)
    xs, mask = _ragged(8, 10, 8, seed=5)
    idle = {"leading": [0, 1, 2], "interior": [3, 4], "none_active": list(range(8))}[pattern]
    mask[idle] = 0.0
    c_j, h_j, hs_j = pallas_lstm_seq(layer, jnp.asarray(xs), jnp.asarray(mask), tile_n=8, interpret=True)
    b = _t(layer["bx"] + layer["bh"])
    c_t, h_t, hs_t = K.lstm_seq_plain(_t(xs), _t(mask), _t(layer["wx"]), _t(layer["wh"]), b)
    for a, ref in ((c_t, c_j), (h_t, h_j), (hs_t, hs_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL)
    for t in idle:
        prev = hs_t[t - 1] if t > 0 else torch.zeros_like(hs_t[0])
        assert torch.equal(hs_t[t], prev)


def test_encode_matches_pallas_encode_and_jax_encode():
    layers = _layers([(8, 16), (16, 16)], seed=3)
    xs, mask = _ragged(6, 10, 8, seed=4)
    c_p, h_p = pallas_lstm_encode(layers, jnp.asarray(xs), jnp.asarray(mask), tile_n=8, interpret=True)
    c_x, h_x = jlstm.lstm_encode(layers, jnp.asarray(xs), jnp.asarray(mask))
    # the whole-sequence route: the seq wrapper, plain on CPU tensors
    c_t, h_t = tlstm.lstm_encode(lstm_params_from_numpy(layers, "cpu"), _t(xs), _t(mask))
    assert c_t.shape == (2, 10, 16)
    for ref_c, ref_h in ((c_p, h_p), (c_x, h_x)):
        np.testing.assert_allclose(c_t.numpy(), np.asarray(ref_c), **TOL)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(ref_h), **TOL)


@pytest.mark.parametrize("In,H", [(16, 32), (24, 40), (13, 37)])
@pytest.mark.parametrize("N", [20, 13, 65])
def test_step_matches_pallas_step_interpret(N, In, H):
    # At the step kernel's tile edges: N=13 and 20 are not multiples of the
    # Pallas tile (its padding path), N=65 is one row past the CUDA kernel's
    # 64-row tile; H=40 and 37 leave a partial 32-unit tile, In=24 and 13 a
    # partial 16-k stage, and In=13, H=37 rows that are not 16-byte aligned.
    (layer,) = _layers([(In, H)], seed=0)
    rs = np.random.RandomState(N)
    x = rs.randn(N, In).astype(np.float32)
    c = rs.randn(N, H).astype(np.float32)
    h = rs.randn(N, H).astype(np.float32)
    c_j, h_j = pallas_lstm_step(layer, jnp.asarray(x), jnp.asarray(c), jnp.asarray(h), tile_n=8, interpret=True)
    b = _t(layer["bx"] + layer["bh"])
    c_plain, h_plain = K.lstm_step_plain(_t(x), _t(h), _t(c), _t(layer["wx"]), _t(layer["wh"]), b)
    (tlayer,) = lstm_params_from_numpy([layer], "cpu")
    c_op, h_op = tlstm.lstm_step(tlayer, _t(x), _t(c), _t(h))
    for got in ((c_plain, h_plain), (c_op, h_op)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(c_j), **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(h_j), **TOL)


def test_stack_step_matches_jax():
    layers = _layers([(8, 16), (16, 16)], seed=5)
    rs = np.random.RandomState(5)
    x = rs.randn(9, 8).astype(np.float32)
    c = rs.randn(2, 9, 16).astype(np.float32)
    h = rs.randn(2, 9, 16).astype(np.float32)
    c_j, h_j = jlstm.lstm_stack_step(layers, jnp.asarray(x), (jnp.asarray(c), jnp.asarray(h)))
    c_t, h_t = tlstm.lstm_stack_step(lstm_params_from_numpy(layers, "cpu"), _t(x), (_t(c), _t(h)))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


@pytest.mark.parametrize("with_init", [False, True])
def test_encode_return_sequence_and_init_state_match_jax(with_init):
    layers = _layers([(8, 16), (16, 16)], seed=6)
    xs, mask = _ragged(7, 11, 8, seed=6)
    rs = np.random.RandomState(7)
    init = (
        (rs.randn(2, 11, 16).astype(np.float32), rs.randn(2, 11, 16).astype(np.float32))
        if with_init else None
    )
    j_init = None if init is None else tuple(jnp.asarray(a) for a in init)
    t_init = None if init is None else tuple(_t(a) for a in init)
    tp = lstm_params_from_numpy(layers, "cpu")

    (c_j, h_j), (cs_j, hs_j) = jlstm.lstm_encode(
        layers, jnp.asarray(xs), jnp.asarray(mask), init_state=j_init, return_sequence=True
    )
    (c_t, h_t), (cs_t, hs_t) = tlstm.lstm_encode(
        tp, _t(xs), _t(mask), init_state=t_init, return_sequence=True
    )
    assert cs_t.shape == (7, 2, 11, 16)
    for a, ref in ((c_t, c_j), (h_t, h_j), (cs_t, cs_j), (hs_t, hs_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL)

    if with_init:  # the per-step route without the sequence
        c2_j, h2_j = jlstm.lstm_encode(layers, jnp.asarray(xs), jnp.asarray(mask), init_state=j_init)
        c2_t, h2_t = tlstm.lstm_encode(tp, _t(xs), _t(mask), init_state=t_init)
        np.testing.assert_allclose(c2_t.numpy(), np.asarray(c2_j), **TOL)
        np.testing.assert_allclose(h2_t.numpy(), np.asarray(h2_j), **TOL)


def test_pack_unpack_state_round_trip_and_layout():
    rs = np.random.RandomState(8)
    c = rs.randn(3, 5, 4).astype(np.float32)
    h = rs.randn(3, 5, 4).astype(np.float32)
    packed = tlstm.pack_state(_t(c), _t(h))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jlstm.pack_state(jnp.asarray(c), jnp.asarray(h)))
    )
    c2, h2 = tlstm.unpack_state(packed, 3)
    np.testing.assert_array_equal(c2.numpy(), c)
    np.testing.assert_array_equal(h2.numpy(), h)


def test_layer_init_shapes_and_range():
    layer = tlstm.lstm_layer_init(torch.Generator().manual_seed(0), 8, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in layer.items()} == {
        "wx": (8, 64), "bx": (64,), "wh": (16, 64), "bh": (64,)
    }
    assert all(float(v.abs().max()) <= 0.08 for v in layer.values())


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    launch: a count can only come from the CUDA kernel."""
    before = (K.lstm_seq.launches, K.lstm_step.launches)
    layers = lstm_params_from_numpy(_layers([(8, 16)], seed=9), "cpu")
    xs, mask = _ragged(4, 5, 8, seed=9)
    tlstm.lstm_encode(layers, _t(xs), _t(mask))
    tlstm.lstm_encode(layers, _t(xs), _t(mask), return_sequence=True)
    assert (K.lstm_seq.launches, K.lstm_step.launches) == before
