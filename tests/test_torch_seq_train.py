"""Training through the seq kernel (``ops/lstm_vjp.py``, the routing in
``ops/lstm.py``) against the JAX package's custom VJP
(``ops/pallas_lstm.py``, Pallas in interpret mode) and its trainer's loss
and gradients.  Inputs come from numpy seeds; widths are small.

On the CPU the kernel wrapper runs its plain version, so the Function's
forward is the plain layer and its backward is the written-out one under
test.  The route takes only CUDA tensors; the slice tests force it on
CPU tensors by patching that one test (``ops/lstm._on_card``), at
``rnn_size`` 128, the route's width gate.
Tolerance: 1e-5 (rtol and atol) throughout, both sides f32 and the same
math, summed in other orders."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.ops import lstm as jlstm
from novel_vqa_tpu.ops import pallas_lstm as pl

from novel_vqa_torch.core.convert import arch1_params_from_numpy, lstm_params_from_numpy
from novel_vqa_torch.core.tree import tree_leaves, value_and_grad
from novel_vqa_torch.kernels import lstm as K
from novel_vqa_torch.kernels import lstm2 as K2
from novel_vqa_torch.models.vqa import arch1 as tarch1
from novel_vqa_torch.ops import lstm as tlstm
from novel_vqa_torch.ops import lstm_vjp
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.lstm2 import _layer_reverse_step, _rebuild_c
from novel_vqa_torch.parallel.mesh import DPGroup

TOL = dict(rtol=1e-5, atol=1e-5)
T, In, H = 5, 6, 8


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mask(rs, N, kind, T_=T):
    """Right-aligned lengths 1..T ("ragged"), or left-aligned lengths
    1..T-g with no row active on steps g and g+1, g = T // 4 ("gaps")."""
    if kind == "ragged":
        lengths = rs.randint(1, T_ + 1, size=N)
        return (np.arange(T_)[:, None] >= (T_ - lengths)[None, :]).astype(np.float32)
    g = max(T_ // 4, 1)
    lengths = rs.randint(1, T_ - g + 1, size=N)
    mask = (np.arange(T_)[:, None] < lengths[None, :]).astype(np.float32)
    mask[g:g + 2] = 0.0
    return mask


def _layers(seed, sizes=((In, H), (H, H))):
    k = jax.random.PRNGKey(seed)
    return [jax.device_get(jlstm.lstm_layer_init(jax.random.fold_in(k, i), n_in, n_h))
            for i, (n_in, n_h) in enumerate(sizes)]


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a function or a Function's
    ``apply``), still calling it."""
    real = getattr(module, name)
    fn = real.apply if isinstance(real, type) else real
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    spy = type(name, (), {"apply": staticmethod(counted)}) if isinstance(real, type) else counted
    monkeypatch.setattr(module, name, spy)
    return calls


# ---------------------------------------------------------------------------
# the Functions against the custom VJPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ragged", "gaps"])
def test_fused_seq_forward_and_grads_match_jax(kind):
    """``FusedSeq`` against ``jax.grad`` through ``pallas_lstm_seq`` (the
    ``_seq_bwd`` custom VJP), cotangents on all three outputs (c, h, hs),
    gradients to xs, wx, wh and both biases."""
    N = 9
    rs = np.random.RandomState(3 if kind == "ragged" else 4)
    layer = _layers(5, ((In, H),))[0]
    xs = rs.randn(T, N, In).astype(np.float32)
    mask = _mask(rs, N, kind)
    wc, wh_, whs = rs.randn(N, H), rs.randn(N, H), rs.randn(T, N, H)

    def j_loss(p, xs_):
        c, h, hs = pl.pallas_lstm_seq(p, xs_, jnp.asarray(mask), tile_n=8, interpret=True)
        return jnp.sum(c * wc) + jnp.sum(jnp.sin(h) * wh_) + jnp.sum(hs * whs)

    jp = jax.tree_util.tree_map(jnp.asarray, layer)
    j_val, (j_gp, j_gxs) = jax.value_and_grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(xs))

    tp = lstm_params_from_numpy([layer], "cpu")[0]
    for v in tp.values():
        v.requires_grad_()
    t_xs = _t(xs).requires_grad_()
    c, h, hs = lstm_vjp.FusedSeq.apply(t_xs, _t(mask), tp["wx"], tp["wh"], tp["bx"] + tp["bh"])
    for got, ref in zip((c, h, hs), pl.pallas_lstm_seq(jp, jnp.asarray(xs), jnp.asarray(mask),
                                                        tile_n=8, interpret=True)):
        _close(got, ref)
    loss = (c * _t(wc)).sum() + (torch.sin(h) * _t(wh_)).sum() + (hs * _t(whs)).sum()
    _close(loss, j_val)
    loss.backward()
    _close(t_xs.grad, j_gxs)
    for k in ("wx", "wh", "bx", "bh"):
        _close(tp[k].grad, j_gp[k])


# ---------------------------------------------------------------------------
# the seq backward kernel's plain version and wrapper
# ---------------------------------------------------------------------------

def _bwd_case(kind, T_=T, N=7, H_=H, seed=13):
    """Inputs of ``lstm_seq_backward``: gate pre-activations, a mask of
    ``kind`` ("full": every row on every step; "ragged": right-aligned
    lengths 1..T; "masked_step": ragged, with no row active on step T // 2),
    Wh and the three cotangents."""
    rs = np.random.RandomState(seed)
    if kind == "full":
        mask = np.ones((T_, N), np.float32)
    else:
        mask = _mask(rs, N, "ragged", T_)
        if kind == "masked_step":
            mask[T_ // 2] = 0.0
    return (_t(2.0 * rs.randn(T_, N, 4 * H_)), _t(mask), _t(0.3 * rs.randn(H_, 4 * H_)),
            _t(rs.randn(T_, N, H_)), _t(rs.randn(N, H_)), _t(rs.randn(N, H_)))


def _scan_through_lstm2_helpers(gates, mask, wh, dhs, dh_fin, dc_fin):
    """The seq backward's rebuild and reverse scan through ``Fused2``'s
    helpers, ``ops/lstm2._rebuild_c`` and ``_layer_reverse_step``: the
    reference the plain version is held to."""
    m = mask[..., None]
    i, f, o, g = K.gate_activations(gates)
    c_new, c_prev = _rebuild_c(i, f, g, m)
    tanh_c = torch.tanh(c_new)
    dh_c, dc_c = dh_fin, dc_fin
    dgates = [None] * gates.shape[0]
    for t in reversed(range(gates.shape[0])):
        dgates[t], dh_pass, dc_c = _layer_reverse_step(
            dhs[t], dh_c, dc_c, i[t], f[t], o[t], g[t], c_prev[t], tanh_c[t], m[t])
        dh_c = dgates[t] @ wh.t() + dh_pass
    return torch.stack(dgates)


@pytest.mark.parametrize("kind, T_", [("full", T), ("ragged", T), ("masked_step", T),
                                      ("ragged", 1), ("ragged", 16)])
def test_lstm_seq_backward_plain_is_the_helpers_scan(kind, T_):
    """``lstm_seq_backward_plain`` gives, bit for bit, the gate derivatives
    of the rebuild and reverse scan through the ``ops/lstm2`` helpers."""
    args = _bwd_case(kind, T_)
    got = K.lstm_seq_backward_plain(*args)
    assert got.shape == args[0].shape
    assert torch.equal(got, _scan_through_lstm2_helpers(*args))
    if kind == "masked_step":  # no row active: zero derivatives
        assert not got[T_ // 2].any()


def test_lstm_seq_backward_runs_plain_on_cpu_and_counts_no_launch():
    """On CPU tensors the wrapper is the plain version (its inputs left as
    they were) and counts no launch."""
    args = _bwd_case("ragged")
    copies = [a.clone() for a in args]
    before = K.lstm_seq_backward.launches
    got = K.lstm_seq_backward(*args)
    assert torch.equal(got, K.lstm_seq_backward_plain(*copies))
    assert all(torch.equal(a, b) for a, b in zip(args, copies))
    assert K.lstm_seq_backward.launches == before


def _bwd_bad(case):
    gates, mask, wh, dhs, dh_fin, dc_fin = _bwd_case("ragged")
    if case == "shape":
        dhs = dhs[:, :-1]
    elif case == "mask_shape":
        mask = mask[:-1]
    elif case == "non_contiguous":
        gates = gates.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "device":
        gates, mask, wh, dhs, dh_fin, dc_fin = (a.to("meta") for a in (gates, mask, wh, dhs, dh_fin, dc_fin))
    return gates, mask, wh, dhs, dh_fin, dc_fin


@pytest.mark.parametrize("case, match", [("shape", "dhs: shape"), ("mask_shape", "mask: shape"),
                                         ("non_contiguous", "gates: must be contiguous"),
                                         ("device", "unsupported device")])
def test_lstm_seq_backward_refuses_what_it_cannot_take(case, match):
    """A wrong shape, a non-contiguous input or a device other than the CPU
    and CUDA raises, on every device, before any work."""
    with pytest.raises(ValueError, match=match):
        K.lstm_seq_backward(*_bwd_bad(case))


def _encode_case(seed, N=7):
    rs = np.random.RandomState(seed)
    return _layers(seed), rs.randn(T, N, In).astype(np.float32), _mask(rs, N, "ragged")


def test_seq_encode_train_rate0_matches_jax_encode_train():
    """At rate 0, loss and gradients of ``seq_encode_train`` against
    ``pallas_lstm_encode_train`` (mirrors tests/test_pallas_lstm.py:118-149);
    the last layer's hs is unused, so it gets a zero cotangent."""
    layers, xs, mask = _encode_case(6)

    def j_loss(p):
        c, h = pl.pallas_lstm_encode_train(p, jnp.asarray(xs), jnp.asarray(mask), 0.0,
                                           jax.random.PRNGKey(7), tile_n=8, interpret=True)
        return jnp.sum(h * h) + jnp.sum(jnp.sin(c))

    jp = jax.tree_util.tree_map(jnp.asarray, layers)
    j_val, j_grads = jax.value_and_grad(j_loss)(jp)

    tp = lstm_params_from_numpy(layers, "cpu")
    t_val, t_grads = value_and_grad(
        lambda p: (lambda c, h: (h * h).sum() + torch.sin(c).sum())(
            *lstm_vjp.seq_encode_train(p, _t(xs), _t(mask), 0.0, None)))(tp)
    _close(t_val, j_val)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    t_leaves = tree_leaves(t_grads)
    assert len(t_leaves) == len(j_leaves) == 8
    for got, ref in zip(t_leaves, j_leaves):
        _close(got, ref)


def _by_hand(layers, xs, mask, drop):
    """Two ``FusedSeq`` layers, layer 2 fed layer 1's hs times ``drop``."""
    l1, l2 = layers
    c1, h1, hs1 = lstm_vjp.FusedSeq.apply(xs, mask, l1["wx"], l1["wh"], l1["bx"] + l1["bh"])
    c2, h2, _ = lstm_vjp.FusedSeq.apply(hs1 * drop, mask, l2["wx"], l2["wh"], l2["bx"] + l2["bh"])
    return torch.stack([c1, c2]), torch.stack([h1, h2])


def test_seq_encode_train_rate_half_is_fused_seq_fed_its_mask():
    """At rate 0.5 one (T, N, H) multiplier in {0, 2} is drawn per layer
    boundary, and the encode equals the Functions fed it (as
    tests/test_torch_fused2.py does for the seq2 route)."""
    layers, xs, mask = _encode_case(8)
    tp = lstm_params_from_numpy(layers, "cpu")
    got = lstm_vjp.seq_encode_train(tp, _t(xs), _t(mask), 0.5, torch.Generator().manual_seed(3))
    drop = dropout(torch.ones(T, 7, H), 0.5, torch.Generator().manual_seed(3), False)
    assert set(torch.unique(drop).tolist()) == {0.0, 2.0}
    ref = _by_hand(tp, _t(xs), _t(mask), drop)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_seq_encode_train_dp_masks_are_the_global_masks_slices():
    """On a DP group of two each rank draws the global batch's (T, 2N, H)
    mask and keeps its rows: the two ranks' encodes are the one process's
    encode of the whole batch, row for row."""
    layers, xs, mask = _encode_case(9, N=8)
    tp = lstm_params_from_numpy(layers, "cpu")
    whole = lstm_vjp.seq_encode_train(tp, _t(xs), _t(mask), 0.5, torch.Generator().manual_seed(4))
    for rank in range(2):
        rows = slice(4 * rank, 4 * rank + 4)
        part = lstm_vjp.seq_encode_train(tp, _t(xs[:, rows]), _t(mask[:, rows]), 0.5,
                                         torch.Generator().manual_seed(4),
                                         dp=DPGroup(rank, 2, torch.device("cpu")))
        for a, b in zip(part, whole):
            assert torch.equal(a, b[:, rows])


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _launches():
    return K.lstm_seq.launches, K.lstm_step.launches, K2.lstm_seq2.launches


def _wide_case(seed, layers=2, N=6, dtype=torch.float32):
    """Params at the routes' width (rnn_size 128) and a training batch."""
    sizes = [(In, 128)] + [(128, 128)] * (layers - 1)
    layers_ = lstm_params_from_numpy(_layers(seed, sizes), "cpu")
    rs = np.random.RandomState(seed)
    xs, mask = _t(rs.randn(T, N, In)), _t(_mask(rs, N, "ragged"))
    if dtype != torch.float32:
        layers_ = [{k: v.to(dtype) for k, v in la.items()} for la in layers_]
        xs = xs.to(dtype)
    return layers_, xs, mask


def test_seq_train_needs_cuda_and_counts_no_cpu_launch():
    """``NOVEL_VQA_SEQ_TRAIN=1`` takes only CUDA inputs (the JAX package's
    TPU test): on CPU tensors a training encode stays the default route's
    plain cell, bit for bit, and no wrapper counts a launch."""
    layers, xs, mask = _wide_case(10)
    before = _launches()
    with tlstm.training_route("seq_train"):
        got = tlstm.lstm_encode(layers, xs, mask, dropout_rate=0.5,
                                generator=torch.Generator().manual_seed(1), deterministic=False)
    ref = tlstm.lstm_encode(layers, xs, mask, dropout_rate=0.5,
                            generator=torch.Generator().manual_seed(1), deterministic=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert _launches() == before


@pytest.mark.parametrize("layers, fused2, seq", [(2, 1, 0), (3, 0, 1)])
def test_fused2_comes_before_seq_train(layers, fused2, seq, monkeypatch):
    """With both variables set, a two-layer encode takes FUSED2 and any
    other depth SEQ_TRAIN (the JAX package's order, ops/lstm.py:380-399)."""
    monkeypatch.setattr(tlstm, "_on_card", lambda t: True)
    calls2 = _spy(monkeypatch, tlstm, "fused2_encode_train")
    calls = _spy(monkeypatch, tlstm, "seq_encode_train")
    monkeypatch.setenv("NOVEL_VQA_FUSED2", "1")
    monkeypatch.setenv("NOVEL_VQA_SEQ_TRAIN", "1")
    layers_, xs, mask = _wide_case(11, layers)
    tlstm.lstm_encode(layers_, xs, mask, deterministic=False)
    assert (len(calls2), len(calls)) == (fused2, seq)


@pytest.mark.parametrize("case", ["remat", "bf16", "width", "eval", "return_sequence"])
def test_what_bypasses_seq_train(case, monkeypatch):
    """Under ``NOVEL_VQA_SEQ_TRAIN=1`` on the card, ``remat``, bf16 inputs,
    ``rnn_size % 128 != 0``, eval and ``return_sequence`` keep their
    routes."""
    monkeypatch.setattr(tlstm, "_on_card", lambda t: True)
    calls = _spy(monkeypatch, tlstm, "seq_encode_train")
    monkeypatch.setenv("NOVEL_VQA_SEQ_TRAIN", "1")
    if case == "width":
        layers = lstm_params_from_numpy(_layers(12), "cpu")
        rs = np.random.RandomState(12)
        xs, mask = _t(rs.randn(T, 6, In)), _t(_mask(rs, 6, "ragged"))
    else:
        layers, xs, mask = _wide_case(12, dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    tlstm.lstm_encode(layers, xs, mask, remat=case == "remat", deterministic=case == "eval",
                      return_sequence=case == "return_sequence")
    assert not calls
    # the same encode without the bypass takes the route
    if case in ("remat", "eval", "return_sequence"):
        tlstm.lstm_encode(layers, xs, mask, deterministic=False)
        assert len(calls) == 1


def test_training_route_sets_one_variable_and_restores(monkeypatch):
    """Inside the block only the route's own variable is set; afterwards
    the caller's settings are back."""
    names = [var for var, _ in tlstm.ROUTE_ENV.values()]
    monkeypatch.setenv("NOVEL_VQA_FUSED2", "1")
    monkeypatch.delenv("NOVEL_VQA_SEQ_TRAIN", raising=False)
    for route, (var, value) in tlstm.ROUTE_ENV.items():
        with tlstm.training_route(route):
            assert {n: os.environ.get(n) for n in names} == {n: value if n == var else None for n in names}
    with tlstm.training_route("default"):
        assert not any(n in os.environ for n in names)
    assert os.environ["NOVEL_VQA_FUSED2"] == "1" and "NOVEL_VQA_SEQ_TRAIN" not in os.environ
    with pytest.raises(ValueError, match="training route"):
        with tlstm.training_route("layerwise"):
            pass


# ---------------------------------------------------------------------------
# the slice: arch1's loss and gradients through FusedSeq
# ---------------------------------------------------------------------------

ARCH1 = dict(vocab_size=15, nhimage=8, input_encoding_size=8, rnn_size=128, rnn_layer=2,
             common_embedding_size=8, num_output=3, dropout=0.0)


def test_arch1_loss_and_grads_match_jax_through_seq_train(monkeypatch):
    """arch1's ``loss_fn`` at dropout 0 with ``NOVEL_VQA_SEQ_TRAIN=1``
    forced on CPU tensors (2 ``FusedSeq`` per loss), against the JAX
    package's arch1 loss and gradients."""
    monkeypatch.setattr(tlstm, "_on_card", lambda t: True)
    calls = _spy(monkeypatch, lstm_vjp, "FusedSeq")
    jcfg = jarch1.Arch1Config(**ARCH1)
    params = jax.device_get(jarch1.init_params(jax.random.PRNGKey(1), jcfg))
    rs = np.random.RandomState(1)
    n, D = 9, 4
    tokens = np.zeros((n, D), np.int32)
    for i in range(n):
        k = rs.randint(1, D + 1)
        tokens[i, D - k:] = rs.randint(1, 16, size=k)
    image = rs.randn(n, 8).astype(np.float32)
    image /= np.linalg.norm(image, axis=1, keepdims=True)
    labels = rs.randint(1, 4, size=n).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(jarch1.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(tokens), jnp.asarray(image),
        jnp.asarray(labels), jax.random.PRNGKey(0))
    with tlstm.training_route("seq_train"):
        t_loss, t_grads = value_and_grad(tarch1.loss_fn)(
            arch1_params_from_numpy(params, "cpu"), tarch1.Arch1Config(**ARCH1),
            *(torch.from_numpy(a) for a in (tokens, image, labels)), None)
    assert len(calls) == 2
    _close(t_loss, j_loss)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    t_leaves = tree_leaves(t_grads)
    assert len(t_leaves) == len(j_leaves)
    for got, ref in zip(t_leaves, j_leaves):
        _close(got, ref)
