"""The port's rematerialization (``remat``): ``lstm_encode(remat=True)``
and ``Arch1Config.remat`` (each training step recomputed in the backward,
``jax.checkpoint(body)`` in the JAX package) and ``train_weakpaired_ae
--remat 1`` (the trunk recomputed in the finetune backward,
``jax.checkpoint(cnn_apply)``).

Remat changes no result.  Its dropout masks come from an explicit
generator that a recompute would draw from again, so the masks are drawn
before each recomputed step; at dropout 0.5 from one generator seed, remat
and no remat give the same forward and the same generator state (exactly:
the recompute runs the same operations on the same values) and the same
gradients (within GRAD_TOL of each leaf's max |g|: a weight's gradient
sums its steps' terms, which the two backwards may add in other orders).
Against the JAX package's ``remat=True`` at dropout 0, loss and gradients
within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from novel_vqa_tpu.models.vqa import arch1 as jarch1

from novel_vqa_torch.core.convert import arch1_params_from_numpy
from novel_vqa_torch.core.tree import tree_leaves, value_and_grad
from novel_vqa_torch.kernels import lstm as tkernels
from novel_vqa_torch.models.seq import autoencoder as tae
from novel_vqa_torch.models.vqa import arch1 as tarch1
from novel_vqa_torch.ops import lstm as tlstm
from novel_vqa_torch.ops.precision import cast_compute
from novel_vqa_torch.train import train_weakpaired_ae as twp_train

from test_torch_bf16 import D1 as D
from test_torch_bf16 import L1 as LAYERS
from test_torch_bf16 import _arch1_batch
from test_torch_bf16 import _arch1 as _arch1_cfgs
from test_torch_weakpaired import TRUNKS as WP_TRUNKS
from test_torch_weakpaired import E as WP_E
from test_torch_weakpaired import L as WP_L
from test_torch_weakpaired import N as WP_N
from test_torch_weakpaired import V as WP_V
from test_torch_weakpaired import _batch as wp_batch

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-6
H = 16


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arch1(remat, dropout_rate, dtype="float32"):
    return _arch1_cfgs(dropout_rate=dropout_rate, dtype=dtype, remat=remat)


def _close_grads(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype
        err = float((x.float() - y.float()).abs().max())
        assert err <= GRAD_TOL * float(y.float().abs().max()), err


def _encode_case(layers, dtype, seed=0):
    rs = np.random.RandomState(seed)
    T, N, In = 6, 9, 7
    params = [{k: torch.from_numpy(rs.uniform(-0.3, 0.3, s).astype(np.float32))
               for k, s in (("wx", (In if i == 0 else H, 4 * H)), ("bx", (4 * H,)),
                            ("wh", (H, 4 * H)), ("bh", (4 * H,)))} for i in range(layers)]
    xs = torch.from_numpy(rs.randn(T, N, In).astype(np.float32))
    lengths = rs.randint(1, T + 1, size=N)
    mask = torch.from_numpy((np.arange(T)[:, None] >= T - lengths[None, :]).astype(np.float32))
    w = torch.from_numpy(rs.randn(layers, N, H).astype(np.float32))
    return params, xs.to(dtype), mask.to(dtype), w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layers", [1, 3])
def test_lstm_encode_remat_equals_no_remat_at_dropout_half(layers, dtype):
    params, xs, mask, w = _encode_case(layers, dtype)
    out = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)

        def loss(both):
            c, h = tlstm.lstm_encode(cast_compute(both["p"], dtype), both["xs"], mask,
                                     dropout_rate=0.5, generator=gen, deterministic=False,
                                     remat=remat)
            return ((c.float() + h.float()) * w).sum()

        value, grads = value_and_grad(loss)({"p": params, "xs": xs})
        out[remat] = (value, grads, gen.get_state())
    assert torch.equal(out[True][0], out[False][0])
    _close_grads(out[True][1], out[False][1])
    assert torch.equal(out[True][2], out[False][2])  # the same draws, no more
    assert out[True][1]["xs"].dtype == dtype


def test_lstm_encode_remat_with_a_given_state_and_the_sequence():
    params, xs, mask, w = _encode_case(2, torch.float32, seed=1)
    init = (torch.randn(2, 9, H, generator=torch.Generator().manual_seed(2)),) * 2
    seqs = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(3)
        fn = lambda p: tlstm.lstm_encode(p, xs, mask, init_state=init, dropout_rate=0.5,
                                         generator=gen, deterministic=False, return_sequence=True,
                                         remat=remat)[1][1].sum()
        seqs[remat] = value_and_grad(fn)(params)
    assert torch.equal(seqs[True][0], seqs[False][0])
    _close_grads(seqs[True][1], seqs[False][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arch1_remat_matches_jax_remat_at_dropout_zero(dtype):
    """Loss and f32 master gradients against JAX's ``remat=True`` (bf16:
    the gradients within 2e-2 of max |g|, as ``test_torch_bf16.py``)."""
    jcfg, tcfg, params = _arch1(True, 0.0, dtype)
    tokens, image, labels = _arch1_batch(11, 1)
    jl, jg = jax.jit(jax.value_and_grad(jarch1.loss_fn), static_argnums=1)(
        params, jcfg, tokens, image, labels, jax.random.PRNGKey(0))
    tl, tg = value_and_grad(tarch1.loss_fn)(arch1_params_from_numpy(params, "cpu"), tcfg,
                                            torch.from_numpy(tokens), torch.from_numpy(image),
                                            torch.from_numpy(labels), torch.Generator())
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for g, r in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        r = np.asarray(r)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), r, **TOL)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-2 * np.abs(r).max() + 1e-12)


def test_arch1_train_step_remat_equals_no_remat_at_dropout_half():
    out = {}
    tokens, image, labels = _arch1_batch(12, 2)
    for remat in (False, True):
        _, tcfg, params = _arch1(remat, 0.5)
        tp = arch1_params_from_numpy(params, "cpu")
        tx = tarch1.make_optimizer(learning_rate=1e-2)
        gen = torch.Generator().manual_seed(5)
        out[remat] = tarch1.train_step(tcfg, tx, tp, tx.init(tp), torch.from_numpy(tokens),
                                       torch.from_numpy(image), torch.from_numpy(labels), gen)
    assert torch.equal(out[True][2], out[False][2])
    # the params after one rmsprop step from those gradients
    _close_grads(out[True][:2], out[False][:2])


def test_remat_eval_steps_through_the_step_kernel(monkeypatch):
    """A deterministic encode under remat steps cell by cell (the step
    kernel's wrapper, ``rnn_layer`` x T calls per batch), never the seq
    kernel's, and gives the scores of the default route and of JAX's."""
    calls = []
    step = tkernels.lstm_step
    monkeypatch.setattr(tkernels, "lstm_step", lambda *a: calls.append(1) or step(*a))
    jcfg, tcfg, params = _arch1(True, 0.5)
    tokens, image, labels = _arch1_batch(10, 3)
    tp = arch1_params_from_numpy(params, "cpu")
    default = tarch1.eval_step(tcfg._replace(remat=False), tp, torch.from_numpy(tokens),
                               torch.from_numpy(image), torch.from_numpy(labels))[1]
    assert not calls
    monkeypatch.setattr(tkernels, "lstm_seq", lambda *a: pytest.fail("remat took the seq route"))
    loss, scores = tarch1.eval_step(tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(image),
                                    torch.from_numpy(labels))
    assert len(calls) == LAYERS * D
    np.testing.assert_allclose(scores.numpy(), default.numpy(), **TOL)
    ref = jax.jit(lambda p, t, i: jarch1.apply(p, jcfg, t, i))(params, tokens, image)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref), **TOL)


def _wp_port_setup(variant):
    """The port's half of ``test_torch_weakpaired._setup`` (VGG-16 at crop
    32): the AE config and params, the trunk, its apply and the options."""
    spec = WP_TRUNKS["vgg16"]
    topt = twp_train.WPTrainConfig(
        device="cpu", cnn_arch="vgg16", variant=variant, rnn_size=WP_E, input_encoding_size=WP_E,
        batch_size=WP_N, image_size=spec["side"], crop_size=spec["crop"], nhimage=spec["nhimage"],
        drop_prob_ae=0.0, optim="sgd", cnn_optim="sgd", learning_rate=0.5, cnn_learning_rate=0.5)
    tcfg = tae.AEConfig(vocab_size=WP_V, input_encoding_size=WP_E, rnn_size=WP_E, seq_length=WP_L,
                        dropout=0.0, variant=variant,
                        nhimage=spec["nhimage"] if variant == "vqa_arch" else 0)
    t_ae = tae.init_params(tcfg, torch.Generator().manual_seed(2), "cpu")
    t_cnn, tapply, _ = twp_train.build_cnn(topt, variant == "null", torch.Generator().manual_seed(3), "cpu")
    return tcfg, t_ae, t_cnn, tapply, topt


@pytest.mark.parametrize("variant", ["vqa_arch", "null"])
def test_weakpaired_finetune_step_remat_equals_no_remat(variant):
    """``make_train_step(remat=True)``'s finetune step (VGG-16 at crop 32)
    against ``remat=False`` from one generator seed, the AE's 0.5 dropouts
    drawn: the same loss and both nets' updated params."""
    tcfg, t_ae, t_cnn, tapply, topt = _wp_port_setup(variant)
    skip, images, offsets, seq, sent_input, seq_input = wp_batch("vgg16", variant, False,
                                                                 np.random.RandomState(4))
    out = {}
    for remat in (False, True):
        ae_tx, cnn_tx = twp_train.make_ae_tx(topt), twp_train.make_cnn_tx(topt)
        step = twp_train.make_train_step(tcfg, variant, 32, tapply, ae_tx, cnn_tx, remat=remat)
        out[remat] = step(skip, True, t_ae, ae_tx.init(t_ae), t_cnn, cnn_tx.init(t_cnn),
                          *(torch.from_numpy(a) for a in (images, offsets, seq, sent_input, seq_input)),
                          torch.Generator().manual_seed(0))
    assert torch.equal(out[True][4], out[False][4]) and torch.isfinite(out[True][4])
    _close_grads((out[True][0], out[True][2]), (out[False][0], out[False][2]))
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(out[True][2]), tree_leaves(t_cnn))]
    assert any(moved)  # the trunk was finetuned
