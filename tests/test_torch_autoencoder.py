"""The port's sequence autoencoders against the JAX package's, all four
variants, at a tiny width: the same numpy params and tokens through both.

Tolerances: logprobs, NLL, losses and gradients 1e-5; greedy tokens exact.
Dropout masks cannot match bit for bit (``torch.Generator`` against JAX's
``rbg``), so training paths are compared with every dropout the identity
on both sides: the hard-coded 0.5s through the ``dropout`` name of each
autoencoder and fusion module, the rest through ``dropout=0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.models.seq import autoencoder as jae
from novel_vqa_tpu.ops import fusion as jfusion
from novel_vqa_tpu.ops import losses as jlosses

from novel_vqa_torch.core.checkpoint import _flatten_tree
from novel_vqa_torch.core.convert import ae_params_from_numpy
from novel_vqa_torch.core.tree import tree_leaves, value_and_grad
from novel_vqa_torch.models.seq import autoencoder as tae
from novel_vqa_torch.ops import fusion as tfusion
from novel_vqa_torch.ops import losses as tlosses

V, E, H, L, N, NHIMAGE = 15, 8, 10, 5, 7, 6
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(v, layers) for v in ("text_nostart", "arch2", "vqa_arch", "null") for layers in (1, 2)]


def _seq(rs, lengths):
    seq = np.zeros((L, len(lengths)), np.int32)
    for b, n in enumerate(lengths):
        seq[:n, b] = rs.randint(1, V + 1, size=n)
    return seq


def _setup(variant, layers, seed=0, dropout=0.5, lengths=(5, 1, 3, 2, 4, 3, 1)):
    """JAX params (numpy), the port's copy, and one batch of inputs: rows
    of different lengths; for vqa_arch image features and a mean sentence
    vector, for null a second token batch for the encoder."""
    rs = np.random.RandomState(seed)
    jcfg = jae.AEConfig(vocab_size=V, input_encoding_size=E, rnn_size=H, num_layers=layers,
                        seq_length=L, dropout=dropout, variant=variant, nhimage=NHIMAGE)
    tcfg = tae.AEConfig(**jcfg._asdict())
    params = jax.device_get(jae.init_params(jax.random.PRNGKey(seed), jcfg))
    seq = _seq(rs, lengths)
    inputs = {}
    if variant in ("arch2", "null"):
        inputs["imgs"] = rs.randn(N, E).astype(np.float32)
    if variant == "vqa_arch":
        inputs["imgs"] = rs.randn(N, NHIMAGE).astype(np.float32)
        inputs["sent_input"] = rs.randn(N, 2 * H).astype(np.float32)
    if variant == "null":
        seq_input = _seq(rs, (2, 4, 1, 5, 3, 1, 2))
        seq_input[:, 3] = 0  # a zeroed encoder row, as the weak-paired loader makes
        inputs["seq_input"] = seq_input
    return jcfg, tcfg, params, seq, inputs


def _j(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _t(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _tparams(params):
    return ae_params_from_numpy(params, "cpu")


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(ref), **TOL)


def _encode_args(variant, seq, inputs):
    """encode's (seq, imgs) for the variant."""
    if variant == "null":
        return inputs["seq_input"], inputs["imgs"]
    if variant == "arch2":
        return seq, inputs["imgs"]
    return seq, None


@pytest.mark.parametrize("variant,layers", CASES)
def test_encode_apply_and_fused_nll_match_jax(variant, layers):
    jcfg, tcfg, params, seq, inputs = _setup(variant, layers)
    tp = _tparams(params)
    es, ei = _encode_args(variant, seq, inputs)
    jc, jh = jae.encode(params, jcfg, jnp.asarray(es), None if ei is None else jnp.asarray(ei))
    tc, th = tae.encode(tp, tcfg, torch.from_numpy(es), None if ei is None else torch.from_numpy(ei))
    _close(tc, jc)
    _close(th, jh)
    for skip in ((False, True) if variant == "vqa_arch" else (False,)):
        j_lp = jae.apply(params, jcfg, jnp.asarray(seq), encoder_skip=skip, **_j(inputs))
        t_lp = tae.apply(tp, tcfg, torch.from_numpy(seq), encoder_skip=skip, **_t(inputs))
        assert t_lp.shape == (L + 1, N, V + 1)
        _close(t_lp, j_lp)
        j_nll, j_n = jae.apply_nll(params, jcfg, jnp.asarray(seq), encoder_skip=skip, **_j(inputs))
        t_nll, t_n = tae.apply_nll(tp, tcfg, torch.from_numpy(seq), encoder_skip=skip, **_t(inputs))
        _close(t_nll, j_nll)
        assert int(t_n) == int(j_n)


def test_sequence_nll_and_targets_match_jax():
    rs = np.random.RandomState(3)
    seq = _seq(rs, (5, 1, 3, 2, 4, 3, 1))
    lp = rs.randn(L + 1, N, V + 1).astype(np.float32)
    jt, js = jlosses.sequence_targets(jnp.asarray(seq), V + 1)
    tt, ts = tlosses.sequence_targets(torch.from_numpy(seq), V + 1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jl, jn = jlosses.sequence_nll(jnp.asarray(lp), jnp.asarray(seq))
    tl, tn = tlosses.sequence_nll(torch.from_numpy(lp), torch.from_numpy(seq))
    _close(tl, jl)
    assert int(tn) == int(jn)


@pytest.mark.parametrize("variant", ["text_nostart", "arch2", "vqa_arch", "null"])
def test_greedy_sample_matches_jax(variant):
    jcfg, tcfg, params, seq, inputs = _setup(variant, 1, seed=4)
    tp = _tparams(params)
    es, ei = _encode_args(variant, seq, inputs)
    state = jae.encode(params, jcfg, jnp.asarray(es), None if ei is None else jnp.asarray(ei))
    j_tok, j_lp = jae.sample(params, jcfg, state)
    t_tok, t_lp = tae.sample(tp, tcfg, tuple(torch.from_numpy(np.array(s)) for s in state))
    assert t_tok.shape == (L, N)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    _close(t_lp, j_lp)


@pytest.mark.parametrize("variant", ["text_nostart", "arch2"])
@pytest.mark.parametrize("lengths", [(3, 1, 2, 3, 2, 1, 3), (5, 1, 3, 2, 4, 3, 1)],
                         ids=["last_two_steps_all_null", "rows_end_apart"])
def test_batch_wide_skip_matches_jax(variant, lengths):
    """The encoder holds its state only on steps every row skips; rows that
    have ended run null tokens (read as token 1) like the reference."""
    jcfg, tcfg, params, seq, inputs = _setup(variant, 2, seed=5, lengths=lengths)
    tp = _tparams(params)
    ei = inputs.get("imgs")
    jc, jh = jae.encode(params, jcfg, jnp.asarray(seq), None if ei is None else jnp.asarray(ei))
    tc, th = tae.encode(tp, tcfg, torch.from_numpy(seq), None if ei is None else torch.from_numpy(ei))
    _close(tc, jc)
    _close(th, jh)
    # the skipped steps are no-ops: the same batch cut to its active steps
    active = int((seq != 0).any(axis=1).sum())
    tc2, th2 = tae.encode(tp, tcfg, torch.from_numpy(seq[:active]),
                          None if ei is None else torch.from_numpy(ei))
    assert torch.equal(tc2, tc) and torch.equal(th2, th)


def _identity_dropouts(monkeypatch):
    monkeypatch.setattr(jae, "dropout", lambda rng, x, rate, deterministic: x)
    monkeypatch.setattr(jfusion, "dropout", lambda rng, x, rate, deterministic: x)
    monkeypatch.setattr(tae, "dropout", lambda x, rate, generator, deterministic, **kw: x)
    monkeypatch.setattr(tfusion, "dropout", lambda x, rate, generator, deterministic, **kw: x)


@pytest.mark.parametrize("variant,layers", CASES)
def test_training_loss_and_gradients_match_jax(variant, layers, monkeypatch):
    _identity_dropouts(monkeypatch)
    jcfg, tcfg, params, seq, inputs = _setup(variant, layers, seed=6, dropout=0.0)
    tp = _tparams(params)
    for skip in ((False, True) if variant == "vqa_arch" else (False,)):
        j_loss, j_grads = jax.value_and_grad(jae.loss_fn)(
            params, jcfg, jnp.asarray(seq), jax.random.PRNGKey(0), encoder_skip=skip, **_j(inputs))
        t_loss, t_grads = value_and_grad(tae.loss_fn)(
            tp, tcfg, torch.from_numpy(seq), torch.Generator().manual_seed(0),
            encoder_skip=skip, **_t(inputs))
        _close(t_loss, j_loss)
        j_leaves = jax.tree_util.tree_leaves(j_grads)
        t_leaves = tree_leaves(t_grads)
        assert len(j_leaves) == len(t_leaves)
        for t_g, j_g in zip(t_leaves, j_leaves):
            _close(t_g, j_g)
        if tcfg.lookup_frozen:
            assert not t_grads["lookup"].any() and not np.asarray(j_grads["lookup"]).any()


@pytest.mark.parametrize("variant", ["text_nostart", "arch2", "vqa_arch", "null"])
def test_fused_nll_equals_sequence_nll_with_dropout_on(variant):
    """apply and apply_nll draw their masks in the same order, so from the
    same generator seed they agree in training mode too."""
    _, tcfg, params, seq, inputs = _setup(variant, 2, seed=7)
    tp = _tparams(params)
    s = torch.from_numpy(seq)
    lp = tae.apply(tp, tcfg, s, generator=torch.Generator().manual_seed(11),
                   deterministic=False, **_t(inputs))
    ref, n_ref = tlosses.sequence_nll(lp, s)
    got, n = tae.apply_nll(tp, tcfg, s, generator=torch.Generator().manual_seed(11),
                           deterministic=False, **_t(inputs))
    torch.testing.assert_close(got, ref, **TOL)
    assert int(n) == int(n_ref)
    det, _ = tae.apply_nll(tp, tcfg, s, **_t(inputs))
    assert abs(float(got) - float(det)) > 1e-4  # the masks were drawn


def test_compute_dtype_bfloat16_raises_and_unknown_is_refused():
    """bfloat16 is ported (``tests/test_torch_bf16.py`` holds it against the
    JAX package): an f32 NLL within 3e-2 of the f32 route's, as the JAX
    package's own bf16 test bounds it; an unknown dtype is refused."""
    _, tcfg, params, seq, _ = _setup("text_nostart", 1)
    tp = _tparams(params)
    f32, _ = tae.apply_nll(tp, tcfg, torch.from_numpy(seq))
    bf16, _ = tae.apply_nll(tp, tcfg._replace(compute_dtype="bfloat16"), torch.from_numpy(seq))
    assert bf16.dtype == torch.float32 and 0 < abs(float(bf16) - float(f32)) < 3e-2
    with pytest.raises(ValueError, match="compute_dtype"):
        tae.encode(tp, tcfg._replace(compute_dtype="float16"), torch.from_numpy(seq))


def test_init_params_layout_matches_jax():
    for variant in ("text_nostart", "vqa_arch"):
        jcfg, tcfg, params, _, _ = _setup(variant, 2)
        got = _flatten_tree(tae.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
        ref = _flatten_tree(params)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
