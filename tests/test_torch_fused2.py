"""The port's fused two-layer LSTM (``kernels/lstm2.py``, ``ops/lstm2.py``)
against the JAX package's ``ops/pallas_lstm2.py``, the Pallas kernel run in
interpret mode.  Inputs come from a numpy seed, with the same dropout
multiplier on both sides.

Tolerances.  Forward: 1e-5 on the f32 outputs and one bf16 ulp on the bf16
saved states.  That is far tighter than the JAX package's own 3e-2
(tests/test_pallas_lstm.py:262), which holds the bf16 kernel against an f32
reference: here both sides compute the identical bf16 math (bf16 operands,
exact products, f32 sums and carries), so they differ only in the order of
the f32 sums, and a bf16 rounding can at most land one ulp apart.
Gradients: within 1e-4 of the largest entry of each gradient (the
backward rounds the gate gradients to bf16 before its products, where an
f32 last-bit difference can move one entry by a bf16 ulp)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.ops import lstm as jlstm
from novel_vqa_tpu.ops import pallas_lstm2 as pl2

from novel_vqa_torch.core.convert import lstm_params_from_numpy
from novel_vqa_torch.kernels import build
from novel_vqa_torch.kernels import lstm as K
from novel_vqa_torch.kernels import lstm2 as K2
from novel_vqa_torch.ops import lstm as tlstm
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.lstm2 import Fused2, fused2_encode_train

T, In, H = 5, 24, 16
JBF, TBF = jnp.bfloat16, torch.bfloat16


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` at the repository root (torch and numpy only),
    loaded by the tests that use it alone."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(N, seed=0, T_=T, gaps_mask=None):
    """Ragged right-aligned mask (or ``gaps_mask``'s left-aligned one, with
    interior steps no row takes), inputs, a {0, 2} multiplier and six
    weights/biases (uniform +-0.08, biases as bx + bh), all numpy f32."""
    rs = np.random.RandomState(seed)
    xs = rs.randn(T_, N, In).astype(np.float32)
    lengths = rs.randint(1, T_ + 1, size=N)
    mask = (np.arange(T_)[:, None] >= (T_ - lengths[None, :])).astype(np.float32)
    if gaps_mask is not None:
        gen = torch.Generator().manual_seed(seed)
        mask = gaps_mask(T_, N, gen, torch.device("cpu")).numpy()
    drop = (rs.binomial(1, 0.5, size=(T_, N, H)) * 2.0).astype(np.float32)
    shapes = [(In, 4 * H), (H, 4 * H), (4 * H,), (H, 4 * H), (H, 4 * H), (4 * H,)]
    ws = [rs.uniform(-0.08, 0.08, s).astype(np.float32) for s in shapes]
    ws[2] += rs.uniform(-0.08, 0.08, 4 * H).astype(np.float32)
    ws[5] += rs.uniform(-0.08, 0.08, 4 * H).astype(np.float32)
    return xs, mask, drop, ws


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bf16_ulp(ref):
    """One bf16 ulp at each |ref| (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("N, T_, gaps", [
    pytest.param(12, T, False, id="12"),
    pytest.param(13, T, False, id="13"),
    pytest.param(13, 8, True, id="13-gaps"),
])
def test_seq2_plain_and_fused2_forward_match_pallas_interpret(N, T_, gaps, request):
    # N=13 is not a multiple of the Pallas tile (its padding path); the
    # gaps mask (chip_smoke.gaps_mask) has steps no row takes with computed
    # steps after them, and trailing ones, which the CUDA kernel skips
    gaps_mask = request.getfixturevalue("chip_smoke").gaps_mask if gaps else None
    xs, mask, drop, ws = _case(N, T_=T_, gaps_mask=gaps_mask)
    if gaps:
        idle = ~mask.any(axis=1)
        assert idle[2:4].all() and mask[4:].any() and not idle[:2].any()
    j_in = [jnp.asarray(xs, JBF), jnp.asarray(mask), jnp.asarray(drop, JBF)]
    j_in += [jnp.asarray(w, JBF) for w in ws]
    ref = [np.asarray(o, np.float32) for o in pl2._seq2_forward(*j_in, tile_n=8, interpret=True)]

    t_in = [_t(xs).to(TBF), _t(mask), _t(drop).to(TBF)] + [_t(w).to(TBF) for w in ws]
    plain = K2.lstm_seq2_plain(*t_in)
    fused = Fused2.apply(*t_in)
    assert [o.dtype for o in plain] == [torch.float32] * 4 + [TBF] * 2
    for got in (plain[:4], fused):
        for a, b in zip(got, ref[:4]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
    for a, b in zip(plain[4:], ref[4:]):
        assert a.shape == (T_, N, H)
        assert np.all(np.abs(a.float().numpy() - b) <= _bf16_ulp(b))


def _chunk16_sum(b, *products):
    """f32(b), then each (a, w) product's k-chunks of 16 in order, each
    chunk's partial sum taken in f32 first: the order in which the seq2
    kernel's m16n8k16 tensor-core products sum."""
    acc = b.expand(products[0][0].shape[0], -1)
    for a, w in products:
        for k0 in range(0, a.shape[1], 16):
            acc = acc + a[:, k0:k0 + 16] @ w[k0:k0 + 16]
    return acc


def _seq2_variant(xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2, omit=None, f64=False, chunk16=False):
    """The seq2 forward with its sums in another order (``f64``: float64
    products, rounded to f32 once per gate; ``chunk16``: the tensor cores'
    order, _chunk16_sum) or with one of its bf16 roundings left out
    (``omit``): 'h1' (bf16(h1) into Wh1), 'h2' (bf16(h2) into Wh2),
    'd_pre' (h1 rounded before the dropout multiply), 'd' (the layer-2
    input itself), 'all' (none of them)."""
    f32, acc = torch.float32, (torch.float64 if f64 else torch.float32)
    rnd = lambda a: a.to(TBF).to(f32)  # noqa: E731
    keep = {"h1", "h2", "d_pre", "d"} if omit == "all" else {omit}
    W = [w.to(acc) for w in (wx1, wh1, b1, wx2, wh2, b2)]
    N, H_ = xs.shape[1], wh1.shape[0]
    c1 = h1 = c2 = h2 = torch.zeros(N, H_)
    hs1, hs2 = [], []

    def gates_of(a, wa, h, wh, b):
        if chunk16:
            return _chunk16_sum(b, (a.to(acc), wa), (h.to(acc), wh))
        return (a.to(acc) @ wa + h.to(acc) @ wh + b).to(f32)

    for t in range(xs.shape[0]):
        m = mask[t][:, None] > 0
        o1 = h1 if "h1" in keep else rnd(h1)
        gates = gates_of(xs[t], W[0], o1, W[1], W[2])
        c_new, h_new = K.cell(gates, c1)
        c1, h1 = torch.where(m, c_new, c1), torch.where(m, h_new, h1)
        hs1.append(h1.to(TBF))
        d = (h1 if "d_pre" in keep else rnd(h1)) * drop[t].to(f32)
        d = d if "d" in keep else rnd(d)
        o2 = h2 if "h2" in keep else rnd(h2)
        gates = gates_of(d, W[3], o2, W[4], W[5])
        c_new, h_new = K.cell(gates, c2)
        c2, h2 = torch.where(m, c_new, c2), torch.where(m, h_new, h2)
        hs2.append(h2.to(TBF))
    return c1, h1, c2, h2, torch.stack(hs1), torch.stack(hs2)


def _replay_case(seed=6, N=16, H_=64, keep=0.7):
    """chip_smoke.py's seq2 inputs at a small size: uniform inputs, weights
    +-0.08, biases +-0.16, a {0, 1/keep} multiplier (keep 0.7, where the
    layer-2 input's own rounding is not exact), all bf16."""
    g = torch.Generator().manual_seed(seed)
    uni = lambda *s, scale=1.0: ((torch.rand(*s, generator=g) * 2 - 1) * scale).to(TBF)  # noqa: E731
    lengths = torch.randint(1, 9, (N,), generator=g)
    mask = (torch.arange(8)[:, None] >= (8 - lengths)[None, :]).float()
    drop = ((torch.rand(8, N, H_, generator=g) < keep).float() / keep).to(TBF)
    ws = [uni(*s, scale=sc) for s, sc in (((In, 4 * H_), 0.08), ((H_, 4 * H_), 0.08), ((4 * H_,), 0.16),
                                           ((H_, 4 * H_), 0.08), ((H_, 4 * H_), 0.08), ((4 * H_,), 0.16))]
    return (uni(8, N, In), mask, drop, *ws)


SEQ2_MUTANT_NAMES = ("d_from_f32_h1", "d_toward_zero", "h1_exchange_toward_zero", "h1_toward_zero",
                     "h2_exchange_toward_zero", "hs1_toward_zero", "hs2_toward_zero")


@pytest.mark.parametrize("name", SEQ2_MUTANT_NAMES)
def test_seq2_mutant_edits_one_line_of_the_kernel_source(name, chip_smoke):
    """``chip_smoke.py --seq2-mutants`` builds each variant by replacing one
    text of csrc/lstm2.cu: it must occur exactly once, or the variant is not
    the fault it names."""
    assert sorted(chip_smoke.SEQ2_MUTANTS) == list(SEQ2_MUTANT_NAMES)
    old, new = chip_smoke.SEQ2_MUTANTS[name]
    source = (build.CSRC / K2.SOURCE).read_text()
    assert source.count(old) == 1
    assert source.replace(old, new) != source


def test_seq2_replay_of_its_own_states_is_the_plain_run():
    args = _replay_case()
    run = K2.lstm_seq2_plain(*args)
    for a, b in zip(K2.lstm_seq2_plain(*args, saved=run[4:]), run):
        assert torch.equal(a, b)
    assert max(K2.replay_errors(args, run).values()) == 0.0


@pytest.mark.parametrize("variant, passes", [
    (dict(f64=True), True),
    (dict(omit="all"), False),
    (dict(omit="h1"), False),
    (dict(omit="h2"), False),
    (dict(omit="d_pre"), False),
    (dict(omit="d"), False),
    (dict(chunk16=True), True),
    (dict(chunk16=True, omit="h1"), False),
    (dict(chunk16=True, omit="h2"), False),
    (dict(chunk16=True, omit="d_pre"), False),
    (dict(chunk16=True, omit="d"), False),
])
def test_seq2_replay_check_passes_other_sum_orders_and_rejects_missing_roundings(variant, passes):
    """The check chip_smoke.py holds the CUDA kernel to (errors as multiples
    of their tolerance, at most 1 passes): a forward that sums in another
    order (float64, or the tensor cores' k-chunks of 16) passes with room
    to spare, and one that leaves out any of the kernel's bf16 roundings
    fails."""
    args = _replay_case()
    worst = max(K2.replay_errors(args, _seq2_variant(*args, **variant)).values())
    if passes:
        assert worst <= 0.1, worst
    else:
        assert worst > 2.0, worst


def test_fused2_grads_match_jax_grad():
    xs, mask, drop, ws = _case(12, seed=1)
    cot = [np.random.RandomState(2).randn(12, H).astype(np.float32) for _ in range(4)]

    def j_scalar(xs_, *w):
        out = pl2._fused2(
            xs_.astype(JBF), jnp.asarray(mask), jnp.asarray(drop, JBF),
            *(a.astype(JBF) for a in w), 8, True,
        )
        return sum(jnp.sum(o * c) for o, c in zip(out, cot))

    j_args = [jnp.asarray(xs)] + [jnp.asarray(w) for w in ws]
    j_grads = jax.grad(j_scalar, argnums=tuple(range(7)))(*j_args)

    leaves = [_t(a).requires_grad_() for a in [xs] + ws]
    out = Fused2.apply(
        leaves[0].to(TBF), _t(mask), _t(drop).to(TBF), *(a.to(TBF) for a in leaves[1:])
    )
    sum((o * _t(c)).sum() for o, c in zip(out, cot)).backward()
    for leaf, ref in zip(leaves, j_grads):
        ref = np.asarray(ref)
        assert leaf.grad.shape == ref.shape
        rel = np.abs(leaf.grad.numpy() - ref).max() / np.abs(ref).max()
        assert rel <= 1e-4, rel


def _layers(seed):
    k = jax.random.PRNGKey(seed)
    return [
        jax.device_get(jlstm.lstm_layer_init(jax.random.fold_in(k, 1), In, H)),
        jax.device_get(jlstm.lstm_layer_init(jax.random.fold_in(k, 2), H, H)),
    ]


def test_fused2_encode_train_rate0_matches_jax_encode():
    """At rate 0 the wrapper matches the JAX f32 encode within the JAX
    package's bf16 tolerance for this route (test_pallas_lstm.py:310-315)."""
    layers = _layers(3)
    xs, mask, _, _ = _case(8, seed=3)
    c_r, h_r = jlstm.lstm_encode(layers, jnp.asarray(xs), jnp.asarray(mask), deterministic=True)
    c_f, h_f = fused2_encode_train(lstm_params_from_numpy(layers, "cpu"), _t(xs), _t(mask), 0.0, None)
    assert c_f.shape == tuple(c_r.shape) == (2, 8, H)
    np.testing.assert_allclose(c_f.detach().numpy(), np.asarray(c_r), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(h_f.detach().numpy(), np.asarray(h_r), rtol=3e-2, atol=3e-2)


def test_fused2_encode_train_rate_half_is_the_function_fed_its_multiplier():
    """At rate 0.5 the wrapper draws one (T, N, H) multiplier in {0, 2} and
    equals the Function fed that multiplier with the per-layer bias sums
    (mirrors tests/test_pallas_lstm.py:317-337)."""
    layers = lstm_params_from_numpy(_layers(4), "cpu")
    xs, mask, _, _ = _case(8, seed=4)
    c_f, h_f = fused2_encode_train(layers, _t(xs), _t(mask), 0.5, torch.Generator().manual_seed(7))

    drop = dropout(torch.ones(T, 8, H), 0.5, torch.Generator().manual_seed(7), False)
    assert set(torch.unique(drop).tolist()) == {0.0, 2.0}
    l1, l2 = layers
    c1, h1, c2, h2 = Fused2.apply(
        _t(xs).to(TBF), _t(mask), drop.to(TBF),
        l1["wx"].to(TBF), l1["wh"].to(TBF), (l1["bx"] + l1["bh"]).to(TBF),
        l2["wx"].to(TBF), l2["wh"].to(TBF), (l2["bx"] + l2["bh"]).to(TBF),
    )
    assert torch.equal(c_f, torch.stack([c1, c2]))
    assert torch.equal(h_f, torch.stack([h1, h2]))


def test_fused2_route_needs_cuda_and_counts_no_cpu_launch(monkeypatch):
    """``NOVEL_VQA_FUSED2=1`` routes only CUDA inputs to the seq2 kernel
    (ops/lstm.py:367-391 with CUDA for TPU): on CPU tensors the training
    encode stays on the per-step route, and no wrapper counts a launch."""
    monkeypatch.setenv("NOVEL_VQA_FUSED2", "1")
    layers = lstm_params_from_numpy(_layers(5), "cpu")
    xs, mask, _, _ = _case(6, seed=5)
    before = (K.lstm_seq.launches, K.lstm_step.launches, K2.lstm_seq2.launches)
    got = tlstm.lstm_encode(layers, _t(xs), _t(mask), deterministic=False)
    monkeypatch.delenv("NOVEL_VQA_FUSED2")
    ref = tlstm.lstm_encode(layers, _t(xs), _t(mask), deterministic=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    K2.lstm_seq2(*(t.contiguous() for t in [_t(xs).to(TBF), _t(mask), torch.ones(T, 6, H, dtype=TBF)]),
                 *(torch.zeros(s, dtype=TBF) for s in [(In, 4 * H), (H, 4 * H), (4 * H,),
                                                       (H, 4 * H), (H, 4 * H), (4 * H,)]))
    assert (K.lstm_seq.launches, K.lstm_step.launches, K2.lstm_seq2.launches) == before


def test_refuse_grad_guards_forward_only_kernels():
    """The guard each CUDA wrapper runs before its launch: an input that
    requires grad under grad mode raises; under no_grad it passes."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.refuse_grad("lstm_seq2", torch.zeros(2), x)
    with torch.no_grad():
        K.refuse_grad("lstm_seq2", x)
    K.refuse_grad("lstm_seq2", x.detach())
