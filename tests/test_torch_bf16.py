"""The port's bf16 mixed precision (``compute_dtype="bfloat16"``) against
the JAX package's, module by module and for arch1 and the four
autoencoders, on the same numpy inputs.

Tolerances, with bf16 values compared as f32:
  * products with an f32 result (``dot_f32``): 2e-6 relative to max |ref|
    (exact products, f32 sums in another order);
  * bf16 outputs (the cell's c', h', the embedding): one bf16 ulp,
    rtol 2**-7 (bf16 keeps 8 significant bits);
  * f32 outputs behind bf16 operands (fusion, scores, logprobs, losses):
    1e-5;
  * gradients: JAX rounds each cotangent of a bf16 value to bf16 where
    autograd rounds at other points, so 2e-2 of the leaf's max |g|;
  * the discrimination check: the port's distance from JAX's bf16 is at
    most a tenth of JAX's bf16's distance from JAX's f32, so a port that
    quietly computes in f32 fails.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.core import checkpoint as jckpt
from novel_vqa_tpu.models.seq import autoencoder as jae
from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.ops import embedding_lookup as j_embedding_lookup
from novel_vqa_tpu.ops import fusion as jfusion
from novel_vqa_tpu.ops import lstm as jlstm
from novel_vqa_tpu.train import convert_ae as jconvert
from novel_vqa_tpu.train import eval_vqa_arch1 as jeval

from novel_vqa_torch.core import checkpoint as tckpt
from novel_vqa_torch.core.convert import ae_params_from_numpy, arch1_params_from_numpy, params_to_numpy
from novel_vqa_torch.core.tree import tree_leaves, value_and_grad
from novel_vqa_torch.kernels import lstm as tkernels
from novel_vqa_torch.models.seq import autoencoder as tae
from novel_vqa_torch.models.vqa import arch1 as tarch1
from novel_vqa_torch.ops import fusion as tfusion
from novel_vqa_torch.ops import lstm as tlstm
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.embedding import embedding_lookup
from novel_vqa_torch.ops.precision import cast_compute, dot_f32
from novel_vqa_torch.train import eval_vqa_arch1 as teval
from novel_vqa_torch.train import train_text_ae as ttext
from novel_vqa_torch.train import train_vqa_arch1 as ttrain

from test_torch_text_ae import AE_ARGS, corpus  # noqa: F401 (fixture)
from test_torch_train import WIDTHS, dataset  # noqa: F401 (fixture)

BF16_ULP = dict(rtol=2.0**-7, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 2e-2
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_pair(a):
    """An f32 numpy array rounded to bf16, as a JAX and a torch array."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF)


def _jax_tree(params):
    """The port's seeded params as numpy, in JAX's (sorted) key order, for
    both packages: JAX's eager init compiles an op per leaf."""
    return jax.tree_util.tree_map(np.asarray, params_to_numpy(params))


def _dist(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _grads_close(tg, jg):
    for g, r in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=GRAD_REL * np.abs(r).max() + 1e-12)


# -- modules -------------------------------------------------------------------


def test_dot_f32_matches_preferred_element_type_and_its_transpose():
    rs = np.random.RandomState(0)
    ja, ta = _bf16_pair(rs.randn(24, 40))
    jb, tb = _bf16_pair(rs.randn(40, 56))
    w = rs.randn(24, 56).astype(np.float32)
    jf = lambda a, b: jnp.sum(jnp.tanh(jnp.dot(a, b, preferred_element_type=jnp.float32)) * w)
    ref = jnp.dot(ja, jb, preferred_element_type=jnp.float32)
    ta.requires_grad_()
    tb.requires_grad_()
    got = dot_f32(ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=2e-6 * np.abs(ref).max())
    # torch's own bf16 product rounds its result to bf16: not JAX's route
    assert _dist(ta.detach() @ tb.detach(), ref) > 1e3 * _dist(got, ref)
    (torch.tanh(got) * torch.from_numpy(w)).sum().backward()
    jga, jgb = jax.grad(jf, (0, 1))(ja, jb)
    assert ta.grad.dtype == BF and jga.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(ta.grad), _np(jga), **BF16_ULP)
    np.testing.assert_allclose(_np(tb.grad), _np(jgb), **BF16_ULP)
    # bf16 with f32 promotes to an f32 product; f32 with f32 is torch.matmul
    mixed = rs.randn(40, 56).astype(np.float32)
    ref_m = jnp.dot(ja, jnp.asarray(mixed), preferred_element_type=jnp.float32)
    np.testing.assert_allclose(_np(dot_f32(ta.detach(), torch.from_numpy(mixed))), np.asarray(ref_m),
                               rtol=0, atol=2e-6 * np.abs(ref_m).max())
    x32 = torch.from_numpy(rs.randn(5, 40).astype(np.float32))
    assert torch.equal(dot_f32(x32, torch.from_numpy(mixed)), x32 @ torch.from_numpy(mixed))


@pytest.mark.parametrize("carry", ["bfloat16", "float32"], ids=["bf16_carry", "f32_carry"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bf16_cell_step_matches_jax(monkeypatch, carry, training):
    """The bf16 cell (gates f32, c' f32, c' and h' in the carry's dtype):
    a bf16 carry as arch1's, an f32 one as the vqa_arch decoder's seed
    gives.  In eval too it is the plain cell: the step kernel refuses bf16."""
    monkeypatch.setattr(tkernels, "lstm_step", lambda *a: pytest.fail("the kernel got bf16"))
    rs = np.random.RandomState(1)
    In, Hh, N = 12, 16, 9
    p = {k: rs.uniform(-0.3, 0.3, s).astype(np.float32)
         for k, s in (("wx", (In, 4 * Hh)), ("bx", (4 * Hh,)), ("wh", (Hh, 4 * Hh)), ("bh", (4 * Hh,)))}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = cast_compute({k: torch.from_numpy(v) for k, v in p.items()}, BF)
    jx, tx = _bf16_pair(rs.randn(N, In))
    c0, h0 = rs.randn(N, Hh), np.tanh(rs.randn(N, Hh))
    if carry == "bfloat16":
        (jc, tc), (jh, th) = _bf16_pair(c0), _bf16_pair(h0)
    else:
        jc, tc = jnp.asarray(c0, jnp.float32), torch.tensor(c0, dtype=torch.float32)
        jh, th = jnp.asarray(h0, jnp.float32), torch.tensor(h0, dtype=torch.float32)
    jc2, jh2 = jlstm.lstm_step(jp, jx, jc, jh, training=training)
    tc2, th2 = tlstm.lstm_step(tp, tx, tc, th, training=training)
    assert tc2.dtype == th2.dtype == tc.dtype and str(jc2.dtype) == carry
    tol = BF16_ULP if carry == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(tc2), _np(jc2), **tol)
    np.testing.assert_allclose(_np(th2), _np(jh2), **tol)


@pytest.mark.parametrize("block", ["axb_apply", "askipb_apply", "a_b_apply"])
def test_fusion_bf16_gives_f32(block):
    rs = np.random.RandomState(2)
    shapes = jax.eval_shape(lambda: jfusion.axb_init(jax.random.PRNGKey(3), 14, 10, 6))
    jparams = {k: rs.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in jparams.items()}
    tp = cast_compute({k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}, BF)
    jq, tq = _bf16_pair(rs.randn(5, 14))
    ji, ti = _bf16_pair(rs.randn(5, 10))
    ref = getattr(jfusion, block)(jp, jq, ji)
    got = getattr(tfusion, block)(tp, tq, ti)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32_TOL)


def test_embedding_tanh_dropout_and_classifier_bf16():
    rs = np.random.RandomState(4)
    (jt, tt), (jb, tb) = _bf16_pair(rs.randn(9, 6)), _bf16_pair(rs.randn(6))
    tokens = rs.randint(0, 10, size=(4, 5)).astype(np.int32)
    ref = jnp.tanh(j_embedding_lookup(jt, jnp.asarray(tokens), jb))
    got = torch.tanh(embedding_lookup(tt, torch.from_numpy(tokens), tb))
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), **BF16_ULP)
    # x / keep with a Python float stays bf16 in both frameworks
    kept = dropout(got, 0.5, torch.Generator().manual_seed(0), deterministic=False)
    assert kept.dtype == BF
    survivors = kept != 0
    np.testing.assert_array_equal(_np(kept)[survivors.numpy()], _np(got * 2)[survivors.numpy()])
    # the classifier: f32 fused against bf16 w is an f32 product
    fused = rs.randn(4, 6).astype(np.float32)
    (jw, tw), (jcb, tcb) = _bf16_pair(rs.randn(6, 3)), _bf16_pair(rs.randn(3))
    ref = jnp.dot(jnp.asarray(fused), jw, preferred_element_type=jnp.float32) + jcb
    got = dot_f32(torch.from_numpy(fused), tw) + tcb
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32_TOL)


# -- arch1 ---------------------------------------------------------------------

V1, E1, H1, L1, F1, C1, O1, D1 = 30, 12, 16, 2, 20, 10, 7, 5


def _arch1(fusion="axb", dropout_rate=0.5, dtype="bfloat16", remat=False):
    kw = dict(vocab_size=V1, input_encoding_size=E1, rnn_size=H1, rnn_layer=L1, nhimage=F1,
              common_embedding_size=C1, num_output=O1, fusion=fusion, dropout=dropout_rate,
              compute_dtype=dtype, remat=remat)
    jcfg = jarch1.Arch1Config(**kw)
    tcfg = tarch1.Arch1Config(**kw)
    return jcfg, tcfg, _jax_tree(tarch1.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))


def _arch1_batch(n, seed):
    rs = np.random.RandomState(seed)
    tokens = np.zeros((n, D1), np.int32)
    for i in range(n):
        length = rs.randint(1, D1 + 1)
        tokens[i, D1 - length:] = rs.randint(1, V1 + 1, size=length)
    image = rs.randn(n, F1).astype(np.float32)
    image /= np.linalg.norm(image, axis=1, keepdims=True)
    return tokens, image, rs.randint(1, O1 + 1, size=n).astype(np.int32)


@pytest.mark.parametrize("fusion", ["axb", "askipb"])
def test_arch1_bf16_forward_matches_jax_and_discriminates(fusion):
    jcfg, tcfg, params = _arch1(fusion)
    tokens, image, _ = _arch1_batch(13, 1)
    j16, j32 = (jax.jit(lambda p, t, i, c=c: jarch1.apply(p, c, t, i))(params, tokens, image)
                for c in (jcfg, jcfg._replace(compute_dtype="float32")))
    tp = arch1_params_from_numpy(params, "cpu")
    got = tarch1.apply(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(image))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in tree_leaves(tp))
    np.testing.assert_allclose(_np(got), np.asarray(j16), **F32_TOL)
    assert _dist(got, j16) <= 0.1 * _dist(j16, j32)
    # the route is bf16: the port's f32 route sits at JAX's f32, not bf16
    f32 = tarch1.apply(tp, tcfg._replace(compute_dtype="float32"), torch.from_numpy(tokens),
                       torch.from_numpy(image))
    assert _dist(f32, j16) > 10 * _dist(got, j16)


def test_arch1_bf16_loss_and_master_gradients_match_jax():
    jcfg, tcfg, params = _arch1(dropout_rate=0.0)
    tokens, image, labels = _arch1_batch(11, 2)
    jl, jg = jax.jit(jax.value_and_grad(jarch1.loss_fn), static_argnums=1)(
        params, jcfg, tokens, image, labels, jax.random.PRNGKey(0))
    tl, tg = value_and_grad(tarch1.loss_fn)(
        arch1_params_from_numpy(params, "cpu"), tcfg, torch.from_numpy(tokens),
        torch.from_numpy(image), torch.from_numpy(labels), torch.Generator())
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    _grads_close(tg, jg)


def test_arch1_bf16_train_step_matches_jax():
    jcfg, tcfg, params = _arch1(dropout_rate=0.0)
    tokens, image, labels = _arch1_batch(10, 3)
    jtx, ttx = jarch1.make_optimizer(learning_rate=1e-3), tarch1.make_optimizer(learning_rate=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp, _, jloss = jax.jit(lambda *a: jarch1.train_step(jcfg, jtx, *a))(
        jp, jtx.init(jp), tokens, image, labels, jax.random.PRNGKey(0))
    tp = arch1_params_from_numpy(params, "cpu")
    tp, _, tloss = tarch1.train_step(tcfg, ttx, tp, ttx.init(tp), torch.from_numpy(tokens),
                                     torch.from_numpy(image), torch.from_numpy(labels), None)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)
    # rmsprop's first step divides each gradient by its own size (at most
    # 10 x lr), so a weight whose gradient is near zero moves by an amount
    # that the gradients' bf16 rounding shifts: the f32 masters within a
    # tenth of the largest step of JAX's
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=0.1 * 10 * 1e-3)


# -- autoencoders --------------------------------------------------------------

VA, EA, HA, LA, NA, NHA = 15, 8, 10, 5, 7, 6
AE_VARIANTS = ["text_nostart", "arch2", "vqa_arch", "null"]


def _ae(variant, layers=2, dropout_rate=0.5):
    rs = np.random.RandomState(5)
    kw = dict(vocab_size=VA, input_encoding_size=EA, rnn_size=HA, num_layers=layers, seq_length=LA,
              dropout=dropout_rate, variant=variant, nhimage=NHA, compute_dtype="bfloat16")
    jcfg, tcfg = jae.AEConfig(**kw), tae.AEConfig(**kw)
    params = _jax_tree(tae.init_params(tcfg, torch.Generator().manual_seed(1), "cpu"))

    def seq(lengths):
        s = np.zeros((LA, len(lengths)), np.int32)
        for b, n in enumerate(lengths):
            s[:n, b] = rs.randint(1, VA + 1, size=n)
        return s

    tokens = seq((5, 1, 3, 2, 4, 3, 1))
    inputs = {}
    if variant in ("arch2", "null"):
        inputs["imgs"] = rs.randn(NA, EA).astype(np.float32)
    if variant == "vqa_arch":
        inputs["imgs"] = rs.randn(NA, NHA).astype(np.float32)
        inputs["sent_input"] = rs.randn(NA, 2 * HA).astype(np.float32)
    if variant == "null":
        inputs["seq_input"] = seq((2, 4, 1, 5, 3, 1, 2))
    return jcfg, tcfg, params, tokens, inputs


@pytest.mark.parametrize("variant", AE_VARIANTS)
def test_ae_bf16_encode_and_nll_match_jax(variant):
    jcfg, tcfg, params, seq, inputs = _ae(variant)
    tp = ae_params_from_numpy(params, "cpu")
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    es = inputs.get("seq_input", seq)
    ei = inputs.get("imgs") if variant in ("arch2", "null") else None
    jc, jh = jax.jit(lambda p, s, i: jae.encode(p, jcfg, s, i))(params, es, ei)
    tc, th = tae.encode(tp, tcfg, torch.from_numpy(es), None if ei is None else torch.from_numpy(ei))
    assert tc.dtype == th.dtype == BF and jc.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(tc), _np(jc), **BF16_ULP)
    np.testing.assert_allclose(_np(th), _np(jh), **BF16_ULP)
    for skip in ((False, True) if variant == "vqa_arch" else (False,)):
        (j16, jn), (j32, _) = (
            jax.jit(lambda p, s, kw, c=c: jae.apply_nll(p, c, s, encoder_skip=skip, **kw))(params, seq, jin)
            for c in (jcfg, jcfg._replace(compute_dtype="float32")))
        got, n = tae.apply_nll(tp, tcfg, torch.from_numpy(seq), encoder_skip=skip, **tin)
        assert got.dtype == torch.float32 and int(n) == int(jn)
        np.testing.assert_allclose(float(got), float(j16), **F32_TOL)
        assert _dist(got, j16) <= 0.1 * _dist(j16, j32)


@pytest.mark.parametrize("variant", ["text_nostart", "vqa_arch"])
def test_ae_bf16_loss_gradients_match_jax(variant, monkeypatch):
    """At every dropout the identity on both sides (the AE's fixed 0.5s
    too), the loss and the f32 masters' gradients: the text AE, and
    vqa_arch, whose f32 multimodal seed gives the decoder an f32 carry."""
    import novel_vqa_torch.models.seq.autoencoder as tae_mod

    monkeypatch.setattr(jae, "dropout", lambda rng, x, rate, deterministic: x)
    monkeypatch.setattr(jfusion, "dropout", lambda rng, x, rate, deterministic: x)
    monkeypatch.setattr(tae_mod, "dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(tfusion, "dropout", lambda x, *a, **k: x)
    jcfg, tcfg, params, seq, inputs = _ae(variant, dropout_rate=0.0)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, s, kw: jae.loss_fn(p, jcfg, s, jax.random.PRNGKey(0), **kw)))(
        params, seq, jin)
    tl, tg = value_and_grad(tae.loss_fn)(ae_params_from_numpy(params, "cpu"), tcfg,
                                         torch.from_numpy(seq), torch.Generator(), **tin)
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    _grads_close(tg, jg)


MARGIN_TOL = 2e-2  # greedy tokens must agree where JAX's top-2 margin exceeds this


def test_ae_bf16_greedy_replay():
    """Greedy decoding in bf16: JAX's tokens fed back through both packages'
    decoders; the chosen tokens' log-probs agree, and the port's arg max is
    JAX's token wherever JAX's top-2 margin exceeds MARGIN_TOL."""
    jcfg, tcfg, params, seq, _ = _ae("text_nostart", layers=1)
    jcfg, tcfg = jcfg._replace(vocab_size=VA), tcfg._replace(vocab_size=VA)
    tp = ae_params_from_numpy(params, "cpu")
    seq = np.concatenate([seq] * 4, axis=1)
    state = jax.jit(lambda p, s: jae.encode(p, jcfg, s))(params, seq)
    j_tokens, j_lps = jax.jit(lambda p, st: jae.sample(p, jcfg, st))(params, state)
    t_state = tuple(torch.from_numpy(_np(s)).to(BF) for s in state)
    t_tokens, t_lps = tae.sample(tp, tcfg, t_state)
    assert t_tokens.shape == j_tokens.shape and t_lps.dtype == torch.float32
    # replay: both decoders teacher-forced on JAX's tokens from the same
    # bf16 state, as sample feeds them
    jp16, jc16, jh16 = jae._cast_compute(jcfg, params, *state)
    j_lp = np.asarray(jax.jit(lambda p, st, s: jae.decode_teacher_forced(p, jcfg, st, s))(
        jp16, (jc16, jh16), j_tokens))[:LA]
    tp16, tc16, th16 = tae._cast_compute(tcfg, tp, *t_state)
    t_lp = _np(tae.decode_teacher_forced(tp16, tcfg, (tc16, th16),
                                         torch.from_numpy(np.asarray(j_tokens))))[:LA]
    np.testing.assert_allclose(t_lp, j_lp, **F32_TOL)
    chosen = np.take_along_axis(t_lp, (np.asarray(j_tokens) - 1)[..., None], -1)[..., 0]
    np.testing.assert_allclose(chosen, np.asarray(j_lps), **F32_TOL)
    top2 = np.sort(j_lp, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN_TOL
    np.testing.assert_array_equal((t_lp.argmax(-1) + 1)[clear], np.asarray(j_tokens)[clear])
    # rows whose every step is clear never diverge: the port's own greedy
    # decode gives JAX's tokens there
    rows = clear.all(axis=0)
    assert rows.any()
    np.testing.assert_array_equal(t_tokens.numpy()[:, rows], np.asarray(j_tokens)[:, rows])


# -- the trainers' checkpoints ------------------------------------------------


def test_bf16_arch1_checkpoint_read_by_both_eval_clis(dataset, tmp_path):  # noqa: F811
    """``train_vqa_arch1 --compute_dtype bfloat16`` writes f32 masters that
    the JAX eval CLI and the port's read alike: identical JSONs."""
    ckpt = str(tmp_path / "bf16") + "/"
    ttrain.main(dataset["common"] + ["--max_iters", "4", "--save_checkpoint_every", "2",
                                     "--compute_dtype", "bfloat16", "--checkpoint_path", ckpt,
                                     "--device", "cpu"])
    flat, meta = tckpt.load_npz(ckpt + "lstm.npz")
    assert meta["cfg"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype == np.float32 for v in flat.values())
    outs = {}
    for name, main, extra in (("jax", jeval.main, []), ("torch", teval.main, ["--device", "cpu"])):
        out = str(tmp_path / name) + "/"
        argv = ["--input_img_h5", dataset["img_h5"], "--input_ques_h5", dataset["ques_h5"],
                "--input_json", dataset["meta"], "--model_path", ckpt + "lstm.h5",
                "--out_path", out, "--batch_size", "8"]
        for k, v in WIDTHS.items():
            argv += [f"--{k}", str(v)]
        main(argv + extra)
        outs[name] = {kind: open(f"{out}{kind}_mscoco_val2014_lstm_novel_new_2_results.json").read()
                      for kind in ("OpenEnded", "MultipleChoice")}
    assert outs["torch"] == outs["jax"] and len(json.loads(outs["jax"]["OpenEnded"])) == 20


def test_bf16_text_ae_checkpoint_read_by_the_jax_converter(corpus, tmp_path, capsys):  # noqa: F811
    ckpt = str(tmp_path / "ae")
    ttext.main(["--input_h5", corpus["h5"], "--input_json", corpus["json"], "--checkpoint_path", ckpt,
                *AE_ARGS, "--max_iters", "4", "--save_checkpoint_every", "2", "--sample_print", "1",
                "--compute_dtype", "bfloat16", "--device", "cpu"])
    losses = [float(ln.split()[-1]) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("iter ")]
    assert losses and np.isfinite(losses).all()
    flat, meta = tckpt.load_npz(os.path.join(ckpt, "model_id.npz"))
    assert meta["cfg"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype == np.float32 for v in flat.values())
    with open(os.path.join(ckpt, "model_id.json")) as f:
        assert all(np.isfinite(list(json.load(f)["val_loss_history"].values())))
    out = str(tmp_path / "converted.h5")
    jconvert.main(["--ae_model", os.path.join(ckpt, "model_id.npz"), "--out", out])
    assert os.path.getsize(out) > 0
    assert sorted(jckpt.load_npz(os.path.join(ckpt, "model_id.npz"))[0]) == sorted(flat)
