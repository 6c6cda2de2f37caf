"""The port's arch1 forward, eval paths, prediction and loss against the JAX
package, from the same params carried across by ``core/convert.py``.
Tolerance: rtol/atol 1e-5 on scores and losses; predictions exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novel_vqa_tpu.models.vqa import arch1 as jarch1
from novel_vqa_tpu.models.vqa.predict import device_predict as j_device_predict
from novel_vqa_tpu.ops import a_b_apply as j_a_b_apply
from novel_vqa_tpu.ops import cross_entropy as j_cross_entropy
from novel_vqa_tpu.ops import embedding_lookup as j_embedding_lookup

from novel_vqa_torch.core.convert import arch1_params_from_numpy
from novel_vqa_torch.models.vqa import arch1 as tarch1
from novel_vqa_torch.models.vqa.predict import device_predict, host_mc_predict
from novel_vqa_torch.ops.embedding import embedding_lookup
from novel_vqa_torch.ops.fusion import a_b_apply
from novel_vqa_torch.ops import lstm as tlstm
from novel_vqa_torch.ops.losses import cross_entropy

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, H, L, F, C, O, D = 30, 12, 16, 2, 20, 10, 7, 8


def _cfgs(fusion):
    kw = dict(
        vocab_size=V, input_encoding_size=E, rnn_size=H, rnn_layer=L,
        nhimage=F, common_embedding_size=C, num_output=O, fusion=fusion,
    )
    return jarch1.Arch1Config(**kw), tarch1.Arch1Config(**kw)


def _params(jcfg, seed=0):
    return jax.device_get(jarch1.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(n, seed):
    rs = np.random.RandomState(seed)
    tokens = np.zeros((n, D), np.int32)
    for i in range(n):
        length = rs.randint(1, D + 1)
        tokens[i, D - length :] = rs.randint(1, V + 1, size=length)
    image = rs.randn(n, F).astype(np.float32)
    image /= np.linalg.norm(image, axis=1, keepdims=True)
    return tokens, image


@pytest.mark.parametrize("fusion", ["axb", "askipb"])
def test_apply_matches_jax(fusion):
    jcfg, tcfg = _cfgs(fusion)
    params = _params(jcfg)
    tokens, image = _batch(13, seed=1)
    ref = jarch1.apply(params, jcfg, jnp.asarray(tokens), jnp.asarray(image), deterministic=True)
    got = tarch1.apply(
        arch1_params_from_numpy(params, "cpu"), tcfg, torch.from_numpy(tokens), torch.from_numpy(image)
    )
    assert got.shape == (13, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_apply_rejects_training_mode_and_unknown_fusion():
    jcfg, tcfg = _cfgs("axb")
    tp = arch1_params_from_numpy(_params(jcfg), "cpu")
    tokens, image = (torch.from_numpy(a) for a in _batch(3, seed=2))
    # training mode draws dropout masks: without a generator it refuses
    with pytest.raises(ValueError, match="generator"):
        tarch1.apply(tp, tcfg, tokens, image, deterministic=False)
    # the training options run (tests/test_torch_bf16.py and
    # test_torch_remat.py hold them against the JAX package): bf16 gives
    # f32 scores within JAX's own bf16 bound (5e-2) of the f32 route's, and
    # remat the scores of no remat from the same generator seed
    f32 = tarch1.apply(tp, tcfg, tokens, image)
    bf16 = tarch1.apply(tp, tcfg._replace(compute_dtype="bfloat16"), tokens, image)
    assert bf16.dtype == torch.float32 and 0 < float((bf16 - f32).abs().max()) < 5e-2
    train = [tarch1.apply(tp, tcfg._replace(remat=remat), tokens, image,
                          generator=torch.Generator().manual_seed(1), deterministic=False)
             for remat in (False, True)]
    assert torch.equal(train[0], train[1])
    with pytest.raises(ValueError, match="compute_dtype"):
        tarch1.apply(tp, tcfg._replace(compute_dtype="float16"), tokens, image)
    with pytest.raises(ValueError, match="fusion"):
        tarch1.apply(tp, tcfg._replace(fusion="nope"), tokens, image)


def _store(n, seed):
    rs = np.random.RandomState(seed)
    tokens, _ = _batch(n, seed)
    n_img = 5
    image = rs.randn(n_img, F).astype(np.float32)
    mc = rs.randint(0, O + 1, size=(n, 18)).astype(np.int32)
    mc[0] = 0  # a row with no valid choice
    return {
        "tokens": tokens,
        "image": image,
        "img_pos": rs.randint(1, n_img + 1, size=n).astype(np.int32),
        "answers": rs.randint(1, O + 1, size=n).astype(np.int32),
        "mc_ans": mc,
    }


def test_eval_paths_match_jax():
    """All four eval paths, with n % batch_size != 0 (the final chunk's
    clamp to row n-1)."""
    jcfg, tcfg = _cfgs("axb")
    params = _params(jcfg, seed=3)
    tp = arch1_params_from_numpy(params, "cpu")
    store = _store(13, seed=3)
    jstore = {k: jnp.asarray(v) for k, v in store.items()}
    tstore = {k: torch.from_numpy(v) for k, v in store.items()}

    j_losses, j_pred, j_mc = jarch1.eval_predict_scan(jcfg, params, jstore, 3, 5)
    t_losses, t_pred, t_mc = tarch1.eval_predict_scan(tcfg, tp, tstore, 3, 5)
    assert t_pred.shape == (3, 5) and t_pred.dtype == torch.int32
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), **TOL)
    np.testing.assert_array_equal(t_pred.numpy(), np.asarray(j_pred))
    np.testing.assert_array_equal(t_mc.numpy(), np.asarray(j_mc))

    _, j_scores = jarch1.eval_scores_scan(jcfg, params, jstore, 3, 5)
    _, t_scores = tarch1.eval_scores_scan(tcfg, tp, tstore, 3, 5)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), **TOL)

    qinds = np.array([4, 0, 12, 7], np.int32)
    j_loss, j_sc = jarch1.eval_step_indexed(jcfg, params, jstore, jnp.asarray(qinds))
    t_loss, t_sc = tarch1.eval_step_indexed(tcfg, tp, tstore, torch.from_numpy(qinds))
    np.testing.assert_allclose(float(t_loss), float(j_loss), **TOL)
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), **TOL)
    _, j_p, j_m = jarch1.eval_predict_indexed(jcfg, params, jstore, jnp.asarray(qinds))
    _, t_p, t_m = tarch1.eval_predict_indexed(tcfg, tp, tstore, torch.from_numpy(qinds))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))


def _predict_case():
    scores = np.array(
        [
            [0.1, 0.9, 0.9, 0.2],   # OE tie: first max (answer 2)
            [0.5, 0.1, 0.3, 0.5],   # OE tie between answers 1 and 4
            [0.0, 0.2, 0.7, 0.1],
            [0.3, 0.3, 0.3, 0.3],   # all tied
        ],
        np.float32,
    )
    choices = np.array(
        [
            [3, 2, 0, 0],  # MC tie between choices 3 and 2: first listed (3)
            [0, 0, 0, 0],  # no valid choice: falls back to the OE pred
            [1, 4, 0, 2],
            [4, 0, 1, 3],  # all tied: first valid (4)
        ],
        np.int32,
    )
    return scores, choices


def test_device_predict_matches_jax_with_ties_and_empty_rows():
    scores, choices = _predict_case()
    j_pred, j_mc = j_device_predict(jnp.asarray(scores), jnp.asarray(choices))
    t_pred, t_mc = device_predict(torch.from_numpy(scores), torch.from_numpy(choices))
    np.testing.assert_array_equal(t_pred.numpy(), np.asarray(j_pred))
    np.testing.assert_array_equal(t_mc.numpy(), np.asarray(j_mc))
    assert t_pred.tolist() == [2, 1, 3, 1] and t_mc.tolist() == [3, 1, 2, 4]
    # the host loop of the streaming path agrees
    np.testing.assert_array_equal(host_mc_predict(scores, choices, t_pred.numpy()), t_mc.numpy())
    # no choices: mc_pred is pred
    p, m = device_predict(torch.from_numpy(scores))
    assert torch.equal(p, m)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(4)
    scores = rs.randn(9, 6).astype(np.float32)
    # label 0 is an unlabelled split's placeholder (wraps to the last class)
    labels = np.array([1, 6, 3, 2, 0, 5, 4, 1, 6], np.int32)
    ref = j_cross_entropy(jnp.asarray(scores), jnp.asarray(labels))
    got = cross_entropy(torch.from_numpy(scores), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_embedding_and_a_b_fusion_match_jax():
    rs = np.random.RandomState(5)
    table = rs.randn(V, E).astype(np.float32)
    bias = rs.randn(E).astype(np.float32)
    tokens = np.array([[0, 1, V, V + 3]], np.int32)  # null and out-of-range clip
    ref = j_embedding_lookup(jnp.asarray(table), jnp.asarray(tokens), jnp.asarray(bias))
    got = embedding_lookup(torch.from_numpy(table), torch.from_numpy(tokens), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    fus = {
        "wq": rs.randn(6, C).astype(np.float32), "bq": rs.randn(C).astype(np.float32),
        "wi": rs.randn(F, C).astype(np.float32), "bi": rs.randn(C).astype(np.float32),
    }
    q = rs.randn(4, 6).astype(np.float32)
    i = rs.randn(4, F).astype(np.float32)
    ref = j_a_b_apply({k: jnp.asarray(v) for k, v in fus.items()}, jnp.asarray(q), jnp.asarray(i))
    got = a_b_apply(
        {k: torch.from_numpy(v) for k, v in fus.items()}, torch.from_numpy(q), torch.from_numpy(i)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_init_params_layout_matches_jax():
    jcfg, tcfg = _cfgs("axb")
    ref = _params(jcfg)
    got = tarch1.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(got) == shapes(ref)
    assert all(v.device.type == "cpu" for v in got["fusion"].values())


@pytest.mark.parametrize(
    "build",
    [
        lambda: tarch1.init_params(_cfgs("axb")[1], torch.Generator().manual_seed(0)),
        lambda: tlstm.lstm_layer_init(torch.Generator().manual_seed(0), 8, 16),
        lambda: arch1_params_from_numpy({"b": np.zeros(3, np.float32)}, "cuda"),
    ],
    ids=["arch1.init_params", "lstm_layer_init", "arch1_params_from_numpy"],
)
def test_param_builders_default_to_cuda_and_never_fall_back(build):
    """Params land on the card unless the caller names the CPU; without a
    card, asking for it raises rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        assert _first_leaf(build()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build()


def _first_leaf(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree
