"""Each configuration's plain reference against the port on the CPU at a
small size: the forward, the loss, the gradients and one update, the
dropout masks the port drew handed to the reference by shape."""

import pytest
import torch

from vqabench import common as C
from vqabench.refs import arch1 as R1
from vqabench.refs import text_ae as RX
from vqabench.tests.conftest import SMALL_CONFIG
from vqabench.spec import PACKAGE
import json

CFG1 = {**json.loads((PACKAGE / "configs" / "arch1.json").read_text()), **SMALL_CONFIG["arch1"]}
CFGX = {**json.loads((PACKAGE / "configs" / "text_ae.json").read_text()),
        **SMALL_CONFIG["text_ae"]}


def _arch1_port():
    from novel_vqa_torch.models.vqa import arch1
    cfg = arch1.Arch1Config(vocab_size=CFG1["vocab_size"],
                            input_encoding_size=CFG1["input_encoding_size"],
                            rnn_size=CFG1["rnn_size"], nhimage=CFG1["nhimage"],
                            common_embedding_size=CFG1["common_embedding_size"],
                            num_output=CFG1["num_output"])
    return arch1, cfg


def _arch1_batch(n=12, seed=3):
    g = torch.Generator().manual_seed(seed)
    T = CFG1["seq_length"]
    lengths = torch.randint(1, T + 1, (n,), generator=g)
    words = torch.randint(1, CFG1["vocab_size"] + 1, (n, T), generator=g)
    tokens = torch.where(torch.arange(T)[None] >= T - lengths[:, None], words, 0).int()
    image = torch.randn(n, CFG1["nhimage"], generator=g)
    image /= image.norm(dim=1, keepdim=True)
    answers = torch.randint(1, CFG1["num_output"] + 1, (n,), generator=g).int()
    return tokens, image, answers


def test_arch1_eval_scores_match(two_threads):
    arch1, cfg = _arch1_port()
    params, ref = C.make_weights(R1.param_spec(CFG1), 5, "cpu")
    tokens, image, _ = _arch1_batch()
    got = arch1.apply(params, cfg, tokens, image, deterministic=True)
    want = R1.scores(ref, CFG1, tokens, image)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_arch1_loss_gradients_and_update_match(two_threads):
    arch1, cfg = _arch1_port()
    from novel_vqa_torch.core.tree import value_and_grad
    params, ref = C.make_weights(R1.param_spec(CFG1), 6, "cpu")
    tokens, image, answers = _arch1_batch()
    gen = torch.Generator().manual_seed(11)
    rec = C.DrawRecorder()
    with rec:
        loss, grads = value_and_grad(arch1.loss_fn)(params, cfg, tokens, image, answers, gen)
    masks = C.fill_slots(R1.draw_slots(CFG1, len(tokens)), [u < 0.5 for u in rec.uniforms])
    o = CFG1["optimizer"]
    out = R1.train(ref, CFG1, [(tokens, image, answers, masks)])
    assert out["losses"][0] == pytest.approx(float(loss), rel=1e-6)
    tx = arch1.make_optimizer(learning_rate=o["learning_rate"], decay_factor=o["decay_factor"],
                              grad_clamp=o["grad_clamp"], alpha=o["alpha"], epsilon=o["epsilon"])
    updates, _ = tx.update(grads, tx.init(params), params)
    for path, g in C.leaves(grads):
        name = C.path_name(path)
        torch.testing.assert_close(torch.clamp(g, -10, 10), out["grad1"][name], rtol=1e-4, atol=1e-7)
    for (path, p), (_, u) in zip(C.leaves(params), C.leaves(updates)):
        torch.testing.assert_close(p + u, out["params"][C.path_name(path)], rtol=1e-5, atol=1e-7)


def _ae_port():
    from novel_vqa_torch.models.seq import autoencoder as ae
    cfg = ae.AEConfig(vocab_size=CFGX["vocab_size"], input_encoding_size=CFGX["input_encoding_size"],
                      rnn_size=CFGX["rnn_size"], num_layers=1, seq_length=CFGX["seq_length"])
    return ae, cfg


def _sentences(n=10, seed=4):
    g = torch.Generator().manual_seed(seed)
    T = CFGX["seq_length"]
    lengths = torch.randint(1, T - 2, (n,), generator=g)  # the last steps are null everywhere
    words = torch.randint(1, CFGX["vocab_size"] + 1, (n, T), generator=g)
    return torch.where(torch.arange(T)[None] < lengths[:, None], words, 0).int().t().contiguous()


def test_text_ae_nll_and_greedy_match(two_threads):
    ae, cfg = _ae_port()
    from novel_vqa_torch.train import train_text_ae as tta
    params, ref = C.make_weights(RX.param_spec(CFGX), 7, "cpu")
    seq = _sentences()
    got = float(tta.val_nll(cfg, params, seq))
    assert got == pytest.approx(RX.batch_nll(ref, CFGX, seq), rel=1e-5)
    tokens = tta.greedy_tokens(cfg, params, seq)
    assert float(RX.greedy_gaps(ref, CFGX, seq, tokens).max()) <= 1e-5


def test_text_ae_loss_gradients_and_update_match(two_threads):
    ae, cfg = _ae_port()
    from novel_vqa_torch.core.tree import value_and_grad
    from novel_vqa_torch.train import train_text_ae as tta
    params, ref = C.make_weights(RX.param_spec(CFGX), 8, "cpu")
    seq = _sentences()
    gen = torch.Generator().manual_seed(12)
    rec = C.DrawRecorder()
    with rec:
        loss, grads = value_and_grad(ae.loss_fn)(params, cfg, seq, gen)
    masks = C.fill_slots(RX.draw_slots(CFGX, seq.shape[1]), [u < 0.5 for u in rec.uniforms])
    out = RX.train(ref, CFGX, [(seq, masks)])
    assert out["losses"][0] == pytest.approx(float(loss), rel=1e-6)
    o = CFGX["optimizer"]
    tx = tta.make_tx(tta.AETrainConfig(optim="adam", learning_rate=o["learning_rate"],
                                       optim_alpha=o["beta1"], optim_beta=o["beta2"],
                                       optim_epsilon=o["epsilon"], grad_clip=o["grad_clip"],
                                       weight_decay=o["weight_decay"]))
    updates, _ = tx.update(grads, tx.init(params), params)
    for path, g in C.leaves(grads):
        p = dict((C.path_name(q), t) for q, t in C.leaves(params))[C.path_name(path)]
        want = torch.clamp(g, -0.1, 0.1) + o["weight_decay"] * p
        torch.testing.assert_close(want, out["grad1"][C.path_name(path)], rtol=1e-4, atol=1e-8)
    for (path, p), (_, u) in zip(C.leaves(params), C.leaves(updates)):
        torch.testing.assert_close(p + u, out["params"][C.path_name(path)], rtol=1e-5, atol=1e-7)


def test_masks_fill_slots_whatever_the_draw_order():
    """A (T, N, H) mask drawn at once and T masks of (N, H) drawn step by
    step fill the same slot alike; equal shapes fill in the order drawn."""
    T, N, H = 4, 3, 5
    whole = torch.rand(T, N, H) < 0.5
    emb = torch.rand(N, 7) < 0.5
    slots = [("emb", (N, 7)), ("inter", (T, N, H)), ("last", (N, 6))]
    last = torch.rand(N, 6) < 0.5
    at_once = C.fill_slots(slots, [emb, whole, last])
    by_step = C.fill_slots(slots, [emb, *whole, last])
    for name in ("emb", "inter"):
        assert torch.equal(at_once[name], by_step[name])
    assert torch.equal(by_step["last"], last)
    with pytest.raises(ValueError):
        C.fill_slots(slots, [emb, whole])
