"""The FLOP and byte counts against counts made by hand."""

import json

import pytest

from vqabench.flops import arch1 as A
from vqabench.flops import kernels as K
from vqabench.flops import text_ae as X
from vqabench.spec import PACKAGE

ARCH1 = json.loads((PACKAGE / "configs" / "arch1.json").read_text())
TEXT_AE = json.loads((PACKAGE / "configs" / "text_ae.json").read_text())


def test_arch1_per_token_both_layers():
    # 2*4*512*(200+512) + 2*4*512*(512+512)
    assert A.lstm_flops_per_token(ARCH1) == 2 * 4 * 512 * 712 + 2 * 4 * 512 * 1024 == 7_110_656


def test_arch1_small_batch_by_hand():
    # 3 questions of 2, 5 and 7 tokens
    tokens, q = 2 + 5 + 7, 3
    head = 2 * 2048 * 1024 + 2 * 4096 * 1024 + 2 * 1024 * 1000
    fwd = tokens * 7_110_656 + q * head
    assert A.forward(ARCH1, tokens, q) == fwd
    # training: fwd + weights' grads + inputs' grads, no input grad for the image
    assert A.train(ARCH1, tokens, q) == 3 * fwd - q * 2 * 4096 * 1024


def test_text_ae_small_batch_by_hand():
    # 2 sentences of 3 and 5 tokens: the encoder runs 5 steps for both rows,
    # the decoder 4 and 6 predictions, greedy 16 steps each
    gate = 2 * 4 * 512 * (512 + 512)
    proj = 2 * 512 * 20001
    nll = 2 * 5 * gate + (4 + 6) * (gate + proj)
    assert X.nll_forward(TEXT_AE, 2, 5, 3 + 5) == nll
    assert X.train(TEXT_AE, 2, 5, 3 + 5) == 3 * nll
    assert X.validate(TEXT_AE, 2, 5, 3 + 5) == nll + 2 * 16 * (gate + proj)


@pytest.mark.parametrize("n_in", [200, 512])
def test_kernel_counts(n_in):
    T, N, H, pairs = 16, 500, 512, 3100
    f, b = K.lstm_seq(T, N, n_in, H, pairs)
    assert f == 2 * pairs * 4 * H * (n_in + H)
    assert b == 4 * (T * N * n_in + T * N + (n_in + H) * 4 * H + 4 * H + 2 * N * H + T * N * H)
    f, b = K.lstm_step(N, n_in, H)
    assert f == 2 * N * 4 * H * (n_in + H)
    assert b == 4 * (N * n_in + 2 * N * H + (n_in + H) * 4 * H + 4 * H + 2 * N * H)


def test_bound_takes_the_larger_per_launch():
    from vqabench.peaks import PEAKS, bound_seconds
    p = PEAKS["NVIDIA H100 80GB HBM3"]
    assert bound_seconds([(2, 67e12, 0.0)], p) == pytest.approx(2.0)
    assert bound_seconds([(1, 0.0, 3.35e12), (1, 67e9, 0.0)], p) == pytest.approx(1.001)
