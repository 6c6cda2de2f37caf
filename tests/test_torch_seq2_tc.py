"""The seq2 kernel's packed weights (``kernels/lstm2.pack_weights``)
against the tensor-core products they feed, emulated lane by lane.

``csrc/lstm2.cu`` computes each layer's gates as mma.sync m16n8k16 products:
the packed weights are the A operand (16 gate columns by 16 k), the
activation tile in shared memory ([row][k], k padded to 16 per matrix) the
B operand (16 k by 8 rows).  The emulation reads, for every lane, the
fragment registers the PTX ISA assigns it (A: rows g and g + 8, k 2t + {0,
1} and + 8; B: row g, the same k; D: gate rows g and g + 8, rows 2t + {0,
1}; g = lane // 4, t = lane % 4) from those layouts and scatters the lanes'
accumulators to (row, gate column) as the kernel's epilogue does.  In
float64 the result equals x @ Wx + h @ Wh + b up to the order of the sums."""

import numpy as np
import pytest
import torch

from novel_vqa_torch.kernels import lstm2 as K2

# the kernel check's odd shapes and the train step's (chip_smoke.SEQ2_CASES)
SHAPES = [(13, 24, 40), (13, 24, 600), (500, 200, 512)]
# pack_weights' permutation, (chunk, kh, tr, kl, m tile, mh, q, group, gr)
# -> (q, group, chunk, m tile, gr, tr, kh, mh, kl), undone
UNPACK = tuple(int(i) for i in np.argsort((6, 7, 0, 4, 8, 2, 1, 5, 3)))

LANE = np.arange(32)
GR, TR = LANE // 4, LANE % 4
# A fragment: element e = 4 kh + 2 mh + kl of a lane is (m, k)
_E = np.arange(8)
A_M = GR[:, None] + 8 * ((_E // 2) % 2)
A_K = 2 * TR[:, None] + _E % 2 + 8 * (_E // 4)
# B fragment: b0 = (k 2t, 2t + 1), b1 = (k 2t + 8, 2t + 9), column n = g
_F = np.arange(4)
B_K = 2 * TR[:, None] + _F % 2 + 8 * (_F // 2)
B_N = np.broadcast_to(GR[:, None], (32, 4))
# D: d[i] is (m g + 8 (i // 2), n 2t + i % 2)
C_M = GR[:, None] + 8 * (_F // 2)
C_N = 2 * TR[:, None] + _F % 2


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16(rs, *shape, scale=1.0):
    return torch.from_numpy(rs.uniform(-scale, scale, shape).astype(np.float32)).to(torch.bfloat16)


def _dims(In, H, C=4):
    """The layout ``nvqa_lstm_seq2_dims`` gives at (In, H) with C CTAs per
    cluster: U units per CTA, G groups of 8 of them, In and H padded to 16.
    The kernel checks on the card pack with the library's own."""
    U = -(-H // C)
    return K2.Seq2Dims(C, U, -(-U // 8), -(-In // 16) * 16, -(-H // 16) * 16)


def _layers(In, H, seed=0):
    """wx1, wh1, b1, wx2, wh2, b2 in bf16."""
    rs = np.random.RandomState(seed)
    return [_bf16(rs, *shape, scale=scale) for shape, scale in (
        ((In, 4 * H), 0.08), ((H, 4 * H), 0.08), ((4 * H,), 0.16),
        ((H, 4 * H), 0.08), ((H, 4 * H), 0.08), ((4 * H,), 0.16))]


def test_fragment_maps_cover_each_tile_once():
    for rows, cols, shape in ((A_M, A_K, (16, 16)), (B_K, B_N, (16, 8)), (C_M, C_N, (16, 8))):
        hits = np.zeros(shape, int)
        np.add.at(hits, (rows, cols), 1)
        assert (hits == 1).all()


@pytest.mark.parametrize("In, H", [(24, 40), (24, 600), (200, 512), (13, 37), (512, 512)])
def test_pack_weights_round_trips_and_pads_with_zeros(In, H):
    wx1, wh1, _, wx2, wh2, _ = _layers(In, H)
    dims = _dims(In, H)
    packed = K2.pack_weights(wx1, wh1, wx2, wh2, dims)
    C, U, G, KX, KH = dims
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (C, G, (KX + 3 * KH) // 16, 2, 8, 4, 2, 2, 2)
    w = packed.permute(*UNPACK).reshape(KX + 3 * KH, 4, C, 8 * G)
    for part, k0 in ((wx1, 0), (wh1, KX), (wx2, KX + KH), (wh2, KX + 2 * KH)):
        cols = w[k0:k0 + part.shape[0], :, :, :U].reshape(part.shape[0], 4, C * U)
        assert torch.equal(cols[..., :H].reshape(part.shape), part)
    # everything else is padding: as many nonzeros as the four matrices hold
    assert int((packed != 0).sum()) == sum(int((m != 0).sum()) for m in (wx1, wh1, wx2, wh2))


def _emulate(packed, act, b, N, H):
    """The gates (N, 4H) as the kernel's warps compute them from the packed
    weights and the [row][k] activation tile ``act`` (rows padded to 8),
    every value read and written through the lane maps above."""
    C_, G, chunks = packed.shape[:3]
    U = -(-H // C_)
    P = packed.float().numpy().astype(np.float64).reshape(C_, G, chunks, 2, 32, 8)
    A = np.zeros((C_, G, chunks, 2, 16, 16))
    A[..., A_M, A_K] = P
    NT = act.shape[0] // 8
    vals = act.reshape(NT, 8, chunks, 16)[:, B_N, :, B_K]  # (32, 4, NT, chunks)
    B = np.zeros((NT, chunks, 16, 8))
    B[:, :, B_K, B_N] = vals.transpose(2, 3, 0, 1)
    D = np.einsum("qgcmik,tckn->qgmtin", A, B, optimize=True)  # (C, G, 2, NT, 16, 8)
    lanes = D[..., C_M, C_N]  # (C, G, 2, NT, 32, 4)
    out = np.full((NT * 8, 4 * H), np.nan)
    bias = b.float().numpy().astype(np.float64)
    for q in range(C_):
        for grp in range(G):
            u = grp * 8 + GR  # each lane's unit of the CTA
            own = (u < U) & (q * U + u < H)
            j = q * U + u[own]
            for m in range(2):
                for nt in range(NT):
                    for i in range(4):
                        col = (2 * m + i // 2) * H + j
                        row = nt * 8 + C_N[own, i]
                        assert np.isnan(out[row, col]).all()
                        out[row, col] = lanes[q, grp, m, nt, own, i] + bias[col]
    return out[:N]


@pytest.mark.parametrize("N, In, H", SHAPES)
def test_packed_fragments_compute_both_layers_products(N, In, H):
    wx1, wh1, b1, wx2, wh2, b2 = _layers(In, H, seed=N + H)
    dims = _dims(In, H)
    packed = K2.pack_weights(wx1, wh1, wx2, wh2, dims)
    KX, KH = dims.KX, dims.KH
    rs = np.random.RandomState(1)
    f64 = lambda t: t.float().numpy().astype(np.float64)  # noqa: E731
    rows = -(-N // 8) * 8
    # layer 1 reads [x_t | bf16(h1)], layer 2 [d | bf16(h2)], each [row][k]
    # with k padded to 16 per matrix; its chunks follow layer 1's in the pack
    for a_in, wx, wh, b, chunks in ((In, wx1, wh1, b1, slice(0, (KX + KH) // 16)),
                                    (H, wx2, wh2, b2, slice((KX + KH) // 16, None))):
        a, h = _bf16(rs, N, a_in), _bf16(rs, N, H)
        ka = -(-a_in // 16) * 16
        act = np.zeros((rows, ka + KH))
        act[:N, :a_in] = f64(a)
        act[:N, ka:ka + H] = f64(h)
        got = _emulate(packed[:, :, chunks], act, b, N, H)
        ref = f64(a) @ f64(wx) + f64(h) @ f64(wh) + f64(b)
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
