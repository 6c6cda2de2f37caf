"""Operations and bytes of the port's LSTM kernels, for their roofline
shares.  They depend only on shapes and on the inputs' lengths, not on
what implements the kernel: the FLOPs of the gate products at the (row,
step) pairs that are active, each input byte read once and each output
byte written once, all float32.
"""

from __future__ import annotations

F32 = 4


def gate_flops(pairs: float, n_in: int, hidden: int) -> float:
    """x Wx + h Wh at ``pairs`` active (row, step) pairs: 2 FLOPs per
    multiply-add, 4H gate columns, In + H inputs."""
    return 2.0 * pairs * 4 * hidden * (n_in + hidden)


def lstm_seq(T: int, N: int, n_in: int, hidden: int, active_pairs: float):
    """(FLOPs, bytes) of one masked layer over T steps (xs, mask, Wx, Wh,
    b read; c, h and the (T, N, H) hidden sequence written)."""
    read = T * N * n_in + T * N + (n_in + hidden) * 4 * hidden + 4 * hidden
    written = 2 * N * hidden + T * N * hidden
    return gate_flops(active_pairs, n_in, hidden), F32 * (read + written)


def lstm_step(N: int, n_in: int, hidden: int):
    """(FLOPs, bytes) of one cell step over all N rows (x, h, c, Wx, Wh, b
    read; c', h' written)."""
    read = N * n_in + 2 * N * hidden + (n_in + hidden) * 4 * hidden + 4 * hidden
    written = 2 * N * hidden
    return gate_flops(N, n_in, hidden), F32 * (read + written)
