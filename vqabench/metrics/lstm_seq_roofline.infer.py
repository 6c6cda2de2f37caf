"""The lstm_seq kernel's share of its roofline in inference: the least time of
the launches' work (each launch's FLOPs at its active (row, step) pairs
over the fp32 peak, or its bytes read and written once over HBM's rate,
whichever is larger; ``flops/kernels.py``) over the device time of the
kernel's launches in the traced segment."""

from vqabench.peaks import bound_seconds

KERNEL = r"\blstm_seq_kernel\b"


def read(m):
    if m.trace is None or m.peaks is None or "lstm_seq" not in m.traced.kernels:
        return None
    seconds, launches = m.trace.kernel_seconds(KERNEL)
    if not launches:
        return None
    return 100.0 * bound_seconds(m.traced.kernels["lstm_seq"], m.peaks) / seconds
