"""Host milliseconds per inference batch: the host clock around each call
of the inference entry in the window (one batch, returning before the
card finishes), summed, over the batches."""


def read(m):
    return 1e3 * m.host_s / m.steps if m.steps else None
