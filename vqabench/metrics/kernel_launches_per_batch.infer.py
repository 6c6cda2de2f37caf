"""The port's kernel launches per batch in the window: every launch
counter of its kernel modules (``lstm_seq``, ``lstm_step``, ...;
``harness._counters``), their increments summed over the window's
batches.  On the CPU the plain versions run and count no launch, so it
reads 0 there."""


def read(m):
    if not m.counters or not m.steps:
        return None
    return sum(m.counters.values()) / m.steps
