"""The port's kernel launches per optimizer step in the window: every
launch counter of its kernel modules (``lstm_seq``,
``lstm_seq_backward``, ...; ``harness._counters``), their increments
summed over the window's steps.  On the CPU the plain versions run and
count no launch, so it reads 0 there."""


def read(m):
    if not m.counters or not m.steps:
        return None
    return sum(m.counters.values()) / m.steps
