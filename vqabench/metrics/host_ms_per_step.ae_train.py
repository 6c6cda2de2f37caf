"""Host milliseconds per training step: the host clock around each call
of the training entry in the window (the call returns before the card
finishes), summed, over the steps taken."""


def read(m):
    return 1e3 * m.host_s / m.steps if m.steps else None
