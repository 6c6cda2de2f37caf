"""The share of the traced segment in which no operation ran on the card:
the union of the card's operations in the profiler's trace of its
activity (``trace.capture``) against the segment's length.  The trace's
per-launch cost lengthens the host's issue, so where the host paces the
card the segment reads more idle than the untraced window would."""


def read(m):
    if m.trace is None or not m.trace.ops:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
