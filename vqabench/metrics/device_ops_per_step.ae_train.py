"""The card's operations (kernels, copies, sets) per training step in the
traced segment, from the profiler's trace."""


def read(m):
    if m.trace is None or not m.trace.ops:
        return None
    return len(m.trace.ops) / m.traced.steps
