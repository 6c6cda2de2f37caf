"""The allocator's peak over the measured window (``max_memory_allocated``,
reset when the window opens), in GiB."""


def read(m):
    return m.window_peak_bytes / 2 ** 30
