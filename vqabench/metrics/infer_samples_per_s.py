"""Forward-only throughput: the samples answered in the measured window
over all of the window's time (host clock, from the
first call to the card's end)."""


def read(m):
    return m.units / m.window_s
