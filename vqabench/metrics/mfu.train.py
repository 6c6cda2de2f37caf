"""The whole training step's share of the card's peak: the
configuration's model FLOPs at the window's active tokens
(``flops/<config>.train``, recompute not counted) over the window's wall
time, against the fp32 peak (the configurations are float32, TF32 off)."""


def read(m):
    if m.peaks is None:
        return None
    return 100.0 * m.model_flops / m.window_s / m.peaks["fp32"]
