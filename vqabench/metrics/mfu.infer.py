"""The whole inference pass's share of the card's peak: the
configuration's forward FLOPs at the window's active tokens over the
window's wall time, against the fp32 peak (float32, TF32 off)."""


def read(m):
    if m.peaks is None:
        return None
    return 100.0 * m.model_flops / m.window_s / m.peaks["fp32"]
