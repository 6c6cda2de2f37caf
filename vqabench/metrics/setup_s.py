"""Set-up seconds: from the benchmark's first line to the first timed call
(imports, the card, the kernels' load, traffic and weights made from the
seed, the check's first steps, the warm-up of the cell's own shapes)."""


def read(m):
    return m.setup_s
