"""The benchmark of the PyTorch port (``novel_vqa_torch``) on one NVIDIA card.

One command runs one cell once, from the root of a checkout:

    python3 -m vqabench.run --workload arch1.train --seed 7 --seconds 20 --trace 0

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; everything that belongs to one of them sits in a file of its own
that the harness finds by name:

  * ``configs/<config>.json``: the widths as run, their source, what was
    cut (``reduced``) or assumed, the dtype, the names of the
    configuration's plain reference (``refs/``), FLOP count (``flops/``)
    and faults (``faults/``), and its widths at a CPU test's size;
  * ``workloads/<cell>.json``: the configuration, the entry it drives
    (``entries/``), the traffic's parameters and the generator that reads
    them (``traffic/``), the environment, the limits of the comparison
    that decides ``correct``, why the cell exists, and its rehearsals
    (sizes on the CPU and the card, faults, spans) for the tests;
  * ``metrics/<metric>.py``: one reader per metric.

``spec.py`` lists the files a configuration and a cell bring.

The harness imports ``torch`` and the port, never JAX nor the JAX package.
"""
