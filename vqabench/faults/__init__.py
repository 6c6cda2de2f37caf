"""Faults planted underneath a cell's timed path, to show that the check
which decides ``correct`` catches them (``calibrate.py`` on the card,
``tests/test_vqabench_faults.py`` on the CPU).  Never used by a benchmark run.

Each configuration names its module of faults (``faults`` in its
configuration file): ``faults/<module>.py`` defines ``FAULTS``, each
fault by name as ``(port module, attribute, make)``: planting it replaces
the attribute by ``make(original)`` for the block.  A fault module
imports neither torch nor the port (``spec.load`` reads its names).  A
cell lists the faults it can have under ``rehearse.faults`` in its
workload file.
"""

from __future__ import annotations

import contextlib
import importlib

from vqabench import spec as S

# the optimizer's update is not applied: the state comes back as it went in
UNCHANGED = ("novel_vqa_torch.parallel.mesh", "apply_updates",
             lambda original: (lambda params, updates: params))


@contextlib.contextmanager
def plant(workload: str, name: str):
    """The port with fault ``name`` of ``workload``'s configuration inside
    the block."""
    bench = S.load()
    faults = bench.configs[bench.cells[workload]["config"]]["faults"]
    module_name, attr, make = importlib.import_module(f"vqabench.faults.{faults}").FAULTS[name]
    module = importlib.import_module(module_name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
