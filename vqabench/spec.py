"""``BENCHMARK.json`` and the files it names, loaded and checked.

The harness is driven by data: a cell, a configuration or a metric is
added by adding files, which :func:`load` finds by the names in
``BENCHMARK.json`` and checks against the benchmark's rules (the keys of
each entry, the characters of names and units, that every file named
exists).  Nothing here imports torch.

A configuration ``<config>`` brings, besides its entry in ``BENCHMARK.json``:
  * ``configs/<config>.json``: the widths as run, their source, what was
    cut or assumed, the dtype, the module names of its reference, FLOP
    count and faults, and under ``rehearse.cpu`` its widths cut to a size
    a CPU test holds;
  * ``refs/<reference>.py``: the plain reference (torch only);
  * ``flops/<flops>.py``: the model FLOPs the MFU readers divide;
  * ``faults/<faults>.py``: ``FAULTS``, the faults its cells can have, by
    name (``faults/__init__.py`` says how one is planted).
A cell ``<cell>`` brings:
  * ``workloads/<cell>.json``: the configuration, the entry, the
    traffic's parameters and generator, the environment, the limits of
    ``correct``, and ``rehearse``: ``cpu`` and ``card``, the overrides
    (``config``, ``cell``) that size its rehearsals on the CPU and on the
    card, ``faults``, the names of the faults planted under it in the
    tests, ``spans``, the program spans its calls hold, and
    ``card_counts``, the counter readings its card rehearsal must give;
  * ``entries/<entry>.py`` and ``traffic/<generator>.py``, where it drives
    a new entry point or reads a new kind of traffic;
  * ``metrics/<metric>.py`` for each new metric: ``read(m)`` of the
    harness's readings (``harness.py`` lists them).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MODULE_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
CELL_FILE_KEYS = {"config", "entry", "traffic", "limits", "why"}
CELL_FILE_OPTIONAL = {"env", "rehearse"}
REHEARSE_KEYS = {"cpu", "card", "faults", "spans"}
REHEARSE_OPTIONAL = {"card_counts"}
SIZES = ("cpu", "card")
CONFIG_FILE_REQUIRED = {"name", "source", "reduced", "assumed", "dtype", "reference", "flops",
                        "faults"}


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks a rule."""


@dataclasses.dataclass
class Bench:
    root: Path  # the checkout: BENCHMARK.json and the package
    raw: dict
    configs: Dict[str, dict]  # name -> the configuration file's content
    cells: Dict[str, dict]  # name -> the workload file's content
    end_to_end: Dict[str, dict]
    per_layer: Dict[str, dict]

    def metrics_of(self, cell: str):
        """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
        e2e = [m for m in self.end_to_end.values() if cell in m.get("workloads", [cell])]
        moved = {m["name"] for m in e2e}
        layer = [m for m in self.per_layer.values()
                 if m["moves"] in moved and cell in m.get("workloads", [cell])]
        return e2e, layer

    def rehearsal(self, cell: str, where: str) -> dict:
        """The overrides that size ``cell``'s rehearsal ``where`` (``cpu``
        or ``card``), as ``harness.run`` takes them: the configuration's
        own widths at that size, then the cell's."""
        body = self.cells[cell]
        sizes = body["rehearse"][where]
        base = self.configs[body["config"]].get("rehearse", {}).get(where, {})
        return {"config": merge(base, sizes.get("config")), "cell": sizes.get("cell", {})}


def merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over`` merged in, nested dicts key by key."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _line(text, what: str, limit: int = 200) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= limit or "\n" in text or "\t" in text:
        raise SpecError(f"{what}: 1 to {limit} characters on one line, no tab: {text!r}")


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not NAME_RE.match(text):
        raise SpecError(f"{what}: not a name (letters, digits, _ . -, at most 64): {text!r}")


def _keys(entry: dict, allowed: set, optional: set, what: str) -> None:
    keys = set(entry)
    if not allowed <= keys or keys - allowed - optional:
        raise SpecError(f"{what}: keys {sorted(keys)}, expected {sorted(allowed)}"
                        + (f" and optionally {sorted(optional)}" if optional else ""))


def _unique(entries: List[dict], what: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for e in entries:
        _name(e.get("name"), f"{what} name")
        if e["name"] in out:
            raise SpecError(f"{what} {e['name']!r} appears twice")
        out[e["name"]] = e
    return out


def _module(kind: str, name: str) -> Path:
    if not MODULE_RE.match(name or ""):
        raise SpecError(f"{kind} {name!r}: not a module name")
    path = PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"{kind}/{name}.py is missing")
    return path


def fault_names(name: str) -> set:
    """The faults that ``faults/<name>.py`` defines (its ``FAULTS``), read
    from the file; a fault module imports neither torch nor the port."""
    path = _module("faults", name)
    mod_spec = importlib.util.spec_from_file_location(f"vqabench_faults_of_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return set(mod.FAULTS)


def _sizes(value, what: str) -> None:
    if not isinstance(value, dict) or set(value) - {"config", "cell"} or \
            not all(isinstance(v, dict) for v in value.values()):
        raise SpecError(f"{what}: a dict of overrides, 'config' and 'cell', each a dict")


def _rehearse(body: dict, faults: set, what: str) -> None:
    r = body["rehearse"]
    if not isinstance(r, dict):
        raise SpecError(f"{what} rehearse: a dict")
    _keys(r, REHEARSE_KEYS, REHEARSE_OPTIONAL, f"{what} rehearse")
    for where in SIZES:
        _sizes(r[where], f"{what} rehearse.{where}")
    for key in ("faults", "spans"):
        if not isinstance(r[key], list) or not all(isinstance(x, str) for x in r[key]):
            raise SpecError(f"{what} rehearse.{key}: a list of names")
    unknown = set(r["faults"]) - faults
    if unknown:
        raise SpecError(f"{what} rehearse.faults: no such fault {sorted(unknown)}")
    counts = r.get("card_counts", {})
    if not isinstance(counts, dict) or \
            not all(isinstance(v, (int, float)) for v in counts.values()):
        raise SpecError(f"{what} rehearse.card_counts: metric names to numbers")


def load(root: Path | str | None = None) -> Bench:
    """Read ``<root>/BENCHMARK.json`` (the checkout this package lies in by
    default) and every file it names; raise :class:`SpecError` on a
    broken rule."""
    root = Path(root) if root is not None else PACKAGE.parent
    raw = json.loads((root / "BENCHMARK.json").read_text())
    if set(raw) != TOP_KEYS:
        raise SpecError(f"BENCHMARK.json keys {sorted(raw)}, expected {sorted(TOP_KEYS)}")
    if not isinstance(raw["run_seconds"], int) or not 1 <= raw["run_seconds"] <= 51:
        raise SpecError("run_seconds: a whole number from 1 to 51")
    for p in raw["paths"]:
        if not re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) or p.startswith("/") or ".." in p:
            raise SpecError(f"paths: {p!r}")

    configs, faults = {}, {}
    for c in _unique(raw["configs"], "config").values():
        _keys(c, CONFIG_KEYS, set(), f"config {c['name']}")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if len(c["reduced"]) > 16:
            raise SpecError(f"config {c['name']}: reduced lists more than 16 keys")
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
        if c["file"] != f"vqabench/configs/{c['name']}.json":
            raise SpecError(f"config {c['name']}: file must be vqabench/configs/{c['name']}.json")
        body = json.loads((root / c["file"]).read_text())
        missing = CONFIG_FILE_REQUIRED - set(body)
        if missing:
            raise SpecError(f"{c['file']}: missing {sorted(missing)}")
        if body["name"] != c["name"] or body["source"] != c["source"]:
            raise SpecError(f"{c['file']}: name and source differ from BENCHMARK.json")
        if sorted(body["reduced"]) != sorted(c["reduced"]):
            raise SpecError(f"{c['file']}: reduced differs from BENCHMARK.json")
        _module("refs", body["reference"])
        _module("flops", body["flops"])
        rehearse = body.get("rehearse", {})
        if not isinstance(rehearse, dict) or set(rehearse) - set(SIZES) or \
                not all(isinstance(v, dict) for v in rehearse.values()):
            raise SpecError(f"{c['file']}: rehearse maps cpu or card to a dict of widths")
        configs[c["name"]] = body
        faults[c["name"]] = fault_names(body["faults"])

    e2e = _unique(raw["end_to_end"], "metric")
    layer = _unique(raw["per_layer"], "metric")
    if set(e2e) & set(layer):
        raise SpecError(f"metrics named twice: {sorted(set(e2e) & set(layer))}")
    if "setup_s" not in e2e:
        raise SpecError("end_to_end must hold setup_s")

    cells = {}
    pairs = set()
    for w in _unique(raw["workloads"], "workload").values():
        what = f"workload {w['name']}"
        _keys(w, WORKLOAD_KEYS, set(), what)
        _name(w["traffic"], f"{what} traffic")
        _line(w["why"], f"{what} why")
        if w["config"] not in configs:
            raise SpecError(f"{what}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"{what}: chips must be 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"{what}: the pair {w['config']}/{w['traffic']} appears twice")
        pairs.add((w["config"], w["traffic"]))
        body = json.loads((PACKAGE / "workloads" / f"{w['name']}.json").read_text())
        _keys(body, CELL_FILE_KEYS, CELL_FILE_OPTIONAL, f"workloads/{w['name']}.json")
        if body["config"] != w["config"] or body["traffic"].get("name") != w["traffic"]:
            raise SpecError(f"workloads/{w['name']}.json: config or traffic name differs")
        if "rehearse" in body:
            _rehearse(body, faults[w["config"]], f"workloads/{w['name']}.json")
        _module("entries", body["entry"])
        _module("traffic", body["traffic"].get("generator"))
        cells[w["name"]] = dict(body, name=w["name"], chips=w["chips"])

    for what, metrics, keys in (("end_to_end", e2e, E2E_KEYS), ("per_layer", layer, LAYER_KEYS)):
        for m in metrics.values():
            _keys(m, keys, {"workloads"}, f"metric {m['name']}")
            if not UNIT_RE.match(m["unit"]):
                raise SpecError(f"metric {m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
                raise SpecError(f"metric {m['name']}: better or source")
            for c in m.get("workloads", []):
                if c not in cells:
                    raise SpecError(f"metric {m['name']}: unknown workload {c!r}")
            if what == "end_to_end":
                bound = m["bound"]
                if not isinstance(bound, (int, float)) or not 0.01 <= bound <= 0.25:
                    raise SpecError(f"metric {m['name']}: bound {bound!r} outside [0.01, 0.25]")
                if m["source"] not in ("host_clock", "device_trace"):
                    raise SpecError(f"metric {m['name']}: an end-to-end source is "
                                    "host_clock or device_trace")
            else:
                _line(m["layer"], f"metric {m['name']} layer")
                if m["moves"] not in e2e:
                    raise SpecError(f"metric {m['name']}: moves unknown {m['moves']!r}")
            if not (PACKAGE / "metrics" / f"{m['name']}.py").is_file():
                raise SpecError(f"metrics/{m['name']}.py is missing")

    bench = Bench(root, raw, configs, cells, e2e, layer)
    for name in cells:
        got_e2e, got_layer = bench.metrics_of(name)
        names = {m["name"] for m in got_e2e}
        if "setup_s" not in names or len(names) < 2 or not got_layer:
            raise SpecError(f"workload {name}: reports setup_s, another end-to-end metric "
                            "and a per-layer metric")
        counted = set(cells[name].get("rehearse", {}).get("card_counts", {}))
        if counted - {m["name"] for m in got_layer}:
            raise SpecError(f"workload {name}: card_counts names metrics it does not report: "
                            f"{sorted(counted - {m['name'] for m in got_layer})}")
    for name in configs:
        if not any(c["config"] == name for c in cells.values()):
            raise SpecError(f"config {name}: no cell uses it")
    return bench
