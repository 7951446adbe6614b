"""``BENCHMARK.json`` and the files its names point to.

A cell names a configuration and a traffic mix; the configuration's file
is the one ``BENCHMARK.json`` gives, the traffic mix is
``traffic/<name>.json``, the entry point a mix drives is
``drivers/<driver>.py`` (the mix's ``driver``), the embedder's stage
captures and checks are ``stages/<stages>.py`` (the configuration's
``check.stages``) and a metric's reader is ``metrics/<name>.py``.  Adding
a cell, a configuration, a mix, a driver, an embedder's stages or a metric
adds files and entries and edits none."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, spec: dict = None) -> dict:
    spec = spec or bench()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, spec: dict = None) -> dict:
    spec = spec or bench()
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _plugin(kind: str, name: str):
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise KeyError(f"{kind} {name!r} is not a module name")
    return importlib.import_module(f"snsbench.{kind}.{name}")


def driver(name: str):
    """``drivers/<name>.py``: the entry point a traffic mix drives."""
    return _plugin("drivers", name)


def stages(name: str):
    """``stages/<name>.py``: an embedder's stage captures and checks."""
    return _plugin("stages", name)


def metrics_of(cell_name: str, kind: str, spec: dict = None) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
    with no ``workloads`` key and those that list it."""
    spec = spec or bench()
    return [m for m in spec[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str) -> Callable[[dict], object]:
    """``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or None
    when the run holds nothing for it to read."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "snsbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
