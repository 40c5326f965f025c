"""``BENCHMARK.json`` and the files a cell is made of, found by name.

A cell (an entry of ``workloads``) names a configuration
(``configs/<file>``), a traffic mix (``traffic/<traffic>.json``) and its
own file ``workloads/<cell>.json``, which names its driver
(``drivers/<driver>.py``) and holds the cell's settings, the end-to-end
rate it reports and the limits of its comparison. The per-layer metrics a
cell reports are the manifest's entries that list it under ``workloads``;
each is read by ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Cell(NamedTuple):
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    workload: dict        # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def load_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (a metric without
    ``workloads`` is every cell's)."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict = None) -> Cell:
    """The cell ``name`` of the manifest with its files read."""
    manifest = manifest or load_manifest()
    entry = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    cfg = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    return Cell(
        name=name,
        config=_json(ROOT / cfg["file"]),
        traffic=_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        workload=_json(BENCH_DIR / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)],
        chips=int(entry["chips"]))


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(workload: dict):
    return load_module(BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                       f"port_bench_driver_{workload['driver']}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "port_bench_metric_" + name.replace(".", "_"))


def kernel_counts(name: str):
    return load_module(BENCH_DIR / "kernels" / f"{name}.py",
                       f"port_bench_kernel_{name}")


def files_of(name: str, manifest: dict = None) -> Dict[str, Path]:
    """Every file the cell ``name`` needs, by role."""
    manifest = manifest or load_manifest()
    entry = {w["name"]: w for w in manifest["workloads"]}[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    wl = _json(BENCH_DIR / "workloads" / f"{name}.json")
    out = {"config": ROOT / cfg["file"],
           "traffic": BENCH_DIR / "traffic" / f"{entry['traffic']}.json",
           "workload": BENCH_DIR / "workloads" / f"{name}.json",
           "driver": BENCH_DIR / "drivers" / f"{wl['driver']}.py"}
    for m in manifest["per_layer"]:
        if reports(m, name):
            out[f"metric {m['name']}"] = (BENCH_DIR / "metrics"
                                          / f"{m['name']}.py")
    return out
