"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell is found by."""
import json
import re

import pytest

from port_bench.harness import manifest as M

BENCH = M.load_manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
TEXT_RE = re.compile(r"^[^\n\t]{1,200}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(M.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH_RE.match(p) and not p.startswith("/") and ".." not in p
        assert (M.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and all(TEXT_RE.match(w) for w in cmd)
    assert cmd[1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert M.NAME_RE.match(entry["name"])
    assert TEXT_RE.match(entry["source"]) and TEXT_RE.match(entry["why"])
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    cfg = json.loads((M.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_metrics(name):
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and TEXT_RE.match(entry["why"])
    for key in ("name", "config", "traffic"):
        assert M.NAME_RE.match(entry[key])
    for role, path in M.files_of(name).items():
        assert path.is_file(), role
    cell = M.cell(name)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.workload["rate_metric"] in names
    assert cell.per_layer
    assert set(cell.workload["limits"]) and all(
        v > 0 for v in cell.workload["limits"].values())


def test_cells_unique_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(CELLS)) == len(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert M.NAME_RE.match(metric["name"]) and M.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    extra = set(metric) - {"name", "unit", "better", "source", "bound",
                           "layer", "moves", "workloads"}
    assert not extra
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT_RE.match(metric["layer"])
        assert (M.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
        assert callable(M.metric_reader(metric["name"]).read)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_only_where_its_metric_moves(metric):
    """A per-layer metric is reported only in cells that report the
    end-to-end metric it moves; shares of a roofline and of a peak are
    named for it."""
    moves = E2E[metric["moves"]]
    assert metric["moves"] != "setup_s"
    for cell in metric["workloads"]:
        assert M.reports(moves, cell)
    if metric["name"].split(".")[0].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_names_unique_and_setup_bound():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert E2E["setup_s"]["bound"] <= 0.25
    assert "workloads" not in E2E["setup_s"]
