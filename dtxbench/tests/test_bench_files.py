"""The benchmark's files: BENCHMARK.json against the contract's shapes,
and every cell's workload, config, traffic, driver, metric reader and
kernel class found by name."""

import json
import re

import pytest

from dtxbench.harness import spec
from dtxbench.harness.env import BENCH, ROOT

B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]
E2E = {m["name"] for m in B["end_to_end"]}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["dtxbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[key]:
            yield e["name"]
    for w in B["workloads"]:
        yield w["config"]
        yield w["traffic"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_are_valid(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in spec.SOURCES
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in E2E
        assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
        for cell in metric["workloads"]:  # each reports what it moves
            e2e, _ = spec.cell_metrics(B, cell)
            assert metric["moves"] in {m["name"] for m in e2e}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in B["workloads"] if w["name"] == cell)
    wl = spec.workload(cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"]
    assert wl["chips"] == entry["chips"] and entry["chips"] in (1, 4)
    assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
    spec.traffic(wl["traffic"])
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    e2e, layer = spec.cell_metrics(B, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("entry", B["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    c = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("dtxbench/configs/")
    assert c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    assert all(spec.NAME.match(k) for k in entry["reduced"])
    for key in ("hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "vocab_size"):
        assert isinstance(c[key], int)
    assert (ROOT / c["reference"]).exists()


@pytest.mark.parametrize("path", sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernel_classes_named_by_readers_exist(path):
    for name in re.findall(r'kernels"\]\("([^"]+)"\)', path.read_text()):
        assert spec.kernel_class(name)


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"]
                         + B["per_layer"], ids=lambda e: e["name"])
def test_texts_fit_one_line(entry):
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(spec.NAME.match(x.replace(" ", "_").replace(":", "_"))
               for x in layers)


def test_every_file_name_is_made_of_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
