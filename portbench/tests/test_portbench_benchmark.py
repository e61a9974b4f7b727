"""`BENCHMARK.json` keeps to the benchmark's contract, and every name in it
finds its file."""

import json
import math
import re

import pytest

from portbench import run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = [x["name"] for x in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]] + \
            [k for c in BENCH["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.match(entry["why"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_run_seconds_fit_the_check_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_set_up_a_rate_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_layer_metric_moves_a_metric_of_every_cell_it_lists(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert _applies(moved, cell), (metric, cell)
    # one layer name per layer, and the reader exists
    assert (run.ROOT / "portbench" / "metrics" / f"{metric}.py").exists()


def test_every_name_finds_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        data = json.loads((run.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for w in BENCH["workloads"]:
        wl, config, traffic = run.cell_files(BENCH, w["name"])
        assert (run.ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads((run.ROOT / "portbench" / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"] and all(math.isfinite(v) and v >= 0 for v in limits["limits"].values())


def test_no_width_is_reduced():
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            assert not re.search(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expansion|experts_per)",
                                 key)
