"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name alone."""

import json
import re
import shutil

import pytest

from nbody_bench import manifest
from nbody_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nbody_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = set(metric) - {"workloads"}
    if metric in BENCH["end_to_end"]:
        assert keys == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert keys == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_found_by_name(cell):
    c = manifest.Cell(cell, BENCH)
    assert c.config["name"] == c.entry["config"]
    assert callable(c.loop.call) and callable(c.loop.steps)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))
    assert set(c.workload["limits"]) >= {"dv_p99", "dx_max_px",
                                         "merge_left", "killed_far",
                                         "mass_gap"}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_under_paths(config):
    assert config["file"] == f"nbody_bench/configs/{config['name']}.json"
    data = manifest.load_json(manifest.ROOT / config["file"])
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]


def test_new_cell_is_picked_up_without_an_edit(tmp_path):
    pkg, bench = tiny.make(tmp_path)
    shutil.copy(pkg / "traffic" / "batch20_seg400.json",
                pkg / "traffic" / "batch5_seg100.json")
    shutil.copy(pkg / "workloads" / "p3m_collide1m_batch.json",
                pkg / "workloads" / "p3m_collide1m_batch5.json")
    (pkg / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window.calls / ctx.window.seconds\n")
    bench["workloads"].append({"name": "p3m_collide1m_batch5",
                               "config": "collide1m_p3m",
                               "traffic": "batch5_seg100", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["p3m_collide1m_batch5"]})
    bench["per_layer"].append({"name": "device_idle_pct.batch5", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "calls_per_s",
                               "workloads": ["p3m_collide1m_batch5"]})
    c = manifest.Cell("p3m_collide1m_batch5", bench, pkg)
    assert c.traffic["loop"] == "batch"
    assert sorted(m["name"] for m in c.end_to_end) == ["calls_per_s", "setup_s"]
    assert c.reader("calls_per_s") is not None
    # a suffixed name with no file of its own is read by its stem's file
    assert [m["name"] for m in c.per_layer] == ["device_idle_pct.batch5"]
    assert c.reader("device_idle_pct.batch5").__module__.endswith(
        "device_idle_pct")
