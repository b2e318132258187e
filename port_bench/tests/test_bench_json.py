"""``BENCHMARK.json`` keeps the benchmark contract's shape: allowed keys and
characters, every file it names present, every cell complete."""

import json
import os
import re

import pytest

from port_bench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check with 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s per cell, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_configs_and_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        assert os.path.isfile(os.path.join(ROOT, conf["forest_file"]))
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_cells_have_their_files():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        spec = harness.load_spec(w["name"])
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "drivers",
                                           spec.traffic["driver"] + ".py"))
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {}
    for m in BENCH["per_layer"]:  # one layer name per layer
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        spec = harness.load_spec(w["name"])
        reports = {m["name"] for m in harness.reported(spec, False)}
        assert "setup_s" in reports and len(reports) >= 2, w["name"]
        per_layer = harness.reported(spec, True)
        assert per_layer and all(m["moves"] in reports for m in per_layer), w["name"]
