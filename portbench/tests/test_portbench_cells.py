"""BENCHMARK.json and the files it names: every part loads by name, every
cell resolves, a cell added as new files only is taken up, and the file
keeps to its required shape."""

import hashlib
import json
import re
import shutil

import pytest

from portbench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    r = cells.resolve(cell)
    assert r["config"]["name"] == r["cell"]["config"]
    assert {m["name"] for m in r["end_to_end"]} >= {"sim_rate", "peak_mem_gb", "setup_s"}
    assert r["per_layer"]
    for m in r["per_layer"]:
        assert callable(cells.load_reader(m["name"]))


def test_every_file_loads_by_name():
    for c in BENCH["configs"]:
        assert cells.load_config(c["name"])["name"] == c["name"]
        assert (cells.ROOT / c["file"]).is_file()
    for mix in {w["traffic"] for w in BENCH["workloads"]}:
        assert cells.load_traffic(mix)["segment_steps"] > 0
    for m in BENCH["per_layer"]:
        assert callable(cells.load_reader(m["name"]))


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert cells.metrics_of(BENCH, w["name"], "per_layer")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == cells.load_config(c["name"])["reduced"]
        assert len(cells.load_config(c["name"])["source"]) <= 200


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_is_taken_up(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(cells.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(here)

    config = cells.load_config("bar128-bj")
    config["name"] = "bar64-bj"
    config["scene"]["res"] = 64
    (here / "configs" / "bar64-bj.json").write_text(json.dumps(config))
    mix = cells.load_traffic("twist")
    mix["members"] = [{"E": 5e5}, {"E": 1e6}]
    (here / "traffic" / "sweep2.json").write_text(json.dumps(mix))
    (here / "metrics" / "steps_read.py").write_text(
        "def read(trace):\n    return float(len(trace.steps))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bar64-bj", "source": "https://arxiv.org/abs/1911.07913",
                             "file": "portbench/configs/bar64-bj.json", "reduced": [],
                             "why": "a smaller bar"})
    bench["workloads"].append({"name": "bar64-bj.sweep2", "config": "bar64-bj",
                               "traffic": "sweep2", "chips": 1, "why": "two members"})
    bench["per_layer"].append({"name": "steps_read", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Newton/CG control",
                               "moves": "sim_rate", "workloads": ["bar64-bj.sweep2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    r = cells.resolve("bar64-bj.sweep2", root=tmp_path, here=here)
    assert r["config"]["scene"]["res"] == 64
    assert len(r["traffic"]["members"]) == 2
    assert [m["name"] for m in r["per_layer"]] == ["steps_read"]
    assert cells.load_reader("steps_read", here)(type("T", (), {"steps": [1, 2]})) == 2.0
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before
    assert cells.resolve("bar128-bj.twist", root=tmp_path, here=here)["config"] == \
        cells.load_config("bar128-bj")


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        cells.resolve("no-such.cell")
    with pytest.raises(ValueError):
        cells.load_config("../BENCHMARK")
