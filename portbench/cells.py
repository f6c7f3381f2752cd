"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix, and its metrics. Each part is a file of its
own under ``portbench/``, found by its name:

* ``configs/<config>.json``: the configuration (scene recipe, SimConfig
  overrides as dotted paths, dtype, the comparison's limits);
* ``traffic/<mix>.json``: the traffic mix (loading steps, dt, the replayed
  segment, the members of a batch);
* ``metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(trace) -> float | None``.

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "configs" / f"{_named(name)}.json").read_text())


def load_traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{_named(name)}.json").read_text())


def load_reader(name: str, here: Path = HERE):
    """The `read` function of metrics/<name>.py."""
    path = here / "metrics" / f"{_named(name)}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `workload`
    reports: those that list it, and those with no list whose end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ()) or ("workloads" not in m
                                                      and m["moves"] in moved)]


def resolve(workload: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """The cell `workload` of BENCHMARK.json with its configuration, its
    mix and its metrics."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    return {"cell": cell, "config": load_config(cell["config"], here),
            "traffic": load_traffic(cell["traffic"], here),
            "end_to_end": metrics_of(bench, workload, "end_to_end"),
            "per_layer": metrics_of(bench, workload, "per_layer")}
