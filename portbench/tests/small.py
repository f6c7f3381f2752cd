"""A cell cut to a size the CPU tests can hold: the same scene, mix and
solver at a coarser grid (16^3; the multigrid on 2 levels)."""

import time

import torch

from portbench import cells, harness


def small_cell(workload: str, res: int = 16, dtype: str = "float64") -> dict:
    r = cells.resolve(workload)
    r["config"]["scene"]["res"] = res
    r["config"]["dtype"] = dtype
    if "solver.multigrid.levels" in r["config"]["overrides"]:
        r["config"]["overrides"]["solver.multigrid.levels"] = 2
    return r


def run_small(workload: str, seed: int = 11, trace: bool = False, **kw) -> dict:
    return harness.run_cell(small_cell(workload, **kw), seed, 0.5, trace,
                            torch.device("cpu"), time.perf_counter())
