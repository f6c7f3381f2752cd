"""The explicit integrator, the L-BFGS baseline and the Neo-Hookean and
linear-corotated models in hot_tpu_torch's step, against hot_tpu on the same
fp64 states (CPU: the plain kernel versions). Mirrors
tests/test_baselines.py and the model cases of tests/test_models.py.

  * explicit (symplectic Euler at F_n): 5 steps of block_drop_2d at 32^2 from
    a stressed state at dt 5e-4: no iterations, x, v, F and C within 1e-12;
  * L-BFGS (solver.nonlinear="lbfgs"): one step of the 16^3 twisting bar from
    a stressed state: hot_tpu's iteration count and grid velocity (through
    positions and particle velocities) within 1e-9; a second step from the
    first step's state continues to agree;
  * the two models on block_drop_2d at 32^2, 3 steps from a stressed state
    under block-Jacobi: hot_tpu's (newton, cg) per step, positions within
    1e-9 (the 3D linearize of both is held to hot_tpu in
    test_torch_cubic.py, and on the card by chip_smoke.py);
  * the CLI's --model and the new options' --set paths on the CPU.
"""

import json

import numpy as np
import pytest

from hot_tpu.models import constitutive as jcm
from hot_tpu_torch import cli
from hot_tpu_torch.models import constitutive as tcm

from test_torch_cubic import run_pair, stressed_pair
from test_torch_ref import one_torch_thread, t2n  # noqa: F401


def test_explicit_steps_match_hot_tpu():
    jsim, tsim = stressed_pair("block_drop_2d", {"solver.integrator": "explicit"}, res=32,
                               E=1e4)
    for _ in range(5):
        js, ts = jsim.step(5e-4), tsim.step(5e-4)
        assert (ts.newton_iters, ts.cg_iters, ts.converged) == (0, 0, True)
        assert int(js.newton_iters) == 0
        for field in ("x", "v", "Ff", "Cf"):
            np.testing.assert_allclose(t2n(getattr(tsim.state, field)),
                                       np.asarray(getattr(jsim.state, field)), rtol=0,
                                       atol=1e-12 * max(1.0, float(np.abs(
                                           np.asarray(getattr(jsim.state, field))).max())))
    # the particles deformed, so steps 2-5 applied elastic forces
    d = tsim.state.dim
    assert float(np.abs(t2n(tsim.state.Ff) - np.eye(d).reshape(-1)).max()) > 1e-3
    assert tsim.retry_count == 0


def test_lbfgs_step_matches_hot_tpu():
    jsim, tsim = stressed_pair("twisting_bar_3d", {"solver.nonlinear": "lbfgs"}, res=16, ppc=2)
    for _ in range(2):
        js, ts = jsim.step(2e-3), tsim.step(2e-3)
        assert ts.newton_iters == ts.cg_iters == int(js.newton_iters) == int(js.cg_iters) > 0
        assert ts.converged and bool(js.converged)
        np.testing.assert_allclose(ts.cn_residual, float(js.cn_residual), rtol=1e-6)
        for field in ("x", "v"):
            np.testing.assert_allclose(t2n(getattr(tsim.state, field)),
                                       np.asarray(getattr(jsim.state, field)), rtol=0,
                                       atol=1e-9)


@pytest.mark.parametrize("model_name", ["neo_hookean", "linear_corotated"])
def test_new_models_three_steps_match_hot_tpu(model_name):
    jsim, tsim = stressed_pair("block_drop_2d", {}, jcm.MODEL_REGISTRY[model_name],
                               tcm.MODEL_REGISTRY[model_name], res=32)
    counts = run_pair(jsim, tsim, 3, 2e-3, 1e-9)
    assert min(c[0] for c in counts) > 0, counts


@pytest.mark.parametrize("args", [
    ["--model", "linear_corotated", "--set", "transfer_kernel=cubic"],
    ["--model", "neo_hookean", "--set", "solver.nonlinear=lbfgs"],
    ["--set", "solver.integrator=explicit"]], ids=["cubic_linear", "lbfgs_neo", "explicit"])
def test_cli_runs_the_new_options(tmp_path, args):
    """The model, transfer kernel, integrator and nonlinear solver from the
    command line, on the CPU; the config records the overrides."""
    out = tmp_path / "run"
    assert cli.main(["--scene", "block_drop_2d", "--device", "cpu", "--max-steps", "2",
                     "--scene-arg", "res=16", "--frames", "1", "-o", str(out), "--quiet",
                     *args]) == 0
    cfg = json.loads((out / "config.json").read_text())
    for key, _, value in (args[i + 1].partition("=") for i, a in enumerate(args) if a == "--set"):
        node = cfg
        for part in key.split(".")[:-1]:
            node = node[part]
        assert node[key.split(".")[-1]] == value
    steps = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    # --max-steps 2 stops after the whole first frame
    numbers = [r["step"] for r in steps if "step" in r]
    assert numbers == list(range(1, len(numbers) + 1)) and len(numbers) >= 2
    assert abs([r for r in steps if "step" in r][-1]["t"] - 1.0 / 24.0) <= 1e-7
    assert all(r["converged"] for r in steps if "step" in r)
