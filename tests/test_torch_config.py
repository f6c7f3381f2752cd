"""hot_tpu_torch's config tree matches hot_tpu's, and the package imports
neither jax nor hot_tpu."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from hot_tpu.utils import config as jcfg
from hot_tpu_torch.utils import config as tcfg

PKG = Path(__file__).resolve().parents[1] / "hot_tpu_torch"
# knobs that only chose an XLA:TPU code path or a Pallas kernel
TPU_ONLY = {"pallas_apply", "pallas_linearize", "slot_major", "transfer_impl",
            "bin_cells_capacity", "bin_cap"}


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


@pytest.mark.parametrize("name", ["SimConfig", "SolverConfig", "MultigridConfig", "MeshConfig"])
def test_shared_fields_have_hot_tpu_defaults(name):
    jdef, tdef = _defaults(getattr(jcfg, name)), _defaults(getattr(tcfg, name))
    assert set(jdef) - set(tdef) == set(jdef) & TPU_ONLY
    assert not set(tdef) - set(jdef)
    for field, value in tdef.items():
        want = jdef[field]
        if dataclasses.is_dataclass(value):
            assert dataclasses.asdict(value) == {
                k: v for k, v in dataclasses.asdict(want).items() if k not in TPU_ONLY}
        else:
            assert value == want, field


def test_overrides_apply_dotted_paths():
    base = tcfg.SimConfig()
    cfg = tcfg.config_from_overrides(base, {"solver.cn_eps": 1e-4, "dx": 0.5,
                                            "solver.multigrid.levels": 4})
    assert (cfg.solver.cn_eps, cfg.dx, cfg.solver.multigrid.levels) == (1e-4, 0.5, 4)
    assert base.solver.cn_eps == 1e-2
    assert '"cn_eps": 0.0001' in cfg.to_json()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_hot_tpu_imports_in_source():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "hot_tpu")]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, hot_tpu_torch, hot_tpu_torch.sim, hot_tpu_torch.scenes, "
            "hot_tpu_torch.cli, hot_tpu_torch.ops.fused_apply, hot_tpu_torch.ops.fused_linearize; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hot_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=120)
