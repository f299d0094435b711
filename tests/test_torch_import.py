"""The port imports neither jax nor the JAX package, and its entry points
never fall back to the CPU on their own."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import fastpm_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    fastpm_torch.__path__, "fastpm_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "fastpm_tpu"))
assert not bad, bad
print(" ".join(names))
"""


def test_import_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every module of the package was imported, the ncdm split and the
    # multi-rank force among them
    names = out.stdout.split()
    assert len(names) >= 30
    for name in ("cli", "solver", "gravity", "ncdm", "ops.cic", "ops.sort",
                 "benchlib", "parallel.comm", "parallel.pfft",
                 "parallel.psolver"):
        assert "fastpm_torch." + name in names


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points use it")
    from fastpm_torch.solver import Solver, SolverConfig
    from fastpm_torch.cli import run_fastpm, main
    from fastpm_torch.config.params import load_params

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(SolverConfig(nc=8, boxsize=16.0))
    conf = tmp_path / "p.lua"
    conf.write_text("nc = 8\nboxsize = 16.0\ntime_step = {0.1, 1.0}\n"
                    "pm_nc_factor = 1\nnp_alloc_factor = 1.0\n"
                    "h = 0.7\nOmega_m = 0.3\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fastpm(load_params(str(conf)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(conf)])
    from fastpm_torch import benchlib
    from fastpm_torch.mesh import PM
    for entry in (lambda: benchlib.make_step_fn(PM(8, 16.0)),
                  lambda: benchlib.make_stale_step_fns(PM(8, 16.0)),
                  lambda: benchlib.example_particles(4, 16.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_unserved_parameter_stops_the_cli(tmp_path):
    from fastpm_torch.cli import main
    conf = tmp_path / "p.lua"
    conf.write_text("nc = 8\nboxsize = 16.0\ntime_step = {0.1, 1.0}\n"
                    "pm_nc_factor = 1\nnp_alloc_factor = 1.0\n"
                    "h = 0.7\nOmega_m = 0.3\n"
                    'lc_write_usmesh = "lc"\n')
    with pytest.raises(SystemExit, match="lc_write_usmesh"):
        main([str(conf)], device="cpu")
    with pytest.raises(SystemExit, match="restart"):
        main(["-r", str(tmp_path / "snapshot"), str(conf)], device="cpu")
    with pytest.raises(SystemExit, match="NprocY"):
        main(["-y", "2", str(conf)], device="cpu")
