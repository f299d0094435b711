"""The port imports neither jax nor the JAX package, and its entry points
never fall back to the CPU on their own."""

import contextlib
import io
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
                 "parallel.psolver", "parallel.pfof", "pgd", "neutrinos_lra",
                 "png", "constrained", "lightcone", "io.snapshots",
                 "io.fields", "io.legacy", "io.angular", "memory", "prof",
                 "dump", "tools", "measure_halo"):
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
    from fastpm_torch import measure_halo
    for entry in (lambda: benchlib.make_step_fn(PM(8, 16.0)),
                  lambda: benchlib.make_stale_step_fns(PM(8, 16.0)),
                  lambda: benchlib.example_particles(4, 16.0),
                  lambda: measure_halo.main(["8"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_unserved_parameter_stops_the_cli(tmp_path):
    from fastpm_torch.cli import main, check_served
    from fastpm_torch.config.params import load_params
    base = ("nc = 8\nboxsize = 16.0\ntime_step = {0.1, 1.0}\n"
            "pm_nc_factor = 1\nnp_alloc_factor = 1.0\n"
            "h = 0.7\nOmega_m = 0.3\n")
    conf = tmp_path / "p.lua"
    # read_grafic and write_runpbic, which the JAX package's CLI never
    # reads, stay refused
    for line in ('read_grafic = "noise"', 'write_runpbic = "ic"'):
        conf.write_text(base + line + "\n")
        with pytest.raises(SystemExit, match=line.split()[0]):
            main([str(conf)], device="cpu")
    # the lightcone, RFOF, PGD, the linear response, the potential, the
    # tidal tensor and a RunPB initial condition are served, on ranks
    # too (tests/test_torch_ranks_physics.py runs the first four on 2
    # and 4 ranks): no parameter depends on the number of ranks
    import fastpm_torch.cli as cli_module
    assert not hasattr(cli_module, "_ONE_RANK_PARAMS")
    for line in ('lc_write_usmesh = "lc"', 'write_rfof = "rfof"',
                 "pgdc = true", "ncdm_linearresponse = true",
                 "compute_potential = true", "compute_tidal = true",
                 'read_runpbic = "ic"'):
        one = tmp_path / "one.lua"
        one.write_text(base + line + "\n")
        check_served(load_params(str(one)))
    # restart is served on one rank; subsampled runs cannot restart
    sub = tmp_path / "sub.lua"
    sub.write_text(base + "particle_fraction = 0.5\n")
    with pytest.raises(SystemExit, match="restart"):
        main(["-r", str(tmp_path / "snapshot"), str(sub)], device="cpu")
    # -y 2 is served: on one rank it runs the one device, as the JAX
    # package's make_device_mesh does
    ps = os.path.join(os.path.dirname(__file__), "fixtures",
                      "powerspec.txt")
    conf.write_text(base + 'read_powerspectrum = "%s"\n' % ps
                    + "random_seed = 1\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["-y", "2", str(conf)], device="cpu") == 0
