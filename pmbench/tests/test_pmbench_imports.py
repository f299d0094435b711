"""What the benchmark's command loads, and that it refuses to run
without a card or without the program."""

import os
import shutil
import subprocess
import sys

import pytest

from pmbench import harness

ROOT = harness.ROOT
FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'fastpm_tpu'}"


def _loaded(code):
    """The top-level names, compared whole, that `code` leaves loaded in
    a fresh interpreter."""
    probe = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_command_modules_load_no_jax():
    names = _loaded(
        "import glob, os, runpy\n"
        "from pmbench import harness, calibrate, compare, roofline, trace\n"
        "for kind in ('metrics', 'entries'):\n"
        "    for p in glob.glob(os.path.join('pmbench', kind, '*.py')):\n"
        "        harness._module(kind, os.path.basename(p)[:-3])\n"
        "runpy.run_path('pmbench/run.py', run_name='not_main')\n")
    assert not names & eval(FORBIDDEN)
    assert "fastpm_torch" in names


def test_reference_loads_neither_package():
    names = _loaded("import pmbench.reference.fastpm, "
                    "pmbench.reference.cosmology, pmbench.reference.ncdm")
    assert not names & (eval(FORBIDDEN) | {"fastpm_torch"})


def _command(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "pmbench/run.py", "--workload",
         "standard512.evolve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd, env=env,
        timeout=300)


def test_command_fails_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "pmbench"), tmp_path / "pmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_forbidden_modules_are_named():
    """On the card: a run that finds jax loaded prints no result."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.modules.setdefault("jax", type(sys)("jax"))
    try:
        assert harness.forbidden_modules() == ["jax"]
    finally:
        del sys.modules["jax"]
