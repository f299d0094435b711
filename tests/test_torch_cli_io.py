"""The port's CLI files and flags against the JAX package's CLI, on the
CPU at 16^3: both CLIs run one Lua file with every newly served output
(write_whitenoisek, write_lineark, write_linearr, write_nonlineark,
write_runpb_snapshot) and the written files are compared block by
block; runs that read those files (read_lineark, read_whitenoisek,
read_runpbic, read_lineark_ncdm) read what the JAX package wrote; the
flags -T, -f, -m and --profile; MemoryBoundExceeded; main_lua and -H.

Tolerances: the white noise is exact (host native code in both); the
linear fields within rtol 1e-5 and 1e-6 of their largest value (the
real one passes an FFT of each package); the nonlinear density and the
snapshots and RunPB rows by id within the CLI test's bounds (1e-4 of a
cell, 1e-4 of the velocity rms) or rtol 1e-5 / 1e-6 of the largest
mode."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from fastpm_tpu.io.bigfile import BigFile

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NC, BOX = 16, 48.0
A_OUT = ("0.1000", "1.0000")

LUA = """
nc = %(nc)d
boxsize = %(box)r
time_step = linspace(0.1, 1, 3)
output_redshifts = {9.0, 0.0}
Omega_m = 0.307494
h       = 0.6774
read_powerspectrum = "%(ps)s"
random_seed = 100
force_mode = "fastpm"
growth_mode = "LCDM"
pm_nc_factor = 2
np_alloc_factor = 4.0
fof_nmin = 8
write_snapshot = "%(out)s/fastpm"
"""
WRITES = """
write_fof = "%(out)s/fastpm"
write_whitenoisek = "%(out)s/wn"
write_lineark = "%(out)s/lk"
write_linearr = "%(out)s/lr"
write_nonlineark = "%(out)s/nlk"
write_runpb_snapshot = "%(out)s/runpb"
"""


def _lua(tmp, name, extra=""):
    out = str(tmp / name)
    conf = tmp / (name + ".lua")
    conf.write_text((LUA + extra) % dict(
        nc=NC, box=BOX, out=out, ps=os.path.join(FIXTURES, "powerspec.txt")))
    return str(conf), out


def _run_jax(conf):
    from fastpm_tpu.cli import run_fastpm
    from fastpm_tpu.config.params import load_params
    from fastpm_tpu.diagnostics import Log
    run_fastpm(load_params(conf), Log(echo=False), memory_bound_mb=100000)


def _run_torch(conf, flags=()):
    from fastpm_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(flags) + [conf], device="cpu") == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on one Lua file with every written output; the port's
    through cli.main with -T 1 -f -m 100000 --profile."""
    tmp = tmp_path_factory.mktemp("cli_io")
    jconf, jout = _lua(tmp, "jax", WRITES)
    _run_jax(jconf)
    tconf, tout = _lua(tmp, "torch", WRITES)
    prof = str(tmp / "profile")
    text = _run_torch(tconf, ["-T", "1", "-f", "-m", "100000",
                              "--profile", prof])
    return dict(tmp=tmp, jax=jout, torch=tout, text=text, profile=prof)


def _by_id(path, dataset="1"):
    bf = BigFile(path)
    ids = bf.open_block(dataset + "/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    return (ids[o], bf.open_block(dataset + "/Position").read_all()[o],
            bf.open_block(dataset + "/Velocity").read_all()[o])


def _assert_rows_agree(got, want, box=BOX, nc=NC):
    np.testing.assert_array_equal(got[0], want[0])
    dx = got[1] - want[1]
    dx -= np.round(dx / box) * box
    assert np.abs(dx).max() < 1e-4 * box / nc
    assert np.abs(got[2] - want[2]).max() < 1e-4 * want[2].std()


def _assert_blocks_agree(jpath, tpath, block, exact=False):
    jb, tb = BigFile(jpath).open_block(block), BigFile(tpath).open_block(block)
    want, got = jb.read_all(), tb.read_all()
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    ja, ta = jb.attrs.asdict(), tb.attrs.asdict()
    assert sorted(ta) == sorted(ja)
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]),
                                      np.asarray(ja[key]))


@pytest.mark.parametrize("name,block,exact", [
    ("wn", "WhiteNoiseK", True),
    ("lk", "LinearDensityK", False),
    ("lr", "LinearDensityR", False),
    ("nlk_0.1000", "DensityK", False),
    ("nlk_1.0000", "DensityK", False)])
def test_field_files_agree(runs, name, block, exact):
    _assert_blocks_agree(os.path.join(runs["jax"], name),
                         os.path.join(runs["torch"], name), block, exact)


@pytest.mark.parametrize("a", A_OUT)
def test_runpb_snapshots_agree(runs, a):
    from fastpm_tpu.io.legacy import read_runpb_snapshot
    files = [read_runpb_snapshot(os.path.join(out, "runpb_%s.bin" % a))
             for out in (runs["jax"], runs["torch"])]
    for f in files:
        assert f["aa"] == pytest.approx(float(a))
    rows = []
    for f in files:
        o = np.argsort(f["id"])
        rows.append((f["id"][o], f["x"][o], f["v"][o]))
    # box units: positions in [0, 1)
    _assert_rows_agree(rows[1], rows[0], box=1.0)


@pytest.mark.parametrize("a", A_OUT)
def test_snapshots_and_catalogs_agree(runs, a):
    want = _by_id(os.path.join(runs["jax"], "fastpm_" + a))
    got = _by_id(os.path.join(runs["torch"], "fastpm_" + a))
    _assert_rows_agree(got, want)
    lengths = [BigFile(os.path.join(out, "fastpm_" + a)).open_block(
        "LL-0.200/Length").read_all() for out in (runs["jax"],
                                                 runs["torch"])]
    np.testing.assert_array_equal(lengths[1], lengths[0])


def test_flags_memory_lines_clocks_and_trace(runs):
    """-T, -f, -m and --profile are accepted; the memory line is logged
    at the transitions and at the teardown with the clocks' table, each
    phase of the force indented under it (--profile turns the spans on);
    the trace is Chrome JSON of the run and holds the program's spans."""
    lines = runs["text"].splitlines()
    mem = [l for l in lines if l.startswith("Peak memory usage: device ")]
    assert len(mem) >= 2 and all(" host rss " in l for l in mem)
    head = lines.index(next(l for l in lines if l.startswith("Clock ")))
    end = lines.index(next(l for l in lines[head:]
                           if l.startswith("Total ")))
    rows = lines[head + 1:end]
    names = [l.split()[0] for l in rows]
    assert [n for n in names if "." not in n] == [
        "drift", "force", "init", "kick", "lpt"]
    phases = names[names.index("force") + 1:names.index("init")]
    assert "force.kspace" in phases and all(
        n.startswith("force.") for n in phases)
    assert all(l.startswith("  force.") for l in rows if "." in l.split()[0])
    counts = {l.split()[0]: int(l.split()[2]) for l in rows}
    assert {n: counts[n] for n in ("drift", "force", "kick")} == {
        "drift": 4, "force": 3, "kick": 4}
    with open(os.path.join(runs["profile"], "trace.json")) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
    spans = {e.get("name") for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"fastpm.force", "fastpm.force.kspace"} <= spans


def test_read_lineark_equals_the_writing_run(runs):
    """A run from the port's own LinearDensityK file writes the snapshot
    of the run that wrote it, bit for bit; one from the JAX package's
    file agrees with the JAX run by id."""
    tmp = runs["tmp"]
    for writer in ("torch", "jax"):
        conf, out = _lua(tmp, "lk_" + writer,
                         'read_lineark = "%s"\n'
                         % os.path.join(runs[writer], "lk"))
        _run_torch(conf)
        got = _by_id(os.path.join(out, "fastpm_1.0000"))
        want = _by_id(os.path.join(runs[writer], "fastpm_1.0000"))
        if writer == "torch":
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            _assert_rows_agree(got, want)


def test_read_whitenoisek_agrees(runs):
    conf, out = _lua(runs["tmp"], "wn_read", 'read_whitenoisek = "%s"\n'
                     % os.path.join(runs["jax"], "wn"))
    _run_torch(conf)
    _assert_rows_agree(_by_id(os.path.join(out, "fastpm_1.0000")),
                       _by_id(os.path.join(runs["jax"], "fastpm_1.0000")))


def test_read_runpbic_agrees(runs):
    """Both CLIs start from the JAX run's RunPB snapshot at a = 0.1 and
    agree by id at z = 0."""
    extra = 'read_runpbic = "%s"\n' % os.path.join(runs["jax"],
                                                   "runpb_0.1000.bin")
    jconf, jout = _lua(runs["tmp"], "runpbic_jax", extra)
    _run_jax(jconf)
    tconf, tout = _lua(runs["tmp"], "runpbic_torch", extra)
    text = _run_torch(tconf)
    assert "RunPB IC at a = 0.1 from " in text
    _assert_rows_agree(_by_id(os.path.join(tout, "fastpm_1.0000")),
                       _by_id(os.path.join(jout, "fastpm_1.0000")))


def test_constrained_run_writes_the_unconstrained_field(runs):
    conf, out = _lua(runs["tmp"], "constrained",
                     'write_lineark = "%(out)s/lk"\n'
                     "constraints = {{24.0, 24.0, 24.0, 3.0}}\n")
    text = _run_torch(conf)
    assert "Writing fourier space linear field before constraints" in text
    got = BigFile(os.path.join(out, "lk")).open_block(
        "UnconstrainedLinearDensityK").read_all()
    want = BigFile(os.path.join(runs["torch"], "lk")).open_block(
        "LinearDensityK").read_all()
    np.testing.assert_array_equal(got, want)


NCDM = """
m_ncdm = {0.06}
n_shell = 2
n_side = 1
every_ncdm = 4
ncdm_freestreaming = false
read_lineark_ncdm = "%(lk)s"
"""


def test_read_lineark_ncdm_works(runs):
    """ncdm particles from the JAX run's LinearDensityK file through
    both CLIs agree by id (dataset 2); the port's log names the file."""
    extra = NCDM % dict(lk=os.path.join(runs["jax"], "lk"))
    jconf, jout = _lua(runs["tmp"], "ncdm_jax", extra)
    _run_jax(jconf)
    tconf, tout = _lua(runs["tmp"], "ncdm_torch", extra)
    text = _run_torch(tconf)
    assert ("Reading Fourier space linear overdensity from %s"
            % os.path.join(runs["jax"], "lk")) in text
    for dataset in ("1", "2"):
        got = _by_id(os.path.join(tout, "fastpm_1.0000"), dataset)
        want = _by_id(os.path.join(jout, "fastpm_1.0000"), dataset)
        assert len(got[0]) > 0
        _assert_rows_agree(got, want)


def test_tiny_memory_bound_stops_the_run(runs):
    from fastpm_torch import cli
    from fastpm_torch.memory import MemoryBoundExceeded
    conf, out = _lua(runs["tmp"], "bounded")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(MemoryBoundExceeded, match="exceeds the bound"):
            cli.main(["-m", "1", conf], device="cpu")
    assert not os.path.exists(os.path.join(out, "fastpm_1.0000"))


@pytest.mark.parametrize("args", [["-H"], ["CONF"], ["CONF", "x"]])
def test_main_lua_prints_the_jax_text(runs, args, capsys):
    from fastpm_tpu.cli import main_lua as jmain_lua
    from fastpm_torch.cli import main_lua
    from fastpm_torch import tools
    conf, _out = _lua(runs["tmp"], "lua")
    argv = [conf if a == "CONF" else a for a in args]
    assert jmain_lua(argv) == 0
    want = capsys.readouterr().out
    assert main_lua(argv) == 0
    assert capsys.readouterr().out == want
    assert tools.main(["lua"] + argv) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("Supported Parameters are: " if args == ["-H"]
                           else "Compiled parameters are: ")
    assert main_lua([str(runs["tmp"] / "missing.lua")]) == 1
