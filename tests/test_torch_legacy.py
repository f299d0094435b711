"""The port's legacy formats (fastpm_torch/io/legacy.py) and its RunPB
initial condition (cli.prepare_runpbic) against the JAX package's: the
RunPB files of both writers are byte-equal and each reader reads the
other's, the GRAFIC readers agree, and a RunPB IC set up by both
Solvers at 16^3 agrees by id."""

import os
import struct

import numpy as np
import pytest
import torch

from fastpm_tpu.io import legacy as jlegacy
from fastpm_torch.io import legacy as tlegacy

POWERSPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures", "powerspec.txt")


def _runpb_inputs(n=1000, box=100.0, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, box, (n, 3)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32),
            rng.permutation(n).astype(np.int64))


@pytest.mark.parametrize("nfile", [1, 3])
def test_runpb_files_byte_equal(tmp_path, nfile):
    x, v, ids = _runpb_inputs()
    for name, mod in (("jax", jlegacy), ("torch", tlegacy)):
        mod.write_runpb_snapshot(str(tmp_path / name), x, v, ids, aa=0.5,
                                 E=1.8, boxsize=100.0, Nfile=nfile)
    for i in range(nfile):
        with open(str(tmp_path / ("jax.%02d" % i)), "rb") as a, \
                open(str(tmp_path / ("torch.%02d" % i)), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", [(jlegacy, tlegacy),
                                           (tlegacy, jlegacy)])
def test_runpb_read_by_the_other_package(tmp_path, writer, reader):
    x, v, ids = _runpb_inputs(seed=1)
    path = str(tmp_path / "tpm")
    writer.write_runpb_snapshot(path, x, v, ids, aa=0.25, E=3.1,
                                boxsize=100.0, Nfile=2)
    got, want = reader.read_runpb_snapshot(path), jlegacy.read_runpb_snapshot(
        path)
    assert got["aa"] == want["aa"] == pytest.approx(0.25)
    for key in ("x", "v", "id"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["id"], ids)


def test_grafic_reader_matches(tmp_path):
    n0, n1, n2 = 4, 6, 8
    data = np.random.RandomState(2).standard_normal((n0, n1, n2)).astype(
        "<f4")
    fn = str(tmp_path / "noise")
    with open(fn, "wb") as fp:
        fp.write(struct.pack("<i", 16))
        fp.write(struct.pack("<iii", n2, n1, n0))  # file dims reversed
        fp.write(struct.pack("<i", 42))
        fp.write(struct.pack("<i", 16))
        for plane in data:
            rec = plane.tobytes()
            fp.write(struct.pack("<i", len(rec)))
            fp.write(rec)
            fp.write(struct.pack("<i", len(rec)))
    got = tlegacy.read_grafic_gaussian((n0, n1, n2), fn)
    np.testing.assert_array_equal(got, jlegacy.read_grafic_gaussian(
        (n0, n1, n2), fn))
    np.testing.assert_array_equal(got, data)
    with pytest.raises(ValueError):
        tlegacy.read_grafic_gaussian((8, 6, 4), fn)


def test_prepare_runpbic_matches_jax(tmp_path):
    """A RunPB IC made from the JAX Solver's 2LPT field at a = 0.1
    (tests/test_legacy_io.py's construction), set up by both packages'
    prepare_runpbic in cola (which keeps dx1 and dx2): ids, dx1, dx2,
    x and v agree by id."""
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_tpu.solver import Solver as JSolver
    from fastpm_tpu.solver import SolverConfig as JConfig
    from fastpm_tpu import ic as jic
    from fastpm_tpu.cli import prepare_runpbic as jprepare
    from fastpm_tpu.diagnostics import Log as JLog
    from fastpm_torch.cli import prepare_runpbic
    from fastpm_torch.cosmology import Cosmology
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.solver import Solver, SolverConfig

    nc, box, aa = 16, 64.0, 0.1
    cosmo = dict(h=0.6774, Omega_m=0.307494, growth_mode="lcdm")
    kw = dict(nc=nc, boxsize=box, time_step=[aa, 1.0], force_mode="cola",
              pm_nc_factor=1, use_shift=True)
    c = JCosmology(**cosmo)
    s = JSolver(JConfig(**kw), c)
    dk, _ = jic.linear_field(s.lptpm, c, JFuncK.from_file(POWERSPEC),
                             seed=13, aout=1.0)
    s.setup_lpt(dk, aa)
    p = s.species["cdm"]
    dx1, dx2 = np.asarray(p.dx1), np.asarray(p.dx2)
    D = c.growth_info(aa).D1
    omega = c.Omega_cdm_a(aa)
    f1, f2 = omega ** (4 / 7), omega ** (6 / 11)
    ids = np.asarray(p.id).astype(np.int64)
    lattice = np.stack([(ids // st) % nc for st in (nc * nc, nc, 1)],
                       axis=-1)
    xbox = lattice / nc + 0.5 / nc + (D * dx1 + D * D * dx2) / box
    vrsd = (f1 * D * dx1 + 2 * f2 * D * D * dx2) / box
    # the file's rows in another order than the lattice's
    order = np.random.RandomState(3).permutation(len(ids))
    hdr = struct.Struct("<iiiff")
    path = str(tmp_path / "ic")
    with open(path + ".00", "wb") as f:
        f.write(struct.pack("<ii", 1, hdr.size))
        f.write(hdr.pack(len(ids), 0, 0, aa, 0.0))
        np.remainder(xbox[order], 1.0).astype("<f4").tofile(f)
        vrsd[order].astype("<f4").tofile(f)
        ids[order].astype("<i8").tofile(f)

    js = JSolver(JConfig(**kw), c)
    jprepare(js, path, aa, JLog(echo=False))
    ts = Solver(SolverConfig(**kw), Cosmology(**cosmo), device="cpu")
    log = Log(echo=False)
    prepare_runpbic(ts, path, aa, log)
    assert log.contains("RunPB IC at a = 0.1 from %s" % path)
    jp, tp = js.species["cdm"], ts.species["cdm"]
    jo = np.argsort(np.asarray(jp.id))
    to = np.argsort(tp.id.numpy())
    np.testing.assert_array_equal(tp.id.numpy()[to],
                                  np.asarray(jp.id)[jo])
    for col in ("dx1", "dx2", "x", "v"):
        want = np.asarray(getattr(jp, col))[jo]
        got = getattr(tp, col).numpy()[to]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert tp.a_x == pytest.approx(aa) and tp.q_nc == (nc, nc, nc)
    assert tp.x.dtype == torch.float32
