"""The port's offline tools (python -m fastpm_torch.tools NAME) and the
analysis functions they read, against the JAX package's on the CPU.

Every tool runs on one snapshot that the JAX CLI writes (nbodykit.lua's
physics at 32^3, box 96, with a FOF catalog at z = 0), through both
packages: fof and rfof lengths and MinID exact, power and halobias rows
within rtol 1e-5 (and Nmodes exact), pklin exact, the paint tool's
density within atol 2e-6 and rtol 1e-5 (the repo's paint tolerance) and
its written field, after an FFT of each package, within rtol 1e-5 and
1e-6 of its largest value, comparehalos within rtol 1e-5 and 1e-6 of
the largest power, and the host tools' files (gadget1, cutslice, mpgadget, from-gadget1)
byte for byte. Then measure_power_2d, measure_transfer, the dump files,
the angular grid and the fast and slow white noise against the JAX
package."""

import contextlib
import glob
import io
import os

import numpy as np
import pytest
import torch

from fastpm_tpu import tools as jtools
from fastpm_tpu.io.bigfile import BigFile
from fastpm_torch import tools

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NC, BOX = 32, 96.0

LUA = """
nc = %(nc)d
boxsize = %(box)r
time_step = linspace(0.1, 1, 3)
output_redshifts = {0.0}
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
write_fof = "%(out)s/fastpm"
"""


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """The JAX CLI's z = 0 snapshot with its FOF catalog."""
    from fastpm_tpu.cli import run_fastpm
    from fastpm_tpu.config.params import load_params
    from fastpm_tpu.diagnostics import Log
    tmp = tmp_path_factory.mktemp("tools")
    conf = tmp / "run.lua"
    conf.write_text(LUA % dict(nc=NC, box=BOX, out=str(tmp / "run"),
                               ps=os.path.join(FIXTURES, "powerspec.txt")))
    run_fastpm(load_params(str(conf)), Log(echo=False))
    return tmp, str(tmp / "run" / "fastpm_1.0000")


def _both(name, make_argv, on_device=True):
    """Run tool `name` in both packages (argv from make_argv(package));
    returns nothing, the tools write their files."""
    jentry = getattr(jtools, "main_" + name.replace("-", "_"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert jentry(make_argv("jax")) == 0
        argv = [name] + make_argv("torch")
        assert tools.main(argv, device="cpu" if on_device else None) == 0


def _blocks(path, dataset):
    bf = BigFile(path)
    return {name: bf.open_block("%s/%s" % (dataset, name)).read_all()
            for name in ("Length", "Position", "Velocity", "MinID")}


@pytest.mark.parametrize("name,dataset", [("fof", "LL-0.200"),
                                          ("rfof", "RFOF")])
def test_halo_tools(snap, name, dataset):
    tmp, path = snap
    _both(name, lambda pkg: [path, "-o", str(tmp / (name + "_" + pkg))])
    want, got = (_blocks(str(tmp / (name + "_" + pkg)), dataset)
                 for pkg in ("jax", "torch"))
    assert len(want["Length"]) > 0
    np.testing.assert_array_equal(got["Length"], want["Length"])
    np.testing.assert_array_equal(got["MinID"], want["MinID"])
    np.testing.assert_allclose(got["Position"], want["Position"],
                               atol=1e-4 * BOX / NC)
    if name == "fof":
        # the offline catalog is the run's own write_fof catalog
        run = _blocks(path, dataset)
        np.testing.assert_array_equal(got["Length"], run["Length"])


def test_power(snap):
    tmp, path = snap
    _both("power", lambda pkg: [str(tmp / ("power_%s.txt" % pkg)),
                                "--nmesh", "32", path])
    want, got = (np.loadtxt(str(tmp / ("power_%s.txt" % pkg)))
                 for pkg in ("jax", "torch"))
    assert want.shape == got.shape and len(want) > 8
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-5)


def test_halobias(snap):
    tmp, path = snap
    _both("halobias", lambda pkg: [
        str(tmp / ("bias_%s.txt" % pkg)), path, "--nmesh", "32",
        "--kmax", "0.2", "--nn", "3", "--", path])
    want, got = (np.loadtxt(str(tmp / ("bias_%s.txt" % pkg)), ndmin=2)
                 for pkg in ("jax", "torch"))
    assert want.shape == got.shape and len(want) >= 1
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-5)


def test_comparehalos(snap):
    tmp, path = snap
    _both("comparehalos", lambda pkg: [
        str(tmp / ("cmp_%s.txt" % pkg)), path, "--nmesh", "32",
        "--nn", "3", "--nmax", "60", "--", path])
    want = sorted(glob.glob(str(tmp / "cmp_jax-nmin-*.txt")))
    got = sorted(glob.glob(str(tmp / "cmp_torch-nmin-*.txt")))
    assert len(want) >= 3 and len(got) == len(want)
    for w, g in zip(want, got):
        assert os.path.basename(g).replace("torch", "jax") == \
            os.path.basename(w)
        a, b = np.loadtxt(w), np.loadtxt(g)
        np.testing.assert_array_equal(b[:, 3], a[:, 3])
        np.testing.assert_allclose(b[:, :2], a[:, :2], rtol=1e-5)
        np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-5,
                                   atol=1e-6 * np.abs(a[:, 2]).max())


def test_paint(snap):
    """The tool's density before its FFTs (each package's Painter on the
    snapshot's rows) within the paint tolerance, atol 2e-6 and rtol
    1e-5; the written field, which passes an r2c and a c2r of each
    package (pocketfft against XLA: 7.6e-6 apart on the same input, a
    field of largest value 61), within rtol 1e-5 and 1e-6 of its largest
    value."""
    import jax.numpy as jnp
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.painter import Painter as JPainter
    from fastpm_torch.mesh import PM
    from fastpm_torch.painter import Painter
    tmp, path = snap
    _both("paint", lambda pkg: [str(tmp / ("paint_" + pkg)), path,
                                "--nmesh", "32"])
    jb, tb = (BigFile(str(tmp / ("paint_" + pkg))).open_block("N0032")
              for pkg in ("jax", "torch"))
    want = jb.read_all()
    np.testing.assert_allclose(tb.read_all(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    ja, ta = jb.attrs.asdict(), tb.attrs.asdict()
    assert sorted(ta) == sorted(ja)
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]),
                                      np.asarray(ja[key]))
    x = BigFile(path).open_block("1/Position").read_all().astype(np.float32)
    xj = jnp.asarray(x)
    rho_j = JPainter(JPM(32, BOX), "cic", 2).paint(
        xj - jnp.floor(xj / BOX) * BOX)
    xt = torch.from_numpy(x)
    rho_t = Painter(PM(32, BOX), "cic", 2).paint(
        xt - torch.floor(xt / BOX) * BOX)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), atol=2e-6,
                               rtol=1e-5)


def test_pklin_exact(snap):
    tmp, _ = snap
    _both("pklin", lambda pkg: [str(tmp / ("pk_%s.txt" % pkg)),
                                "--sigma8", "0.8"], on_device=False)
    with open(str(tmp / "pk_jax.txt")) as a, \
            open(str(tmp / "pk_torch.txt")) as b:
        assert a.read() == b.read()


def _same_files(a, b):
    names = sorted(os.path.relpath(f, a) for f in glob.glob(
        os.path.join(a, "**"), recursive=True) if os.path.isfile(f))
    assert names == sorted(os.path.relpath(f, b) for f in glob.glob(
        os.path.join(b, "**"), recursive=True) if os.path.isfile(f))
    assert names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_host_tools_files_equal(snap):
    """gadget1, from-gadget1, cutslice and mpgadget write the same bytes
    as the JAX package's."""
    tmp, path = snap
    for pkg in ("jax", "torch"):
        os.makedirs(str(tmp / ("host_" + pkg)), exist_ok=True)

    def out(pkg, name):
        return str(tmp / ("host_" + pkg) / name)

    _both("gadget1", lambda pkg: [path, out(pkg, "g1/snap"),
                                  "--nperfile", "10000"], on_device=False)
    _both("from-gadget1", lambda pkg: [out(pkg, "g1/snap"),
                                       out(pkg, "back")], on_device=False)
    _both("cutslice", lambda pkg: [out(pkg, "slice"), path, "--haloid", "2",
                                   "--", path], on_device=False)
    _both("mpgadget", lambda pkg: [path, out(pkg, "mpg")], on_device=False)
    _same_files(str(tmp / "host_jax"), str(tmp / "host_torch"))
    assert len(glob.glob(out("torch", "g1/snap.*"))) == NC ** 3 // 10000


def test_unknown_tool_and_device(snap, capsys):
    assert tools.main([]) == 2
    assert tools.main(["nope"]) == 2
    assert sorted(tools.TOOLS) == sorted(
        ["fof", "rfof", "power", "pklin", "gadget1", "paint", "cutslice",
         "mpgadget", "halobias", "comparehalos", "from-gadget1", "lua"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tools.main_fof([snap[1], "-o", str(snap[0] / "nodev")])


# ---- the analysis functions -------------------------------------------

N, L = 16, 64.0


def _fields(seed=5):
    rng = np.random.RandomState(seed)
    shape = (N, N, N // 2 + 1)
    return [(rng.normal(size=shape) + 1j * rng.normal(size=shape))
            .astype(np.complex64) for _ in range(2)]


@pytest.mark.parametrize("cross", [False, True])
def test_measure_power_2d_matches_jax(cross):
    import jax.numpy as jnp
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.powerspectrum import measure_power_2d as jmp2d
    from fastpm_torch.mesh import PM
    from fastpm_torch.powerspectrum import measure_power_2d
    a, b = _fields()
    want = jmp2d(JPM(N, L), jnp.asarray(a), jnp.asarray(b) if cross
                 else None, Nmu=5)
    got = measure_power_2d(PM(N, L), torch.from_numpy(a),
                           torch.from_numpy(b) if cross else None, Nmu=5)
    np.testing.assert_array_equal(got["Nmodes"], want["Nmodes"])
    for key in ("k", "mu", "power"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-12)
    # the copies' path (float64 into copies of the bins) agrees too
    many = measure_power_2d(PM(N, L), torch.from_numpy(a),
                            torch.from_numpy(b) if cross else None, Nmu=5,
                            copies=4)
    np.testing.assert_array_equal(many["Nmodes"], want["Nmodes"])
    np.testing.assert_allclose(many["power"], want["power"], rtol=1e-5,
                               atol=1e-6 * np.abs(want["power"]).max())


def test_measure_transfer_matches_jax():
    import jax.numpy as jnp
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.powerspectrum import measure_transfer as jmt
    from fastpm_torch.mesh import PM
    from fastpm_torch.powerspectrum import measure_transfer
    a, b = _fields(6)
    want = jmt(JPM(N, L), jnp.asarray(a), jnp.asarray(b))
    got = measure_transfer(PM(N, L), torch.from_numpy(a),
                           torch.from_numpy(b))
    np.testing.assert_array_equal(got.Nmodes, want.Nmodes)
    np.testing.assert_allclose(got.p, want.p, rtol=1e-6)
    np.testing.assert_allclose(got.k, want.k, rtol=1e-6)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_dump_matches_jax(tmp_path, kind):
    from fastpm_tpu import dump as jdump
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_torch import dump
    from fastpm_torch.mesh import PM
    rng = np.random.RandomState(7)
    data = (_fields()[0] if kind == "complex"
            else rng.normal(size=(N, N, N)).astype(np.float32))
    jdump.dump_field(JPM(N, L), str(tmp_path / "jax"), data)
    dump.dump_field(PM(N, L), str(tmp_path / "torch"),
                    torch.from_numpy(data))
    for suffix in ("", ".geometry"):
        with open(str(tmp_path / "jax") + suffix, "rb") as a, \
                open(str(tmp_path / "torch") + suffix, "rb") as b:
            assert a.read() == b.read()
    back = dump.load_field(PM(N, L), str(tmp_path / "jax"), kind)
    np.testing.assert_array_equal(back, data)
    reader = dump.DumpFile(str(tmp_path / "torch"))
    got = reader.as_complex() if kind == "complex" else reader.as_real()
    want = getattr(jdump.DumpFile(str(tmp_path / "torch")),
                   "as_" + kind)()
    np.testing.assert_array_equal(got, want)


def test_angular_grid_matches_jax(tmp_path):
    from fastpm_tpu.io import angular as jangular
    from fastpm_torch.io import angular
    path = str(tmp_path / "grid")
    bf = BigFile(path, create=True)
    rng = np.random.RandomState(4)
    bf.create_block("RA", rng.uniform(0, 360, 48))
    bf.create_block("DEC", rng.uniform(-90, 90, 48))
    r, aemit = [0.0, 1.0, 2.0, 3.0], [0.1, 0.2, 0.3, 0.4]
    for sf in (1, 5):
        assert angular.angular_grid_size(path, 4, sf) == \
            jangular.angular_grid_size(path, 4, sf)
        want = jangular.read_angular_grid(path, r, aemit, sf)
        got = angular.read_angular_grid(path, r, aemit, sf, device="cpu")
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.aemit.numpy(),
                                      np.asarray(want.aemit))
    more = angular.read_angular_grid(path, r[:2], aemit[:2], store=got)
    want = jangular.read_angular_grid(path, r[:2], aemit[:2], store=want)
    np.testing.assert_array_equal(more.x.numpy(), np.asarray(want.x))


@pytest.mark.parametrize("scheme", ["fast", "slow", "gadget"])
def test_white_noise_schemes_match_jax(scheme):
    from fastpm_tpu import ic as jic
    from fastpm_tpu.mesh import PM as JPM, fetch_complex
    from fastpm_torch import ic
    from fastpm_torch.mesh import PM
    want = fetch_complex(jic.gaussian_white_noise(JPM(N, L), 42, scheme))
    got = ic.gaussian_white_noise(PM(N, L, device="cpu"), 42, scheme)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="scheme"):
        ic.gaussian_white_noise(PM(N, L), 42, "other")
