"""The port's field files (fastpm_torch/io/fields.py) against the JAX
package's (fastpm_tpu/io/fields.py): a file written by either package
is read by the other; the blocks, their bytes and their attributes are
equal; the port writes a tensor as it writes its host copy."""

import numpy as np
import pytest
import torch

from fastpm_tpu.io import fields as jfields
from fastpm_tpu.io.bigfile import BigFile as JBigFile
from fastpm_tpu.mesh import PM as JPM
from fastpm_torch.io import fields as tfields
from fastpm_torch.io.bigfile import BigFile
from fastpm_torch.mesh import PM

N, BOX = 16, 32.0
BLOCKS = {"complex": "LinearDensityK", "real": "LinearDensityR"}


def _field(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "complex":
        shape = (N, N, N // 2 + 1)
        return (rng.normal(size=shape)
                + 1j * rng.normal(size=shape)).astype(np.complex64)
    return rng.normal(size=(N, N, N)).astype(np.float32)


def _write(package, kind, data, path):
    block = BLOCKS[kind]
    if package == "jax":
        getattr(jfields, "write_" + kind)(JPM(N, BOX), data, path, block)
    else:
        getattr(tfields, "write_" + kind)(PM(N, BOX), torch.from_numpy(data),
                                          path, block)


def _read(package, kind, path):
    if package == "jax":
        return getattr(jfields, "read_" + kind)(JPM(N, BOX), path,
                                                BLOCKS[kind])
    return getattr(tfields, "read_" + kind)(PM(N, BOX), path, BLOCKS[kind])


@pytest.mark.parametrize("kind", ["complex", "real"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_field_read_by_the_other_package(tmp_path, kind, writer, reader):
    data = _field(kind)
    path = str(tmp_path / "field")
    _write(writer, kind, data, path)
    back = _read(reader, kind, path)
    assert back.dtype == data.dtype and back.shape == data.shape
    np.testing.assert_array_equal(back, data)


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_field_files_equal(tmp_path, kind):
    """Both packages' files of one field: the same block bytes, the same
    attributes with the same dtypes."""
    data = _field(kind, seed=1)
    paths = {}
    for package in ("jax", "torch"):
        paths[package] = str(tmp_path / package)
        _write(package, kind, data, paths[package])
    jb = JBigFile(paths["jax"]).open_block(BLOCKS[kind])
    tb = BigFile(paths["torch"]).open_block(BLOCKS[kind])
    np.testing.assert_array_equal(tb.read_all(), jb.read_all())
    assert tb.read_all().dtype == jb.read_all().dtype
    ja, ta = jb.attrs.asdict(), tb.attrs.asdict()
    assert sorted(ta) == sorted(ja)
    for key in ja:
        want, got = np.asarray(ja[key]), np.asarray(ta[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want)
    nz = N // 2 + 1 if kind == "complex" else N
    np.testing.assert_array_equal(np.ravel(ta["ndarray.shape"]), [N, N, nz])
    assert int(np.ravel(ta["Nmesh"])[0]) == N


def test_complex_file_from_a_strided_tensor(tmp_path):
    """A non-contiguous tensor (a transposed view) is written in the C
    order of its values, as its contiguous copy."""
    data = _field("complex", seed=2)
    t = torch.from_numpy(np.ascontiguousarray(data.transpose(1, 0, 2)))
    view = t.transpose(0, 1)
    assert not view.is_contiguous()
    tfields.write_complex(PM(N, BOX), view, str(tmp_path / "f"),
                          "WhiteNoiseK")
    back = jfields.read_complex(JPM(N, BOX), str(tmp_path / "f"),
                                "WhiteNoiseK")
    np.testing.assert_array_equal(back, data)
