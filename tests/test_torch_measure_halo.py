"""fastpm_torch.measure_halo against tools_measure_halo.py (the JAX tool at
the repo root), and the port's ids on the JAX package's id ladder.

On the CPU the JAX Solver keeps its rows in id order (its carry force
needs Pallas), so the reference tool's owner by row index is index
homing there, and the port, whose carry force returns the store in cell
order and which takes each owner from its id, must print the same
halo requirement. The run is tools_measure_halo.py's at 16^3, box 32:
both packages start from the same seed.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastpm_torch import measure_halo
from fastpm_torch.mesh import PM
from fastpm_torch.store import Store, lattice_store
from fastpm_tpu.store import Store as JStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    """(the JAX tool's JSON line, the port's) at nc = 16, box 32."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools_measure_halo.py"), "16",
         "32"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert measure_halo.main(["16", "32"], device="cpu") == 0
    return (json.loads(ref.stdout.strip().splitlines()[-1]),
            json.loads(out.getvalue().strip().splitlines()[-1]))


def test_matches_the_jax_tool(both):
    want, got = both
    assert set(got) == set(want)
    for key in ("nc", "box", "B", "mesh", "steps", "nloc", "H_measured"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["max_disp_mpc"], want["max_disp_mpc"],
                               rtol=0, atol=2e-3)
    assert abs(got["one_step_drift_mpc"]
               - want["one_step_drift_mpc"]) <= 1e-3
    # the run moved particles by cells, and H is about the displacement
    assert max(got["max_disp_cells_B2"]) > 2
    assert got["H_measured"]["P8"] > 0


def _displaced_store(nc=16, box=32.0, seed=3):
    """A lattice store displaced by up to ~3 cells of the B2 mesh, with
    velocities, and its force mesh."""
    pm = PM(2 * nc, box, device="cpu")
    p = lattice_store(PM(nc, box, device="cpu"))
    rng = np.random.RandomState(seed)
    dx = torch.from_numpy(rng.normal(0.0, 1.5, (nc ** 3, 3))
                          .astype(np.float32))
    v = torch.from_numpy(rng.normal(0.0, 1.0, (nc ** 3, 3))
                         .astype(np.float32))
    return p.replace(x=p.x + dx, v=v).wrap(box), pm


def _row_owner_h(p, pm, P):
    """The JAX tool's rule (tools_measure_halo.py:66-73): the owner of a
    row by its index."""
    n0 = pm.Nmesh[0]
    bx = torch.remainder(torch.floor(
        p.x[:, 0] * float(np.float32(pm.InvCellSize[0]))).to(torch.int64),
        n0)
    nloc = n0 // P
    dev = torch.arange(p.np_local) // (p.np_local // P)
    rel = torch.remainder(bx - dev * nloc, n0)
    stray = torch.minimum(rel - (nloc - 1), n0 - rel)
    return int(torch.where(rel < nloc, 0, stray).max())


def test_metrics_ignore_the_row_order():
    """A permuted store gives the same metrics; in id order H is the row
    index rule's, in cell order it is not."""
    from fastpm_torch.ops import cic
    p, pm = _displaced_store()
    dmax, vmax, hs = measure_halo.halo_metrics(p, pm, 32.0)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(
        p.np_local))
    sorted_p = p.take(cic.sort_by_cell(p.x, pm.Nmesh, pm.InvCellSize))
    for q in (p.take(perm), sorted_p):
        d2, v2, h2 = measure_halo.halo_metrics(q, pm, 32.0)
        np.testing.assert_array_equal(d2, dmax)
        assert v2 == vmax and h2 == hs
    for P in measure_halo.SPLITS:
        assert hs[P] == _row_owner_h(p, pm, P)
    # the reference tool's rule on a cell-sorted store measures the
    # sorted row blocks, not index homing
    assert any(_row_owner_h(sorted_p, pm, P) != hs[P]
               for P in measure_halo.SPLITS)


@pytest.mark.parametrize("nc, big, x64", [
    (1600, 2 ** 31 + 12345, False),   # ids above 2^31: uint32 in JAX
    (2048, 2 ** 32 + 777, True),      # ids above 2^32: int64 under x64
])
def test_q_from_id_ladder(nc, big, x64):
    """The port's int64 ids against the JAX package's id policy
    (tests/test_idpolicy.py) on its ladder."""
    ids = np.array([0, 1, nc - 1, nc * nc + 5, big, nc ** 3 - 1],
                   dtype=np.int64)
    meta = dict(q_nc=(nc,) * 3, q_scale=(0.5, 0.5, 0.5),
                q_shift=(0.25, 0.0, 0.125))
    got = Store(x=torch.zeros((len(ids), 3)), id=torch.from_numpy(ids),
                **meta).q_from_id().numpy()
    ctx = jax.enable_x64() if x64 else contextlib.nullcontext()
    with ctx:
        jid = jnp.asarray(ids.astype(np.int64 if x64 else np.uint32))
        want = np.asarray(JStore(x=jnp.zeros((len(ids), 3), jnp.float32),
                                 id=jid, **meta).q_from_id())
    np.testing.assert_array_equal(got, want)
    i = ids
    ref = np.stack([i // (nc * nc), (i // nc) % nc, i % nc], axis=-1)
    np.testing.assert_array_equal(
        got, (ref.astype(np.float32) * np.float32(0.5)
              + np.array([0.25, 0.0, 0.125], np.float32)))
