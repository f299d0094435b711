"""The measured late-time halo requirement of the slab decomposition
(port of the repo root's tools_measure_halo.py).

Runs a real simulation (nc^3 particles, a B2 force mesh, 10 FastPM steps
from a = 0.1 to z = 0, box 2 nc by default) through the Solver, then
measures on the device, fetching only scalars:

- the largest wrapped displacement |x - q| along each axis (Mpc/h);
- the index-homing halo requirement H of P = 8 / 16 / 32 x-slabs: the
  planes by which any particle strays outside the slab of its index
  shard (the particles of ids [r N / P, (r + 1) N / P) belong to slab r);
- the one-step drift bound, max |v| times the last step's drift factor,
  which a rehoming force's halo must cover on top of the CIC support.

Each particle's owner is taken from its id, never from its row: the
carry force returns the store in cell order (gravity.compute_force_carry),
and the owner of a row by its index in a cell-sorted store is not index
homing. On a store in id order both rules agree.

Usage: python -m fastpm_torch.measure_halo [nc] [box]; from Python
main([nc, box], device="cpu"). It runs on the first CUDA device unless
given a device, and prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

__all__ = ["main", "halo_metrics", "SPLITS"]

# the slab splits measured
SPLITS = (8, 16, 32)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "powerspec.txt")


def halo_metrics(store, pm, box: float):
    """(the largest wrapped displacement per axis as a float32 numpy
    array, max |v|, {P: H}) of a store on the force mesh pm: computed on
    the store's device, one fetch of 3 + 1 + len(SPLITS) scalars. The
    result does not depend on the order of the rows."""
    x, v = store.x, store.v
    L = torch.tensor(box, dtype=torch.float32, device=x.device)
    d = x - store.q_from_id()
    d = d - torch.round(d / L) * L
    dmax = torch.amax(torch.abs(d), dim=0)
    del d
    vmax = torch.amax(torch.abs(v)).reshape(1)
    n0 = pm.Nmesh[0]
    inv0 = float(np.float32(pm.InvCellSize[0]))
    bx = torch.remainder(torch.floor(x[:, 0] * inv0).to(torch.int32), n0)
    ids = store.id.to(torch.int64)
    npart = int(np.prod(store.q_nc))
    hs = []
    for P in SPLITS:
        pper, nloc = npart // P, n0 // P
        # the owner of each particle by its id: slab (id // (N / P))
        owner = (ids // pper).to(torch.int32)
        rel = torch.remainder(bx - owner * nloc, n0)
        stray = torch.minimum(rel - (nloc - 1), n0 - rel)
        hs.append(torch.amax(torch.where(rel < nloc, 0, stray)).reshape(1))
    out = torch.cat([dmax, vmax, torch.cat(hs).to(torch.float32)]).tolist()
    return (np.asarray(out[:3], dtype=np.float32), np.float32(out[3]),
            {P: int(h) for P, h in zip(SPLITS, out[4:])})


def main(argv=None, device=None) -> int:
    """python -m fastpm_torch.measure_halo [nc] [box]: the run of
    tools_measure_halo.py:36-48 and one JSON line of its keys."""
    from .cosmology import Cosmology
    from .device import resolve_device
    from .kdk import DriftFactor
    from .powerspectrum import FuncK
    from .solver import Solver, SolverConfig
    from . import ic

    argv = sys.argv[1:] if argv is None else list(argv)
    nc = int(argv[0]) if len(argv) > 0 else 256
    box = float(argv[1]) if len(argv) > 1 else 2.0 * nc
    dev = resolve_device(device)

    steps = list(np.linspace(0.1, 1.0, 10))
    cfg = SolverConfig(nc=nc, boxsize=box, time_step=steps,
                       force_mode="fastpm", pm_nc_factor=2,
                       need_rand=False)
    c = Cosmology(h=0.6774, Omega_m=0.307494, growth_mode="lcdm")
    pk = FuncK.from_file(FIXTURE)
    s = Solver(cfg, c, device=dev)
    dk, _ = ic.linear_field(s.lptpm, c, pk, seed=42, aout=1.0)
    s.setup_lpt(dk, steps[0])
    del dk
    s.evolve()

    pm = s.find_pm(1.0)     # the z = 0 force mesh (B2)
    n0 = pm.Nmesh[0]
    dmax, vmax, hs = halo_metrics(s.species["cdm"], pm, box)

    # the one-step drift bound: the last step's drift factor (kdk.py),
    # x(af) = x(ai) + v * dyyy(ai -> af)
    df = DriftFactor(cosmology=c, force_mode="fastpm",
                     ai=steps[-2], ac=steps[-2], af=steps[-1])
    du = float(df.lookup(steps[-1])[0])
    cell = box / n0
    vmax = float(vmax)
    out = {
        "nc": nc, "box": box, "B": 2, "mesh": n0,
        "steps": len(steps),
        "max_disp_mpc": [round(float(d), 3) for d in dmax],
        "max_disp_cells_B2": [round(float(d) / cell, 1) for d in dmax],
        "H_measured": {"P%d" % P: hs[P] for P in SPLITS},
        "nloc": {"P%d" % P: n0 // P for P in SPLITS},
        "one_step_drift_mpc": round(vmax * du, 4),
        "one_step_drift_cells_B2": round(vmax * du / cell, 2),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
