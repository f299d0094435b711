"""The numbers that decide `correct`: the program's rows at the end of a
pass against the reference's, matched by id.

- ids_unequal: rows whose id differs after both sides are sorted by id
  (exact: limit 0).
- dx_max_cells: the largest distance between a row's two positions,
  periodic in the box, in cells of the force mesh.
- dx_rms_cells: the root mean square of that distance over every row.
- dv_rms_rel: for each species the rms of the velocity difference over
  the rms velocity of the reference, the largest over the species.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

__all__ = ["NAMES", "gaps", "judge"]

NAMES = ("ids_unequal", "dx_max_cells", "dx_rms_cells", "dv_rms_rel")
BLOCK = 1 << 24


def gaps(program: Dict[str, Tuple], reference: Dict[str, Tuple],
         params: dict) -> Dict[str, float]:
    """The numbers above, in the box and force-mesh cells of the
    configuration's parameters."""
    box = float(params["boxsize"])
    pmf = params["pm_nc_factor"]
    pmf = float(pmf[0] if isinstance(pmf, (list, tuple)) else pmf)
    cell = box / round(int(params["nc"]) * pmf)
    if sorted(program) != sorted(reference):
        raise ValueError(f"species {sorted(program)} against "
                         f"{sorted(reference)}")
    unequal = 0
    dmax = 0.0
    d2 = 0.0
    n = 0
    dv = 0.0
    for name in sorted(program):
        pid, px, pv = program[name]
        rid, rx, rv = reference[name]
        order = torch.argsort(pid)
        pid, px, pv = pid[order], px[order], pv[order]
        order = torch.argsort(rid)
        rid, rx, rv = rid[order], rx[order], rv[order]
        del order
        if pid.shape != rid.shape:
            raise ValueError(f"{name}: {pid.shape[0]} rows against "
                             f"{rid.shape[0]}")
        unequal += int((pid.to(rid.device) != rid).sum())
        sv2 = v2 = 0.0
        for s in range(0, pid.shape[0], BLOCK):
            sl = slice(s, s + BLOCK)
            d = px[sl].to(rx.device).double() - rx[sl].double()
            d = d - torch.round(d / box) * box
            r2 = (d * d).sum(1)
            dmax = max(dmax, float(r2.max()))
            d2 += float(r2.sum())
            w = pv[sl].to(rv.device).double() - rv[sl].double()
            sv2 += float((w * w).sum())
            v2 += float((rv[sl].double() ** 2).sum())
        n += pid.shape[0]
        dv = max(dv, math.sqrt(sv2 / v2) if v2 > 0 else math.inf)
    return dict(ids_unequal=float(unequal),
                dx_max_cells=math.sqrt(dmax) / cell,
                dx_rms_cells=math.sqrt(d2 / n) / cell,
                dv_rms_rel=dv)


def judge(values: Dict[str, float], limits: Dict[str, dict]):
    """(correct, {name: {value, limit}}): correct when every number is at
    most its limit; a number without a limit fails."""
    out = {}
    ok = True
    for name, v in values.items():
        lim = limits.get(name, {}).get("limit")
        out[name] = {"value": v, "limit": lim}
        if lim is None or not v <= lim:
            ok = False
    return ok, out
