"""PGD (potential-gradient-descent) correction
(reference: libfastpm/pgdcorrection.c).

Port of fastpm_tpu/pgd.py. Sharpens halo interiors by an extra
displacement along the gradient of a band-filtered potential:
alpha(a) * exp(-kl^2/k^2 - k^4/ks^4) / k^2 with
alpha(a) = alpha0 * 10^(A a^2 - B a). Computed each force step from the
force's softened delta_k; consumed during the drift (factors.c:108-113).

With the CIC painter the three gradient fields are read out with one
launch of K2 (ops.cic.cic_readout of three fields), the gather K2's
kernel is built for; the JAX package reads out one component at a time
(pgd.py:52-60), the same contract. Other painters keep the per-component
readout. The band filter's table depends only on the mesh and is kept
per PM.

Over ranks (compute_local) the filter acts on the rank's k shard (a
parallel.pfft.KShard), the three order-1 gradients come back through
the engine's c2r_local, and the force's reader
(parallel.psolver.reader) reads them at the store's rows: homed K2 after
the halo gather on a slab or pencil, the gathered full fields for v1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mesh import PM
from .painter import Painter
from .ops import cic
from . import transfers

__all__ = ["PGDCorrection"]


@dataclass
class PGDCorrection:
    alpha0: float = 0.8
    A: float = 4.0
    B: float = 8.0
    kl: float = 2.0
    ks: float = 10.0
    painter_type: str = "cic"
    painter_support: int = 2

    def alpha(self, a: float) -> float:
        return self.alpha0 * 10 ** (self.A * a * a - self.B * a)

    def _filter(self, pm: PM):
        """(exp(-kl^2/kk - kk^2/ks^4), zero at kk = 0; kk with 1 at kk =
        0), float32 on the PM's device, made once per PM and filter."""
        def make():
            kk = pm.kk()
            safe = torch.where(kk > 0, kk, torch.ones_like(kk))
            e = torch.exp(-self.kl ** 2 / safe - safe * safe / self.ks ** 4)
            return torch.where(kk > 0, e, torch.zeros_like(e)), safe
        return pm._const(("pgd", self.kl, self.ks), make)

    def _pot_transfer_alpha(self, pm: PM, dk, alpha):
        """dk times alpha exp(-kl^2/kk - kk^2/ks^4) / kk (0 at kk = 0),
        rounded in the JAX package's order."""
        e, safe = self._filter(pm)
        return dk * ((float(np.float32(alpha)) * e) / safe)

    def compute_with_alpha(self, pm: PM, pos, delta_k, alpha_fac):
        """Per-particle pgdc displacement (N, 3) from delta_k with
        alpha(a) * fac given as a scalar (fastpm_pgdc_calculate)."""
        pot = self._pot_transfer_alpha(pm, delta_k, alpha_fac)
        # PGD was calibrated with difforder=1 (pgdcorrection.c:103)
        fields = [pm.c2r(transfers.apply_diff(pm, pot, d, order=1))
                  for d in range(3)]
        del pot
        painter = Painter(pm, self.painter_type, self.painter_support)
        if painter.is_cic:
            return cic.cic_readout(fields, pos, pm.InvCellSize)
        return torch.stack([painter.readout(f, pos) for f in fields], -1)

    def compute_local(self, engine, read, pos, delta_k, alpha_fac):
        """compute_with_alpha over the ranks: delta_k is the rank's k
        shard of engine (a SlabPM or PencilPM, the kz pad kept), pos the
        rank's rows and read(fields, x) the force's reader of local
        fields (psolver.reader)."""
        pot = self._pot_transfer_alpha(engine.kpm, delta_k, alpha_fac)
        fields = [engine.c2r_local(transfers.apply_diff(engine.kpm, pot, d,
                                                        order=1))
                  for d in range(3)]
        del pot
        return read(fields, pos)
