"""Standard event handlers mirroring the reference CLI's reporting
(src/fastpm.c: report_lpt, report_domain, write_powerspectrum).

These produce the golden-log lines the reference's regression suite pins
(dx1/dx2 std, broadband growth check, per-step P(k) files). On several
ranks every summary and spectrum is over all of them (solver.ring), so
every rank logs the same lines, and rank 0 writes the P(k) file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import events as ev
from .powerspectrum import measure_power, sigma_tophat

__all__ = ["attach_standard_handlers", "Log"]


class Log:
    """Collects fastpm_info-style lines; print and/or retain for golden
    checks. Supports a pluggable handler stack like the reference's
    fastpm_push/pop_msg_handler (logging.c:113-120): push a callable to
    intercept lines (e.g. silence a noisy section or tee to a file),
    pop to restore the previous behavior."""

    def __init__(self, echo: bool = True):
        self.lines = []
        self.echo = echo
        self._handlers = []

    def info(self, fmt, *args):
        line = fmt % args if args else fmt
        self.lines.append(line)
        if self._handlers:
            self._handlers[-1](line)
        elif self.echo:
            print(line)

    def push_handler(self, fn) -> None:
        """fn(line) replaces the default echo until popped
        (fastpm_push_msg_handler)."""
        self._handlers.append(fn)

    def pop_handler(self) -> None:
        if not self._handlers:
            raise RuntimeError("handler stack is empty "
                               "(fastpm_pop_msg_handler contract)")
        self._handlers.pop()

    @staticmethod
    def void_handler(line) -> None:
        """Discard (fastpm_void_msg_handler)."""

    def contains(self, text: str) -> bool:
        return any(text in l for l in self.lines)


def attach_standard_handlers(solver, log: Optional[Log] = None,
                             write_powerspectrum: Optional[str] = None,
                             enforce_broadband_kmax: int = 4):
    """Register the reference's 3 reporting handlers. Returns the Log."""
    if log is None:
        log = Log()

    def report_lpt(event):
        p = event.store
        if p.dx1 is None:
            return
        ring = event.solver.ring
        _, std1, _, _ = p.summary("dx1", ring)
        _, std2, _, _ = p.summary("dx2", ring)
        log.info("dx1  : %g %g %g %g", std1[0], std1[1], std1[2],
                 np.mean(std1))
        log.info("dx2  : %g %g %g %g", std2[0], std2[1], std2[2],
                 np.mean(std2))

    def report_domain(event):
        s = event.solver
        for name in s.iter_species():
            p = s.peek(name)
            mn, _, _, mx = p.summary("x", s.ring)
            log.info("Position range (a = %06.4f): min = %g %g %g "
                     "max = %g %g %g", p.a_x, *mn, *mx)
            if p.v is not None:
                _, vstd, _, _ = p.summary("v", s.ring)
                log.info("Velocity dispersion (a = %06.4f): "
                         "std = %g %g %g", p.a_v, *vstd)

    def write_ps(event):
        s = event.solver
        pm = event.pm
        p = s.peek("cdm")
        if p.acc is not None:
            _, fstd, _, _ = p.summary("acc", s.ring)
            log.info("Force dispersion: std = %g %g %g", *fstd)
        ps = measure_power(pm, event.delta_k, ring=s.ring)
        plin = ps.large_scale(enforce_broadband_kmax)
        sigma8 = sigma_tophat(ps.as_funck(), 8.0)
        D1 = s.cosmology.growth_info(event.a_f).D1
        plin /= D1 ** 2
        sigma8 /= D1 ** 2
        log.info("D^2(%g, 1.0) P(k<%g) = %g Sigma8 = %g",
                 event.a_f, enforce_broadband_kmax * 6.28 / pm.BoxSize[0],
                 plin, sigma8)
        if write_powerspectrum:
            path = "%s_%0.04f.txt" % (write_powerspectrum, event.a_f)
            if s.ring.rank == 0:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                ps.write(path, event.N, pm.BoxSize)
            log.info("writing power spectrum to %s", path)

    solver.event_handlers.on(ev.EVENT_LPT, ev.STAGE_AFTER, report_lpt)
    solver.event_handlers.on(ev.EVENT_FORCE, ev.STAGE_BEFORE, report_domain)
    solver.event_handlers.on(ev.EVENT_FORCE, ev.STAGE_AFTER, write_ps)
    return log
