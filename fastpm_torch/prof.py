"""Wall-clock profiling accumulators (reference: libfastpm/prof.c).

Port of fastpm_tpu/prof.py. Named clocks accumulate time across enters /
leaves; `report()` prints the table the reference emits at exit
(prof.c:144-178). CUDA launches return before the card is done, so a
host clock measures the time to queue a region's work. With
`enable_sync()` a region on the card is bracketed by CUDA events on the
current stream instead, and the clock holds the card's time from the
region's first queued work to its last, synchronising on the end event
only when the clock is read: the queue never drains between regions, so
the clocks cost the timed work nothing. Off by default, as in the JAX
package.

With `enable_sync()` each clock is also a span on the profiler's clock:
a `torch.profiler.record_function` range named "fastpm." + the clock's
name around its body, so that in a torch.profiler trace each kernel can
be put down to the span that launched it and each idle gap to the span
the host was in. A name's dotted prefix names its parent span:
`force.kspace` lies inside `force`. Without it a clock opens no range
and records no event: it costs a perf_counter pair.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

__all__ = ["Clock", "clock", "report", "reset", "enable_sync", "SPAN"]

# the prefix of a clock's range in a torch.profiler trace
SPAN = "fastpm."

_clocks: Dict[str, "Clock"] = {}
_sync_cuda = False


def enable_sync(on: bool = True):
    """Time regions on the card (CUDA events) instead of the host, and
    open each clock's span in a torch.profiler trace."""
    global _sync_cuda
    _sync_cuda = on


def _on_card() -> bool:
    return _sync_cuda and torch.cuda.is_initialized()


class Clock:
    def __init__(self, name: str):
        self.name = name
        self._seconds = 0.0
        self.count = 0
        self._t0: Optional[float] = None
        self._start = None
        # (start, end) event pairs not read yet
        self._pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def enter(self):
        if _on_card():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def leave(self):
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._start, end))
            self._start = None
        elif self._t0 is not None:
            self._seconds += time.perf_counter() - self._t0
            self._t0 = None
        else:
            return
        self.count += 1

    @property
    def time(self) -> float:
        """Seconds accumulated (the events' pairs read, after their end
        events complete)."""
        for start, end in self._pending:
            end.synchronize()
            self._seconds += start.elapsed_time(end) / 1e3
        self._pending.clear()
        return self._seconds


@contextmanager
def clock(name: str):
    """with prof.clock("force"): ... accumulates into the named clock,
    inside the span SPAN + name while enable_sync is on."""
    c = _clocks.setdefault(name, Clock(name))
    with record_function(SPAN + name) if _sync_cuda else nullcontext():
        c.enter()
        try:
            yield c
        finally:
            c.leave()


def report(printer=print):
    """Print the accumulated clock table (fastpm_clock_stat): each clock
    under its parent, indented by its depth, and the total of the
    top-level clocks (a nested clock's time is inside its parent's)."""
    if not _clocks:
        return
    printer("%-28s %10s %8s" % ("Clock", "Seconds", "Count"))
    total = 0.0
    for name in sorted(_clocks, key=lambda n: n.split(".")):
        c = _clocks[name]
        depth = name.count(".")
        printer("%-28s %10.4f %8d" % ("  " * depth + name, c.time, c.count))
        if not depth:
            total += c.time
    printer("%-28s %10.4f" % ("Total", total))


def reset():
    _clocks.clear()
