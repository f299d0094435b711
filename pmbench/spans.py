"""The program's own spans in a traced window.

While `fastpm_torch.prof.enable_sync` is on (the traced run), each of the
program's clocks is a torch.profiler range named "fastpm." + its name:
`init` and `lpt` (the Solver's constructor and 2LPT), `force`, `kick`
and `drift` (evolve's actions) at the top, and the force's phases
`force.<phase>` inside `force`. They reach the trace as `user_annotation`
events, which `Trace.host` holds as (start, end, name). A device
activity of the window (kernel, copy or fill) belongs to a span when the
host call that launched it lies inside one of the span's ranges.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

__all__ = ["PREFIX", "TOP", "ranges", "count", "launched_in",
           "per_force_ms", "per_pass_ms", "unspanned_pct"]

PREFIX = "fastpm."
# the program's top-level spans: every other span lies inside one
TOP = ("init", "lpt", "force", "kick", "drift")


def ranges(trace, name: str) -> List[Tuple[float, float]]:
    """The ranges of span `name` ("force.kspace"), sorted, in us."""
    key = PREFIX + name
    return sorted((a, b) for a, b, n in trace.host if n == key)


def count(trace, name: str) -> int:
    """How many times the host entered span `name` in the window."""
    return sum(1 for a, _ in ranges(trace, name) if trace.t0 <= a < trace.t1)


def _inside(spans: List[Tuple[float, float]], t: float) -> bool:
    # the ranges of one name do not overlap: the last to start before t
    # is the only one that can hold it
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def _split(trace, names: Sequence[str]):
    """The window's device activities (name, start us, length us, launch
    us) launched inside a range of one of the spans `names`, and the
    others (an activity whose launch the trace lacks among them)."""
    spans = [ranges(trace, n) for n in names]
    inside, outside = [], []
    for d in trace.device:
        held = d[3] is not None and any(_inside(s, d[3]) for s in spans)
        (inside if held else outside).append(d)
    return inside, outside


def launched_in(trace, names: Sequence[str]) -> List[tuple]:
    """The window's device activities launched inside a range of one of
    the spans `names`."""
    return _split(trace, names)[0]


def _device_ms(acts) -> float:
    return sum(d[2] for d in acts) / 1e3


def per_force_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Device ms a force launched inside the spans `names`: over the
    `force` ranges of the window; None without a trace, a force or such
    an activity."""
    if ctx.trace is None:
        return None
    forces = count(ctx.trace, "force")
    acts = launched_in(ctx.trace, names)
    if not forces or not acts:
        return None
    return _device_ms(acts) / forces


def per_pass_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Device ms a pass of the window launched inside the spans `names`;
    None without a trace, a pass or such an activity."""
    if ctx.trace is None or not ctx.passes:
        return None
    acts = launched_in(ctx.trace, names)
    return _device_ms(acts) / ctx.passes if acts else None


def _busy_us(acts, t1: float) -> float:
    """The union of the activities' intervals (cut at t1), in us."""
    busy, end = 0.0, None
    for _, s, d, _ in sorted(acts, key=lambda a: a[1]):
        e = min(s + d, t1)
        if end is None or s > end:
            busy += max(e - s, 0.0)
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def unspanned_pct(ctx) -> Optional[float]:
    """The share in percent of the window's device busy time launched
    outside every top-level span; None without a trace, or where the
    trace holds no span of the program."""
    tr = ctx.trace
    if tr is None or not any(ranges(tr, n) for n in TOP):
        return None
    total = _busy_us(tr.device, tr.t1)
    if total <= 0:
        return None
    return 100.0 * _busy_us(_split(tr, TOP)[1], tr.t1) / total
