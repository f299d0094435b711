"""Typed pub/sub event system (reference: libfastpm/events.c).

The solver emits events around each phase; all output behavior (snapshots,
power spectra, lightcones) attaches as handlers, keeping file IO off the
compute path exactly like the reference CLI does (src/fastpm.c:290-318).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

__all__ = ["EventHandlers", "Event",
           "EVENT_LPT", "EVENT_FORCE", "EVENT_TRANSITION",
           "EVENT_INTERPOLATION", "EVENT_LIGHTCONE_READY", "EVENT_HALO",
           "STAGE_BEFORE", "STAGE_AFTER",
           "TIMESTEP_START", "TIMESTEP_CUR", "TIMESTEP_END"]

EVENT_LPT = "lpt"
EVENT_FORCE = "force"
EVENT_TRANSITION = "transition"
EVENT_INTERPOLATION = "interpolation"
EVENT_LIGHTCONE_READY = "lightcone_ready"
EVENT_HALO = "halo"

STAGE_BEFORE = "before"
STAGE_AFTER = "after"

# whence of an interpolation event (api/fastpm/solver.h)
TIMESTEP_START = "start"
TIMESTEP_CUR = "cur"
TIMESTEP_END = "end"


@dataclass
class Event:
    type: str
    stage: str
    data: Dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name):
        try:
            return self.__dict__["data"][name]
        except KeyError:
            raise AttributeError(name) from None


class EventHandlers:
    """Handler registry keyed by (event type, stage) (events.c:13-99)."""

    def __init__(self):
        self._handlers: List[Tuple[str, str, Callable]] = []

    def on(self, type: str, stage: str, fn: Callable) -> Callable:
        self._handlers.append((type, stage, fn))
        return fn

    def emit(self, type: str, stage: str, **data) -> Event:
        ev = Event(type, stage, data)
        for (t, s, fn) in list(self._handlers):
            if t == type and s == stage:
                fn(ev)
        return ev

    def has(self, type: str, stage: str) -> bool:
        """True if any handler listens on (type, stage). The solver
        uses this to skip producing event payloads nobody consumes
        (e.g. the deCIC'd delta_k of FORCE/AFTER)."""
        return any(t == type and s == stage
                   for (t, s, _f) in self._handlers)

    def remove(self, fn: Callable) -> None:
        self._handlers = [(t, s, f) for (t, s, f) in self._handlers
                          if f is not fn]
