"""Discrete time-evolution state table (reference: libfastpm/timemachine.c).

Each state is a triplet of integer stamps (x, v, force) in units of half
steps; the standard kick-drift-kick template per cycle is
Kick(half) -> Drift -> Drift -> Force -> Kick(half) (solver.c:289-296).
Transitions between consecutive states are classified as FORCE/KICK/DRIFT
with (a_i, a_f, a_ref) scale factors obtained by log-interpolating the
user's timestep array within a cycle (timemachine.c:68-87).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

__all__ = ["StateTable", "Transition",
           "ACTION_FORCE", "ACTION_KICK", "ACTION_DRIFT"]

ACTION_FORCE = "force"
ACTION_KICK = "kick"
ACTION_DRIFT = "drift"

# The standard KDK template (solver.c:289-296): each entry is the stamp
# increment (force, x, v) relative to the start of the cycle
# (field order per api/fastpm/timemachine.h:5-7).
TEMPLATE_KDK = (
    (0, 0, 1),  # Kick (half)
    (0, 1, 1),  # Drift
    (0, 2, 1),  # Drift
    (2, 2, 1),  # Force
    (2, 2, 2),  # Kick (to full)
)


@dataclass(frozen=True)
class Transition:
    action: str
    # scale factors: initial, final, reference
    a_i: float
    a_f: float
    a_r: float
    # integer stamps
    i_i: int
    i_f: int
    i_r: int


class StateTable:
    """Generate and walk the state table (timemachine.c:22-59)."""

    def __init__(self, timesteps: Sequence[float],
                 template: Sequence[Tuple[int, int, int]] = TEMPLATE_KDK):
        if len(timesteps) < 1:
            raise ValueError("need at least one timestep")
        self.timesteps = [float(t) for t in timesteps]
        cycles = len(self.timesteps) - 1
        self.cycles = cycles
        self.cycle_len = template[-1][0]

        # table rows are (force, x, v) stamps
        table: List[Tuple[int, int, int]] = []
        table.append((-2, 0, 0))  # initial conditions
        table.append((0, 0, 0))   # first force calculation
        for i in range(cycles):
            base = table[i * len(template) + 1]
            for (df, dx, dv) in template:
                table.append((base[0] + df, base[1] + dx, base[2] + dv))
        self.table = table

    def i2t(self, i: int) -> float:
        """Stamp index -> scale factor by log interpolation within a step
        (timemachine.c:68-87)."""
        d = i // self.cycle_len
        r = (i - self.cycle_len * d) / float(self.cycle_len)
        if d >= self.cycles:
            return self.timesteps[self.cycles]
        if d < 0:
            return self.timesteps[0]
        if r != 0.0:
            return math.exp((1 - r) * math.log(self.timesteps[d])
                            + r * math.log(self.timesteps[d + 1]))
        return self.timesteps[d]

    def transition(self, istart: int, iend: int) -> Transition:
        """Classify the edge between two states (timemachine.c:89-140)."""
        sf, sx, sv = self.table[istart]
        ef, ex, ev = self.table[iend]
        if sf != ef:
            if sx != ex:
                raise ValueError("a force action must have identical x stamp")
            return Transition(ACTION_FORCE,
                              self.i2t(sf), self.i2t(ef), self.i2t(ex),
                              sf, ef, ex)
        if sv != ev:
            return Transition(ACTION_KICK,
                              self.i2t(sv), self.i2t(ev), self.i2t(ef),
                              sv, ev, ef)
        if sx != ex:
            return Transition(ACTION_DRIFT,
                              self.i2t(sx), self.i2t(ex), self.i2t(ev),
                              sx, ex, ev)
        raise ValueError(f"no-op transition {istart}->{iend}")

    def transitions(self) -> List[Transition]:
        """All transitions of the evolution, in order (solver.c:304-346)."""
        return [self.transition(i - 1, i) for i in range(1, len(self.table))]

    def find_dual(self, istart: int, action: str) -> Optional[Transition]:
        """Find the inverted dual transition for interpolation events
        (timemachine.c:142-178): the most recent KICK before a DRIFT ending
        at a synced state (or vice versa), inverted so its reference is in
        the past."""
        dual_action = {ACTION_DRIFT: ACTION_KICK,
                       ACTION_KICK: ACTION_DRIFT}[action]
        for i in range(istart, 0, -1):
            t = self.transition(i - 1, i)
            if t.action == dual_action:
                return self.transition(i, i - 1)
        return None

    def index_of(self, tr: Transition) -> int:
        """Index of the end state of a transition found by walking
        transitions() -- position in the table."""
        for i in range(1, len(self.table)):
            t = self.transition(i - 1, i)
            if t == tr:
                return i
        raise ValueError("transition not in table")

    def find_next_force_time(self, iend: int) -> Optional[float]:
        """a_f of the next FORCE transition after table position iend
        (timemachine.c:180-191)."""
        for i in range(iend, len(self.table) - 1):
            t = self.transition(i, i + 1)
            if t.action == ACTION_FORCE:
                return t.a_f
        return None
