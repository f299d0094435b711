"""The port's clocks as spans on the profiler's clock (fastpm_torch.prof),
on the CPU at 8^3.

With prof.enable_sync on, every clock opens a torch.profiler range named
"fastpm." + its name around its body: the Solver's `init`, `lpt`, `kick`,
`drift` and `force`, and inside `force` the force's phases `force.*`.
With it off no range is opened and no CUDA event is recorded, and the
positions and velocities are the same bits either way. Over a one-rank
gloo group in this process (a HashStore, no socket; torn down with the
module) the Solver runs the bodies of the ranks: the homed slab carry,
the pencil carry (a 1 x 1 Grid) and v1 (a painter other than CIC), each
with the force's k-space stage and its spans.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import profile, ProfilerActivity

from fastpm_torch import ic, prof
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.parallel.comm import Grid
from fastpm_torch.powerspectrum import FuncK
from fastpm_torch.solver import Solver, SolverConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "powerspec.txt")
NC = 8
STEPS = [0.1, 0.55, 1.0]
PHASES = ("order", "paint", "r2c", "c2r", "kspace", "readout", "check",
          "wait", "wrap")
# the force paths by their Solver.force_paths name: (the config's
# options, the decomposition). On one device the order-free carry of one
# species, and the multi-species body in row order, here with the
# potential and the tidal tensor at the particles; over a group of one
# rank ("ring" or "grid") the homed slab carry, the pencil carry and v1
PATHS = {"carry": (dict(), None),
         "multi": (dict(order_free=False, compute_potential=True,
                        compute_tidal=True), None),
         "homed-carry": (dict(), "ring"),
         "pencil-carry": (dict(), "grid"),
         "v1": (dict(painter_type="linear"), "ring")}
# the phases the bodies over ranks clock: the Solver's and the stage's
RANKS_PHASES = ("c2r", "kspace", "check", "wait", "wrap")


@pytest.fixture(autouse=True)
def clean_clocks():
    prof.reset()
    prof.enable_sync(False)
    yield
    prof.reset()
    prof.enable_sync(False)


@pytest.fixture(scope="module")
def world():
    """The default process group of one gloo rank, destroyed with the
    module so that no other test of the worker sees it."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _pass(path, group=None):
    """A Solver pass as a library user runs it: the constructor,
    setup_lpt and evolve (over group, when given, as the path's
    decomposition says). Returns the solver."""
    options, comm = PATHS[path]
    where = ({} if comm is None else dict(group=group) if comm == "ring"
             else dict(grid=Grid(group, 1, 1)))
    c = Cosmology(h=0.6774, Omega_m=0.307494, growth_mode="lcdm")
    s = Solver(SolverConfig(nc=NC, boxsize=4.0 * NC, time_step=STEPS,
                            pm_nc_factor=2, check_values=True,
                            **options), c, device="cpu", **where)
    dk, _ = ic.linear_field(s.lptpm, c, FuncK.from_file(FIXTURE), seed=7,
                            aout=1.0)
    s.setup_lpt(dk, STEPS[0])
    s.evolve(STEPS)
    return s


def _traced(path, sync, tmp_path, group):
    """A pass under a torch.profiler CPU trace with enable_sync as given:
    (the solver, the trace's ranges by name as (start, end) in us)."""
    prof.enable_sync(sync)
    with profile(activities=[ProfilerActivity.CPU]) as trace:
        s = _pass(path, group)
    prof.enable_sync(False)
    out = tmp_path / ("trace_%s_%d.json" % (path, sync))
    trace.export_chrome_trace(str(out))
    ranges = {}
    for e in json.loads(out.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return s, ranges


@pytest.fixture(scope="module", params=sorted(PATHS))
def runs(request, tmp_path_factory):
    """Each path's pass with the spans off and on, under a trace."""
    tmp = tmp_path_factory.mktemp("prof_" + request.param)
    group = (request.getfixturevalue("world")
             if PATHS[request.param][1] else None)
    off = _traced(request.param, False, tmp, group)
    prof.reset()
    on = _traced(request.param, True, tmp, group)
    clocks = {n: c.count for n, c in prof._clocks.items()}
    prof.reset()
    return dict(path=request.param, off=off, on=on, clocks=clocks)


def test_clocks_nest_and_keep_their_counts():
    """A dotted clock nests in its parent: each keeps its own count and
    time, the report prints the child under its parent, and its Total
    adds the top-level clocks only."""
    for sync in (False, True):
        prof.reset()
        prof.enable_sync(sync)
        for _ in range(3):
            with prof.clock("force") as outer:
                for _ in range(2):
                    with prof.clock("force.kspace") as inner:
                        sum(range(1000))
            with prof.clock("kick"):
                pass
        assert (outer.count, inner.count) == (3, 6)
        assert prof._clocks["kick"].count == 3
        assert 0 < inner.time <= outer.time
        lines = []
        prof.report(printer=lines.append)
        assert [l.split()[0] for l in lines] == [
            "Clock", "force", "force.kspace", "kick", "Total"]
        assert lines[2].startswith("  force.kspace")
        total = float(lines[-1].split()[1])
        want = float("%.4f" % (outer.time + prof._clocks["kick"].time))
        assert total == pytest.approx(want, abs=2e-4)


def test_off_opens_no_range_and_records_no_event(monkeypatch):
    """With enable_sync off a clock neither opens a record_function range
    nor records a CUDA event, even where the card is initialised; with
    it on, it does both."""
    opened, events = [], []

    class Event:
        def __init__(self, enable_timing=False):
            events.append(self)

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.0

    real = prof.record_function

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(prof, "record_function", counted)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with prof.clock("force"):
        with prof.clock("force.paint"):
            pass
    assert opened == [] and events == []
    assert prof._clocks["force"].count == 1
    prof.enable_sync(True)
    with prof.clock("force"):
        with prof.clock("force.paint"):
            pass
    assert opened == ["fastpm.force", "fastpm.force.paint"]
    assert len(events) == 4
    assert prof._clocks["force.paint"].count == 2
    assert prof._clocks["force.paint"].time >= 2e-3


def test_off_trace_holds_no_span(runs):
    _, ranges = runs["off"]
    assert not [n for n in ranges if n.startswith(prof.SPAN)]


def test_on_trace_holds_every_span(runs):
    """The pass's trace holds init, lpt, the actions and every phase of
    the force, each as often as its clock counted it."""
    _, ranges = runs["on"]
    ranks = PATHS[runs["path"]][1] is not None
    want = {"init", "lpt", "force", "kick", "drift"}
    want |= {"force." + p for p in (RANKS_PHASES if ranks else PHASES)}
    got = {n[len(prof.SPAN):] for n in ranges if n.startswith(prof.SPAN)}
    assert got == want
    counts = {n: len(ranges[prof.SPAN + n]) for n in got}
    assert counts == runs["clocks"]
    forces = len(STEPS)  # one force at each time
    assert counts["force"] == forces
    for p in ("check", "wait", "wrap") + (() if ranks
                                          else ("order", "paint", "r2c")):
        assert counts["force." + p] == forces
    # three gradients a force, and the potential's and six tidal c2r on
    # the multi path
    extra = 1 + 6 if runs["path"] == "multi" else 0
    assert counts["force.c2r"] == forces * (3 + extra)
    if ranks:
        # over ranks the stage's gradients alone: the softening is r2c's
        assert counts["force.kspace"] == forces * 3


def test_force_phases_lie_inside_a_force(runs):
    _, ranges = runs["on"]
    forces = ranges[prof.SPAN + "force"]
    for name, spans in ranges.items():
        if not name.startswith(prof.SPAN + "force."):
            continue
        for a, b in spans:
            assert any(fa <= a and b <= fb for fa, fb in forces), name


def test_spans_leave_the_bits(runs):
    """Positions and velocities with the spans on are those with them
    off, bit for bit (the carry's rows are in cell order: by id)."""
    (s_off, _), (s_on, _) = runs["off"], runs["on"]
    a, b = s_off.peek("cdm"), s_on.peek("cdm")
    assert torch.equal(a.id, b.id)
    oa, ob = torch.argsort(a.id), torch.argsort(b.id)
    assert torch.equal(a.x[oa], b.x[ob]) and torch.equal(a.v[oa], b.v[ob])
    assert s_off.force_paths == s_on.force_paths
    assert set(s_on.force_paths) == {runs["path"]}
    assert np.isfinite(b.x.numpy()).all()
