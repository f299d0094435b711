"""The readers of the program's spans (pmbench/spans.py), on a hand-made
Chrome trace."""

from types import SimpleNamespace

import pytest

from pmbench import harness, spans
from pmbench.trace import Trace

READERS = {"order_ms.evolve": ["force.order"],
           "paint_ms.evolve": ["force.paint"],
           "fft_ms.evolve": ["force.r2c", "force.c2r"],
           "kspace_ms.evolve": ["force.kspace"],
           "readout_ms.evolve": ["force.readout"],
           "lpt_ms.evolve": ["init", "lpt"],
           "unspanned_pct.evolve": list(spans.TOP)}


def ev(name, cat, ts, dur, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=0, tid=0)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 2000 us window of one pass: init (a 20 us fill) and lpt (a 30 us
    kernel), then two forces, each launching in its phases a sort of 10
    us, a paint of 40, an r2c of 50, k-space passes of 60 and 70, a c2r
    of 80 and a readout of 90, and a 5 us copy in the force outside its
    phases; a 100 us kernel launched outside every span, and one of 25 us
    whose launch the trace lacks. The device runs them one after another,
    each as soon as it is launched and the one before has ended. A force
    range that starts before the window is not counted."""
    e = [ev("pmbench.window", "user_annotation", 0, 2000),
         ev("fastpm.force", "user_annotation", -50, 40)]
    corr = iter(range(1000))
    free = [0.0]

    def launch(t, kernel, dur, cat="kernel"):
        c = next(corr)
        start = max(t + 1, free[0])
        free[0] = start + dur
        e.append(ev("cudaLaunchKernel", "cuda_runtime", t, 1, c))
        e.append(ev(kernel, cat, start, dur, c))

    e.append(ev("fastpm.init", "user_annotation", 10, 20))
    launch(15, "fill", 20, "gpu_memset")
    e.append(ev("fastpm.lpt", "user_annotation", 40, 20))
    launch(45, "lpt_kernel", 30)
    for t in (100, 600):
        e.append(ev("fastpm.force", "user_annotation", t, 400))
        for i, (phase, dur) in enumerate((
                ("order", 10), ("paint", 40), ("r2c", 50), ("kspace", 60),
                ("c2r", 80), ("kspace", 70), ("readout", 90))):
            a = t + 10 + 40 * i
            e.append(ev("fastpm.force." + phase, "user_annotation", a, 30))
            launch(a + 5, phase + "_kernel", dur)
        launch(t + 350, "copy", 5, "gpu_memcpy")
        e.append(ev("aten::add", "cpu_op", t + 360, 2))
    launch(1100, "loose_kernel", 100)
    e.append(ev("lost_kernel", "kernel", 1700, 25, 99999))
    return Trace(e)


def ctx(trace=None, passes=1):
    return SimpleNamespace(trace=trace, passes=passes, clocks={}, shapes={},
                           counts={}, window_s=2e-3)


def test_ranges_and_counts():
    tr = synthetic()
    assert spans.count(tr, "force") == 2
    assert spans.count(tr, "force.kspace") == 4
    assert spans.count(tr, "init") == spans.count(tr, "lpt") == 1
    assert spans.ranges(tr, "force")[0] == (-50.0, -10.0)
    names = [d[0] for d in spans.launched_in(tr, ["force.kspace"])]
    assert names == ["kspace_kernel"] * 4


@pytest.mark.parametrize("names,ms", [
    (["force.order"], 0.010), (["force.paint"], 0.040),
    (["force.r2c", "force.c2r"], 0.130), (["force.kspace"], 0.130),
    (["force.readout"], 0.090), (["force"], 0.405)])
def test_per_force_ms(names, ms):
    assert spans.per_force_ms(ctx(synthetic()), names) == pytest.approx(ms)


def test_per_pass_ms():
    assert spans.per_pass_ms(ctx(synthetic()), ["init", "lpt"]) == (
        pytest.approx(0.050))
    assert spans.per_pass_ms(ctx(synthetic(), 2), ["init"]) == (
        pytest.approx(0.010))
    assert spans.per_pass_ms(ctx(synthetic(), 0), ["init"]) is None


def test_unspanned_pct():
    # busy: 20 + 30 + 2 x 405 + 100 + 25 = 985 us; outside every
    # top-level span: the loose kernel and the one without its launch
    assert spans.unspanned_pct(ctx(synthetic())) == pytest.approx(
        100 * 125 / 985)


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers(name):
    """Each reader gives its spans' number on the trace, and None without
    a trace or where the trace holds none of the program's spans."""
    read = harness._reader(name)
    assert read(ctx()) is None
    bare = Trace([ev("pmbench.window", "user_annotation", 0, 100),
                  ev("cudaLaunchKernel", "cuda_runtime", 10, 1, 1),
                  ev("k", "kernel", 20, 30, 1)])
    assert read(ctx(bare)) is None
    c = ctx(synthetic())
    if name == "unspanned_pct.evolve":
        want = spans.unspanned_pct(c)
    elif name == "lpt_ms.evolve":
        want = spans.per_pass_ms(c, READERS[name])
    else:
        want = spans.per_force_ms(c, READERS[name])
    assert want and read(c) == pytest.approx(want)


def test_readers_are_in_the_benchmark():
    """The seven readers are per-layer metrics of both cells, read from
    the program's spans."""
    for w in ("standard512.evolve", "ncdm512.evolve"):
        cell = harness.load_cell(w)
        got = {m["name"]: m for m in cell.per_layer}
        for name in READERS:
            assert got[name]["source"] == "program_span"
            assert got[name]["moves"] == "particle_steps_per_s"
