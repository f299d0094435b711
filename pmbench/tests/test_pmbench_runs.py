"""A run of each cell at 16^3 on the CPU against the reference: sound,
the control, and the faults that `correct` has to catch.

The harness is driven past its look for a card (device="cpu") at nc =
16, the box scaled to keep the cell's spacing. Sound runs agree with the
reference far inside the cell's limits; the reference with its meshes in
bfloat16 (the control), and the program broken underneath in each way a
cell can break, come out not correct.
"""

import json
import os

import pytest
import torch

from pmbench import compare, harness

CELLS = [w["name"] for w in json.load(open(os.path.join(
    harness.ROOT, "BENCHMARK.json")))["workloads"]]
SEED = 2 ** 31 + 977


def small(workload):
    _, p = harness.params(harness.load_cell(workload))
    return dict(nc=16, boxsize=p["boxsize"] * 16 / p["nc"])


def run(workload, traced=False):
    return harness.run(workload, SEED, 0.2, traced, device="cpu",
                       overrides=small(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "limits"
    for v in r["limits"].values():
        assert v["value"] <= 0.01 * v["limit"] or v["limit"] == 0
    cell = harness.load_cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(r["limits"]) == list(cell.entry.COMPARED)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run(workload):
    r = run(workload, traced=True)
    assert r["correct"]
    # the clocks' readers; the device's need a card
    assert {"force_ms.evolve", "kickdrift_ms.evolve"} <= set(r["metrics"])
    assert not any("roofline" in k for k in r["metrics"])
    assert r["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    cell = harness.load_cell(workload)
    _, ref_params = harness.params(cell, small(workload))
    values = cell.entry.control(ref_params, SEED, torch.device("cpu"))
    ok, _ = compare.judge(values, cell.limits)
    assert not ok


def _stale_kick(orig):
    def kick_one(self, p, kick, af, donate=False):
        return p.replace(a_v=float(af))
    return kick_one


def _half_paint(orig):
    def paint(self, x, mass, canvas=None, order=None):
        m = mass[::2] * 2 if torch.is_tensor(mass) else mass * 2
        return orig(self, x[::2].contiguous(), m, canvas, None)
    return paint


def _one_row(orig):
    def evolve(self, *a, **k):
        orig(self, *a, **k)
        st = self.peek("cdm")
        st.x[0] += 0.5 * self.config.boxsize / self.config.nc
    return evolve


FAULTS = {
    "state_unchanged": ("fastpm_torch.solver.Solver", "kick_one",
                        _stale_kick),
    "half_batch": ("fastpm_torch.painter.Painter", "paint", _half_paint),
    "one_answer_altered": ("fastpm_torch.solver.Solver", "evolve", _one_row),
}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(workload, fault, monkeypatch):
    import importlib
    where, attr, make = FAULTS[fault]
    mod, cls = where.rsplit(".", 1)
    owner = getattr(importlib.import_module(mod), cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    if fault == "half_batch":
        # the carry force paints through K1's entry, not the painter
        from fastpm_torch.ops import cic
        orig = cic.cic_paint
        monkeypatch.setattr(cic, "cic_paint", lambda x, n, inv, mass=1.0:
                            orig(x[::2].contiguous(), n, inv, 2 * mass))
    r = run(workload)
    assert not r["correct"] and r["failed"] == 1
