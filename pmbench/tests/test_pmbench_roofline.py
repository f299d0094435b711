"""The kernels' byte counts, the trace reading and the readers of the
kernel shares, on hand-worked numbers."""

import pytest

from pmbench import roofline, harness
from pmbench.trace import Trace

N, NU, M = 134217728, 41943040, (1024, 1024, 1024)


def test_bytes():
    # positions 12 B a row, the 1024^3 float32 mesh 4 GiB
    assert roofline.k1_bytes(N, M) == 1610612736 + 4294967296
    # three meshes read, positions read, accelerations written
    assert roofline.k2_bytes(N, M) == 12884901888 + 1610612736 * 2
    # the neutrinos' mass column adds 4 B a row
    assert roofline.k3_bytes(NU, M, True) == 671088640 + 4294967296
    assert roofline.k3_bytes(N, M, False) == roofline.k1_bytes(N, M)
    assert roofline.k4_bytes(NU, M) == 12884901888 + 1006632960
    assert roofline.share_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share_pct(1.0, 0.0) is None


def test_flops():
    # 4 real FFTs of 2^30 cells at 2.5 M log2 M, 16 a mode over 2^29
    # modes, one a cell, 100 a row
    assert roofline.force_flops([N], M) == (
        4 * 80530636800 + 8589934592 + 1073741824 + 13421772800)
    assert roofline.force_flops([N, NU], M) - roofline.force_flops(
        [N], M) == 100 * NU
    assert roofline.kick_drift_flops(NU) == 6 * NU


def ev(name, cat, ts, dur, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=0, tid=0)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 1000 us window: two forces, each launching a paint of 100 us
    and a readout of 200 us; a 100 us fill outside a force."""
    e = [ev("pmbench.window", "user_annotation", 0, 1000)]
    for i, t in enumerate((100, 500)):
        e.append(ev("pmbench.force", "user_annotation", t, 300))
        e.append(ev("cudaLaunchKernel", "cuda_runtime", t + 1, 1, 2 * i))
        e.append(ev("cudaLaunchKernel", "cuda_runtime", t + 2, 1, 2 * i + 1))
        e.append(ev("deposit_kernel(Deposit)", "kernel", t + 10, 100, 2 * i))
        e.append(ev("readout_kernel(Params)", "kernel", t + 110, 200,
                    2 * i + 1))
        e.append(ev("aten::sort", "cpu_op", t + 5, 50))
    e.append(ev("cudaLaunchKernel", "cuda_runtime", 850, 1, 9))
    e.append(ev("fill", "gpu_memset", 860, 100, 9))
    return Trace(e)


def test_trace_reading():
    tr = synthetic()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.count("pmbench.force") == 2
    assert tr.kernel_seconds("deposit", "pmbench.force") == (2e-4, 2)
    assert tr.kernel_seconds("fill", "pmbench.force") == (0.0, 0)
    assert tr.busy_s == pytest.approx(7e-4)
    assert tr.top_ops()[0] == ["readout_kernel(Params)", pytest.approx(4e-4)]
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(1.1e-4)
    assert abs(sum(g for _, g in gaps) - 3e-4) < 1e-12


@pytest.mark.parametrize("k,rows,bytes_", [
    (1, {"cdm": N}, roofline.k1_bytes(N, M)),
    (2, {"cdm": N}, roofline.k2_bytes(N, M)),
    (3, {"cdm": N, "ncdm": NU},
     roofline.k3_bytes(N, M, False) + roofline.k3_bytes(NU, M, True)),
    (4, {"cdm": N, "ncdm": NU},
     roofline.k4_bytes(N, M) + roofline.k4_bytes(NU, M)),
])
def test_kernel_share_readers(k, rows, bytes_):
    from types import SimpleNamespace
    shapes = dict(rows=rows, mass_column={"cdm": False, "ncdm": True},
                  mesh=M, steps=9)
    ctx = SimpleNamespace(trace=synthetic(), shapes=shapes,
                          clocks={"force": (0.5, 2)}, passes=1)
    got = harness._reader(f"k{k}_roofline_pct")(ctx)
    seconds = 2e-4 if k in (1, 3) else 4e-4
    assert got == pytest.approx(100 * 2 * bytes_ / 3.35e12 / seconds)
    # the other path's reader stays silent
    other = {1: 3, 2: 4, 3: 1, 4: 2}[k]
    assert harness._reader(f"k{other}_roofline_pct")(ctx) is None


def test_step_mfu_reader():
    from types import SimpleNamespace
    shapes = dict(rows={"cdm": N}, mass_column={"cdm": False}, mesh=M,
                  steps=9)
    ctx = SimpleNamespace(trace=None, shapes=shapes, passes=1, clocks={
        "force": (2.0, 10), "kick": (0.1, 18), "drift": (0.1, 18)})
    flops = 10 * roofline.force_flops([N], M) + 36 * 6 * N
    assert harness._reader("step_mfu.evolve")(ctx) == pytest.approx(
        100 * flops / 67e12 / 2.2)
    ctx.clocks = {}
    assert harness._reader("step_mfu.evolve")(ctx) is None
