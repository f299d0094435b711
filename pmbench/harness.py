"""One run of one cell of the benchmark: set-up, the measured window, the
traced reading, and the comparison with the reference that decides
`correct`.

Everything a cell needs is found by name from BENCHMARK.json, so that a
cell, a traffic mix, an entry or a metric is added with files of its own
and no edit here:

- its configuration: pmbench/configs/<config>.json (source, cut, the
  Lua file beside it that both the program and the reference read);
- its traffic mix: pmbench/traffic/<traffic>.json, a data file whose
  `entry` names the code that drives the program;
- that entry: pmbench/entries/<entry>.py, which holds `COMPARED` (the
  names of the numbers it compares), `Mix(params, ref_params, seed,
  device, traced, traffic)` with `run_pass()` (one pass; returns its
  work as named counts), `drop()`, `shapes()`, `finish()` (keeps the
  output, frees the program's state), `compare()` (the compared numbers)
  and `phases` (set-up seconds by phase), and `control(ref_params, seed,
  device)` (the control's numbers, for pmbench/calibrate.py);
- its limits: pmbench/limits/<workload>.json, one per compared number;
- every metric, end-to-end or per-layer: a reader
  pmbench/metrics/<metric>.py whose read(ctx) gives the value or None.

The window runs whole passes back to back and closes at the end of the
first pass that ends past `seconds`; a metric's reader sees the work
counted over every pass of the window and the whole window's length.
Set-up is everything from the start of the process to the window, a
warm pass included, so that nothing is built or planned inside it.
After the window the program's output is kept, its state freed, and the
entry's reference runs.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from collections import Counter
from types import SimpleNamespace

import torch
from torch.profiler import profile, record_function, ProfilerActivity

from fastpm_torch import prof
from fastpm_torch.config.params import load_params, Params

from pmbench import compare, trace as tracing

__all__ = ["ROOT", "load_cell", "run", "FORBIDDEN", "forbidden_modules"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "pmbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "fastpm_tpu")


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(kind, name):
    """pmbench/<kind>/<name>.py, loaded from its file."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"pmbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(name):
    return _module("metrics", name).read


def load_cell(workload: str):
    """The cell's entries and files, found by name."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{', '.join(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_path = os.path.join(ROOT, entry["file"])
    config = _json(cfg_path)
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), config=config,
        lua=os.path.join(os.path.dirname(cfg_path), config["lua"]),
        traffic=traffic, entry=_module("entries", traffic["entry"]),
        limits=_json(os.path.join(HERE, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def params(cell, overrides=None):
    """(the program's Params, the reference's dict of plain values), both
    from the configuration's Lua file with the overrides applied. The
    loader resolves the tables' paths beside the Lua file."""
    p = load_params(cell.lua).asdict()
    p.update(overrides or {})
    ref = copy.deepcopy(p)
    return Params(p, filename=cell.lua), ref


def _power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _metrics(specs, ctx, required):
    out = {}
    for m in specs:
        v = _reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        elif required:
            raise RuntimeError(f"{m['name']}: its reader found nothing in "
                               "this cell")
    return out


def run(workload: str, seed: int, seconds: float, traced: bool,
        device="cuda", overrides=None, t0=None):
    """Run one cell once; returns the result line's dict (its last key,
    `limits`, holds each compared number beside its limit)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start_s": time.perf_counter() - t0}
    cell = load_cell(workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=dev)
        phases["context_s"] = time.perf_counter() - t
    program_params, ref_params = params(cell, overrides)
    mix = cell.entry.Mix(program_params, ref_params, seed, dev, traced,
                         cell.traffic)
    phases.update(mix.phases)
    t = time.perf_counter()
    mix.run_pass()
    mix.drop()
    sync()
    phases["warm_s"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof.reset()
    prof.enable_sync(traced)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    recorder = profile(activities=acts) if traced else None
    passes = 0
    counts = Counter()
    setup_s = time.perf_counter() - t0
    if recorder is not None:
        recorder.start()
    start = time.perf_counter()
    with record_function("pmbench.window"):
        while True:
            counts.update(mix.run_pass())
            sync()
            passes += 1
            if time.perf_counter() - start >= seconds:
                break
    window_s = time.perf_counter() - start
    if recorder is not None:
        recorder.stop()
    kept = getattr(prof, "_clocks", {})
    clocks = {c: (kept[c].time, kept[c].count)
              for c in ("force", "kick", "drift") if c in kept}
    prof.enable_sync(False)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    shapes = mix.shapes()
    mix.finish()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    tr = None
    if traced:
        tr = tracing.read_profile(recorder)
        del recorder
    ctx = SimpleNamespace(trace=tr, clocks=clocks, shapes=shapes,
                          passes=passes, counts=dict(counts),
                          window_s=window_s, setup_s=setup_s,
                          peak_bytes=window_peak)
    result = dict(correct=False, attempted=passes, failed=1)
    result["metrics"] = (_metrics(cell.per_layer, ctx, False) if traced
                         else _metrics(cell.end_to_end, ctx, True))
    result["device"] = dict(
        platform="gpu" if cuda else dev.type,
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=1, memory_peak_bytes=max(setup_peak, window_peak))
    if cuda:
        result["device"]["power_limit"] = _power_limit()
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = dict(device_ops=tr.top_ops(),
                                   idle_gaps=tr.idle_gaps())
    result["setup_phases"] = phases

    values = mix.compare()
    ok, limits = compare.judge(values, cell.limits)
    result.update(correct=ok, failed=0 if ok else 1, limits=limits)
    return result
