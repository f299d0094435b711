"""Reading a torch.profiler trace of the measured window.

The traced run records the window with torch.profiler (CPU and CUDA
activities) and exports it as Chrome JSON into a temporary directory.
From it come: every device activity (kernels, copies, fills) with its
start, length and the host region of the benchmark's own annotations
(`pmbench.*`, record_function) that launched it; the seconds the device
was busy (the union of its activities) over the window; the device
operations that took most time; and the longest idle gaps, each named
by the innermost host event that was running at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["Trace", "read_profile"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")


class Trace:
    """Device activities of a window and the host regions around them."""

    def __init__(self, events: List[dict], window: str = "pmbench.window"):
        spans = [e for e in events if e.get("ph") == "X"]
        wins = [e for e in spans if e.get("name") == window
                and e.get("cat") == "user_annotation"]
        if not wins:
            raise ValueError(f"the trace holds no {window!r} region")
        w = max(wins, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        launch = {}
        for e in spans:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
        self.regions: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in spans:
            if (e.get("cat") == "user_annotation"
                    and e["name"].startswith("pmbench.")):
                self.regions[e["name"]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for r in self.regions.values():
            r.sort()
        # (name, start us, length us, launch us or None)
        self.device = sorted((
            (e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
             launch.get(e.get("args", {}).get("correlation")))
            for e in spans if e.get("cat") in DEVICE_CATS
            and self.t0 <= float(e["ts"]) < self.t1), key=lambda d: d[1])
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in spans if e.get("cat") in HOST_CATS)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def count(self, region: str) -> int:
        """How many times the host entered a region in the window."""
        return sum(1 for a, b in self.regions.get(region, ())
                   if self.t0 <= a < self.t1)

    def launched_in(self, launch: Optional[float], region: str) -> bool:
        if launch is None:
            return False
        spans = self.regions.get(region, [])
        i = bisect.bisect_right(spans, (launch, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= launch <= spans[i][1]

    def kernel_seconds(self, match: str, region: str) -> Tuple[float, int]:
        """(seconds, launches) of the device kernels whose name holds
        `match`, launched inside `region`."""
        sel = [d for n, s, d, l in self.device
               if match in n and self.launched_in(l, region)]
        return sum(sel) / 1e6, len(sel)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, s, d, _ in self.device:
            e = min(s + d, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        tot = defaultdict(float)
        for name, _, d, _ in self.device:
            tot[name[:120]] += d / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        inner = None
        for a, b, name in self.host:
            if a > t:
                break
            if b >= t and (inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, name)
        return inner[2] if inner else "host outside any traced event"

    def idle_gaps(self, n: int = 10) -> List[list]:
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(0.5 * (a + b)), (b - a) / 1e6]
                for a, b in gaps[:n]]


def read_profile(prof) -> Trace:
    """Export a finished torch.profiler.profile and read it."""
    d = tempfile.mkdtemp(prefix="pmbench-trace-")
    try:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return Trace(events)
