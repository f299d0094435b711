"""Memory accounting and reporting.

Port of fastpm_tpu/memory.py. The reference owns allocation outright
(libfastpm/memory.c: a two-sided bump arena with tagged blocks, a peak
callback, and an OOM dump; report_memory at src/fastpm.c:1604-1646
prints the cross-rank peak after every transition, and the -m CLI flag
turns runaway allocation into a clean abort). Here PyTorch's caching
allocator owns the card's memory, so the equivalents are
observational: the allocator's counts of the bytes its tensors hold
(torch.cuda.memory_stats: allocated_bytes.all.current and .peak, with
the card's size from torch.cuda.mem_get_info), host RSS, a peak tracker
that only logs when the peak moves (matching report_memory's dedup),
and a bound that raises instead of letting the process die in an
unhelpful place.
"""

from __future__ import annotations

import resource
from typing import Optional

import torch

from .device import resolve_device

__all__ = ["device_memory_stats", "host_peak_rss_bytes",
           "MemoryMonitor", "MemoryBoundExceeded"]


class MemoryBoundExceeded(RuntimeError):
    """Raised when usage exceeds the bound set via -m (param.c:52-54)."""


def device_memory_stats(device=None) -> dict:
    """The allocator's statistics of a device under the JAX package's
    names (bytes_in_use, peak_bytes_in_use, bytes_limit); {} on the CPU.
    device: default the first CUDA device (raises when there is none)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


def host_peak_rss_bytes() -> int:
    """Peak resident set size of this process (ru_maxrss is KiB on
    Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class MemoryMonitor:
    """Tracks the peak of one device and the host, and reports only when
    it moves (report_memory, src/fastpm.c:1613-1646). device: default
    the first CUDA device (raises when there is none)."""

    def __init__(self, bound_bytes: Optional[int] = None, device=None):
        self.bound_bytes = bound_bytes
        self.device = resolve_device(device)
        self._old_device_peak = -1
        self._old_host_peak = -1

    def snapshot(self) -> dict:
        dstats = device_memory_stats(self.device)
        return {
            "device_bytes_in_use": int(dstats.get("bytes_in_use", 0)),
            "device_peak_bytes": int(
                dstats.get("peak_bytes_in_use",
                           dstats.get("bytes_in_use", 0))),
            "device_bytes_limit": int(dstats.get("bytes_limit", 0)),
            "host_peak_rss": host_peak_rss_bytes(),
        }

    def report(self, log=None, force: bool = False) -> Optional[str]:
        """Log the 'Peak memory usage' line when the peak changed since
        the last report (or when force is set); returns the line (or
        None if unchanged). Then checks the bound."""
        s = self.snapshot()
        line = None
        if (force or s["device_peak_bytes"] != self._old_device_peak
                or s["host_peak_rss"] != self._old_host_peak):
            self._old_device_peak = s["device_peak_bytes"]
            self._old_host_peak = s["host_peak_rss"]
            line = ("Peak memory usage: device %g MB (in use %g MB) "
                    "host rss %g MB"
                    % (s["device_peak_bytes"] / 1024. / 1024,
                       s["device_bytes_in_use"] / 1024. / 1024,
                       s["host_peak_rss"] / 1024. / 1024))
            if log is not None:
                log.info("%s", line)
            else:
                print(line)
        self.check_bound(s)
        return line

    def check_bound(self, snapshot: Optional[dict] = None) -> None:
        """MemoryBoundExceeded when the device's bytes in use or the
        host's peak RSS exceed the bound."""
        if self.bound_bytes is None:
            return
        s = snapshot or self.snapshot()
        used = max(s["device_bytes_in_use"], s["host_peak_rss"])
        if used > self.bound_bytes:
            raise MemoryBoundExceeded(
                "memory usage %g MB exceeds the bound %g MB "
                "(device in use %g MB, host rss %g MB)"
                % (used / 1024. / 1024,
                   self.bound_bytes / 1024. / 1024,
                   s["device_bytes_in_use"] / 1024. / 1024,
                   s["host_peak_rss"] / 1024. / 1024))
