"""The traced sub-window of a ``--trace 1`` run and what it reads.

``Tracer`` starts ``torch.profiler`` when the window's loop reaches
iteration ``start`` and stops it ``count`` iterations later, after a
synchronise, so a trace holds a bounded number of calls or blocks.  The
Chrome trace is written under ``TMPDIR`` (``tempfile``), read back and
deleted.  ``summarize`` reduces it to what the per-layer readers need:
the device activity inside the sub-window, its busy time, and the idle
gaps, each named by what the host was doing in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
TOP = 10


@dataclass
class TraceData:
    """A rank's traced sub-window: seconds, iterations, device events."""

    window_s: float
    busy_s: float
    units: int
    device: list = field(default_factory=list)  # (name, cat, start_s, dur_s)
    idle_gaps: list = field(default_factory=list)  # [host activity, seconds]

    def device_ops(self) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        tot: dict = {}
        for name, _, _, dur in self.device:
            tot[name] = tot.get(name, 0.0) + dur
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def kernel_s(self, nccl: bool) -> float:
        """Summed device time of NCCL's kernels, or of all the others."""
        return sum(d for name, cat, _, d in self.device
                   if cat == "kernel" and is_nccl(name) == nccl)

    def launches(self) -> int:
        """Kernels, copies and fills that ran on the device."""
        return len(self.device)


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


class Tracer:
    """Profiles iterations [start, start + count) of a window's loop."""

    def __init__(self, enabled: bool, start: int, count: int, device: torch.device):
        self.enabled, self.start, self.count = enabled, start, count
        self.device = device
        self.prof = None
        self.mark = None
        self.path = None
        self.on = False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initializes the device tracer, which would stall the window."""
        if not self.enabled:
            return
        warnings.filterwarnings("ignore", message="Profiler clears events")
        with self._profile():
            torch.zeros(1, device=self.device).add_(1.0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def tick(self, i: int) -> None:
        """Call at the start of iteration i of the window."""
        if not self.enabled:
            return
        if i == self.start:
            self.prof = self._profile()
            self.prof.start()
            self.mark = torch.profiler.record_function(WINDOW)
            self.mark.__enter__()
            self.on = True
        elif i == self.start + self.count:
            self.stop()

    def span(self, name: str):
        """A named host span on the trace while profiling, else nothing."""
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()

    def stop(self) -> None:
        """Close the sub-window (at its count or at the window's end)."""
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.on = False
        fd, self.path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def counted(self, i: int) -> bool:
        """Whether iteration i ran inside the sub-window."""
        return self.enabled and self.start <= i < self.start + self.count

    def summarize(self, units: int) -> TraceData | None:
        """The sub-window's ``TraceData`` (``units`` iterations ran in
        it), the trace file deleted; None when nothing was traced."""
        if self.path is None:
            return None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)
            self.path = None
        return summarize(events, units)


def _intervals(events: list, cats: tuple) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def summarize(events: list, units: int) -> TraceData | None:
    """Reduce a Chrome trace's events (times in microseconds) to the
    sub-window's ``TraceData``."""
    marks = [e for e in _intervals(events, ("user_annotation",)) if e.get("name") == WINDOW]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = []
    for e in _intervals(events, DEVICE_CATS):
        s, d = float(e["ts"]), float(e["dur"])
        s0, s1 = max(s, w0), min(s + d, w1)
        if s1 > s0 or (d == 0 and w0 <= s < w1):
            dev.append((e.get("name", "?"), e["cat"], s0 * 1e-6, (s1 - s0) * 1e-6))
    spans = sorted((s, s + d) for _, _, s, d in dev)
    busy, gaps, cur = 0.0, [], None
    t = w0 * 1e-6
    for s, e in spans:
        if s > t:
            gaps.append((t, s))
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
        t = max(t, e)
    if cur is not None:
        busy += cur[1] - cur[0]
    if w1 * 1e-6 > t:
        gaps.append((t, w1 * 1e-6))
    host = [e for e in _intervals(events, HOST_CATS) if e.get("name") != WINDOW]
    h0 = np.array([float(e["ts"]) * 1e-6 for e in host])
    h1 = h0 + np.array([float(e["dur"]) * 1e-6 for e in host])
    named: dict = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = np.nonzero((h0 <= mid) & (h1 > mid))[0]
        # the innermost host activity: the one that began last
        name = (host[inner[np.argmax(h0[inner])]].get("name", "?") if inner.size
                else "no host activity traced")
        named[name] = named.get(name, 0.0) + (g1 - g0)
    idle = [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:TOP]]
    return TraceData(window_s=(w1 - w0) * 1e-6, busy_s=busy, units=units, device=dev,
                     idle_gaps=idle)
