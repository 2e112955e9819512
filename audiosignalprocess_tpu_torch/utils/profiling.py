"""Tracing and profiling on ``torch.profiler``: a trace of a region,
named spans in it, and a JSON-lines block logger for streaming runs (the
JAX package's ``utils.profiling``)."""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger("asp_torch")


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed region (host, and the card when there is one)
    into ``logdir/trace.json``, a Chrome/Perfetto trace."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named span on the profiler's timeline."""
    with record_function(name):
        yield


class BlockLogger:
    """JSON-lines throughput log for streaming runs (one record per block)."""

    def __init__(self, stream=None, every: int = 1):
        self.stream = stream
        self.every = every
        self._t0 = None
        self._block = 0

    def tick(self, samples: int, **extra) -> None:
        now = time.perf_counter()
        if self._t0 is not None and self._block % self.every == 0:
            dt = now - self._t0
            rec = {"block": self._block, "samples": samples,
                   "samples_per_s": round(samples / dt, 1), **extra}
            line = json.dumps(rec)
            if self.stream is not None:
                print(line, file=self.stream)
            else:
                log.info(line)
        self._t0 = now
        self._block += 1
