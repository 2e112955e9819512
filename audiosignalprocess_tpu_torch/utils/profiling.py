"""Tracing and profiling: the program's spans and counters, a trace of a
region on ``torch.profiler``, and a JSON-lines block logger for streaming
runs (the JAX package's ``utils.profiling``).

Spans.  ``span(name)`` marks a layer boundary; the program's names start
with ``asp.``: ``asp.Chain.step``, ``.full`` and ``.full_flush`` (the
entry points), ``asp.<Stage>.step`` and ``.full`` (stage routing),
``asp.kernel.<wrapper>`` around a kernel wrapper's body with the child
``asp.launch`` around the launch itself, and in a sharded call
``asp.sharded_chain``, ``asp.shard.<component>``, ``asp.spill_and_norm``
and ``asp.collective.<op>``.  A span has two sinks:

- the recorder, while ``enable(True)`` holds: ``(name, t0_ns, t1_ns,
  parent, root)`` appended in memory on ``time.perf_counter_ns``'s clock,
  ``parent`` the enclosing span's index (None for a root) and ``root``
  the outermost's (one entry call: a block or a call), kept until a caller
  reads ``spans()``.  It follows one thread's nesting;
- ``torch.profiler``, while it runs: the span opens a ``record_function``
  of its name, so its interval lies on the trace's timeline beside the
  kernels it issued.

With both off a span is one check and a shared no-op object: nothing is
allocated or timed.  No span synchronises the device or records an event.

Counters (``counters``): each kernel wrapper's ``.launches``, the tables
``utils.device.upload`` copied to a CUDA device and their bytes, and the
CUDA caching allocator's count of allocations.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger("asp_torch")

_recording = False
_records: list = []  # (name, t0_ns, t1_ns, parent, root); t1_ns None while open
_open: list = []  # indexes into _records of the open spans, outermost first
_profiler_on = torch._C._autograd._profiler_enabled
_wrappers: list = []  # the kernel wrappers, whose .launches counters() reads
_counts = {"uploads": 0, "upload_bytes": 0}


class _Off:
    """The span while both sinks are off: one shared object whose
    ``__enter__`` and ``__exit__`` are builtins, so a ``with`` on it runs
    no Python frame.  ``__exit__`` returns "" (false): exceptions pass."""

    __slots__ = ()
    __enter__ = staticmethod(_profiler_on)
    __exit__ = staticmethod("".format)


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "at", "records", "opened")

    def __init__(self, name: str):
        self.name = name
        self.rf = None
        self.at = -1

    def __enter__(self):
        if _profiler_on():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if _recording:
            # reset() rebinds both lists: an open span closes into its own
            self.records, self.opened = _records, _open
            i = len(_records)
            parent = _open[-1] if _open else None
            root = _open[0] if _open else i
            _open.append(i)
            self.at = i
            _records.append((self.name, time.perf_counter_ns(), None, parent, root))
        return self

    def __exit__(self, *exc):
        if self.at >= 0:
            t1 = time.perf_counter_ns()
            name, t0, _, parent, root = self.records[self.at]
            self.records[self.at] = (name, t0, t1, parent, root)
            self.opened.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking ``name`` on the recorder and on a running
    profiler's timeline; a shared no-op while both are off."""
    if _recording or _profiler_on():
        return _Span(name)
    return _OFF


def enable(on: bool = True) -> None:
    """Start (True) or stop (False) recording spans; recorded ones stay."""
    global _recording
    _recording = bool(on)


def enabled() -> bool:
    return _recording


def spans() -> list:
    """The recorded spans, ``(name, t0_ns, t1_ns, parent, root)`` each, in
    the order they opened (``t1_ns`` None while a span is open)."""
    return list(_records)


def reset() -> None:
    """Forget the recorded spans."""
    global _records, _open
    _records, _open = [], []


def self_ns(records: list) -> list:
    """Each span's self time in ns: its duration less the part its
    children cover (a child lies inside its parent and beside its
    siblings); None for a span still open.  ``records`` as ``spans()``."""
    own = [None if t1 is None else t1 - t0 for _, t0, t1, _, _ in records]
    for _, t0, t1, parent, _ in records:
        if parent is not None and t1 is not None and own[parent] is not None:
            own[parent] -= t1 - t0
    return own


def kernel_wrapper(fn):
    """Mark ``fn`` a kernel wrapper: its whole body, the plain branch and
    the launching one, runs inside the span ``asp.kernel.<name>``, and its
    ``.launches`` is one of ``counters()``."""
    name = f"asp.kernel.{fn.__name__}"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _recording or _profiler_on():
            with _Span(name):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)

    _wrappers.append(wrapped)
    return wrapped


def count_upload(nbytes: int) -> None:
    """One host table copied to a CUDA device (``utils.device.upload``)."""
    _counts["uploads"] += 1
    _counts["upload_bytes"] += nbytes


def counters(device=None) -> dict:
    """A snapshot: ``launches.<wrapper>`` of every kernel wrapper imported
    so far, ``uploads`` and ``upload_bytes``, and on a CUDA ``device`` that
    has been used, ``allocations`` (the caching allocator's
    ``allocation.all.allocated``)."""
    out = {f"launches.{w.__name__}": w.launches for w in _wrappers}
    out.update(_counts)
    if device is not None and torch.device(device).type == "cuda" \
            and torch.cuda.is_initialized():
        out["allocations"] = torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)
    return out


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
