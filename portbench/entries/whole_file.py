"""Whole files through ``Chain.full_flush``, back to back.

Set-up makes a pool of ``pool`` distinct recordings of ``stack`` x the
configuration's channels and ``seconds`` seconds on the device from the
seed, builds the chain and runs it once on each of two files (every call
has the same shape).  The window calls ``full_flush`` on the pool's files
in turn, outputs kept on the device, at most ``in_flight`` calls queued
ahead of the host.  ``file_samples_per_s``: the input samples of every
call, over the window's time up to the last call's completion.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from portbench import program, signal
from portbench.compare import Item
from portbench.harness import Mark, Outcome, Reservoir
from portbench.reference import out_len


def run(ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    channels = cfg["channels"] * tr["stack"]
    n = int(round(tr["seconds"] * cfg["rate_in"]))
    pool = [signal.make(ctx.seed, f, 0, channels, 0, n, cfg["rate_in"], tr["signal"],
                        ctx.device) for f in range(tr["pool"])]
    ctx.note("inputs made")
    program.warm_library(ctx.device)
    ctx.note("library loaded")
    chain = program.build_chain(ctx.stages)
    for x in pool[:2]:
        chain.full_flush(x)
    keep = Reservoir(ctx.seed, tr["sample"])
    marks: deque = deque()
    tracer = ctx.tracer
    t0 = ctx.start_window()
    deadline = t0 + ctx.seconds
    i = 0
    while ctx.running(deadline, i):
        tracer.tick(i)
        with tracer.span("Chain.full_flush"):
            s0 = time.perf_counter()
            y = chain.full_flush(pool[i % len(pool)])
            ctx.span(i, time.perf_counter() - s0)
        keep.offer(i, y)
        del y
        marks.append(Mark(ctx.device))
        if len(marks) >= tr["in_flight"]:
            with tracer.span("wait for a call"):
                marks.popleft().wait()
        i += 1
    while marks:
        marks.popleft().wait()
    t1 = time.perf_counter()
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    traced = sum(1 for k in range(i) if tracer.counted(k))
    m = out_len(ctx.stages, n)
    items = [Item(y=y, make_x=lambda f=k % len(pool): pool[f], keep=(0, m),
                  ref_key=k % len(pool), label=f"call {k}") for k, y in keep.kept]
    return Outcome(attempted=i, metrics={"file_samples_per_s": i * channels * n / (t1 - t0)},
                   items=items, memory_peak_bytes=peak,
                   unit_work=ctx.work.call_work(ctx.stages[0], channels, n),
                   traces=[tracer.summarize(traced)])


def control_items(ctx) -> list:
    """Each file of the pool, for the control (``portbench.control``)."""
    cfg, tr = ctx.config, ctx.traffic
    channels = cfg["channels"] * tr["stack"]
    n = int(round(tr["seconds"] * cfg["rate_in"]))
    m = out_len(ctx.stages, n)

    def make(f: int):
        return lambda: signal.make(ctx.seed, f, 0, channels, 0, n, cfg["rate_in"],
                                   tr["signal"], ctx.device)

    return [Item(y=None, make_x=make(f), keep=(0, m), ref_key=f, label=f"file {f}")
            for f in range(tr["pool"])]
