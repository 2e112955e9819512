"""One continuous stream through ``Chain.step``, block by block.

Set-up makes ``pool_seconds`` of a ``stack`` x channels recording on the
device from the seed (whole blocks of ``block`` input frames), builds the
chain and warms the step on a throwaway carry.  The window steps the
stream on the pool's blocks, cycled, the carry never reset, with at most
``in_flight`` blocks queued: after issuing block k the host waits for
block k - in_flight + 1.

- ``stream_samples_per_s``: input samples of every block, over the
  window's time up to the last block's completion;
- ``block_p95_ms``: over every block of the window, the host time from
  calling ``Chain.step`` to seeing the block's completion.

Each sampled block is checked against the reference's whole-file output
of the stretch of the stream that ends with it (enough earlier blocks to
cover every filter's and frame's reach), under the floors the stream took
from its first frames.
"""

from __future__ import annotations

import math
import random
import time
from collections import deque

import numpy as np
import torch

from portbench import program, signal
from portbench.compare import Item
from portbench.harness import Mark, Outcome, Reservoir
from portbench.reference import out_len, stream_latency

WARM_BLOCKS = 3


def run(ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    channels = cfg["channels"] * tr["stack"]
    b = tr["block"]
    nblk = int(tr["pool_seconds"] * cfg["rate_in"]) // b
    pool = signal.make(ctx.seed, 0, 0, channels, 0, nblk * b, cfg["rate_in"], tr["signal"],
                       ctx.device)
    ctx.note("inputs made")
    program.warm_library(ctx.device)
    ctx.note("library loaded")
    chain = program.build_chain(ctx.stages)
    state = chain.init_state((channels,), b, torch.float32, ctx.device)
    for k in range(WARM_BLOCKS):
        j = k % nblk
        state, _ = chain.step(state, pool[:, j * b : (j + 1) * b])
    state = chain.init_state((channels,), b, torch.float32, ctx.device)
    keep = Reservoir(ctx.seed, tr["sample"])
    queued: deque = deque()
    lat = []
    tracer = ctx.tracer
    t0 = ctx.start_window()
    deadline = t0 + ctx.seconds
    i = 0
    while ctx.running(deadline, i):
        tracer.tick(i)
        j = i % nblk
        with tracer.span("Chain.step"):
            s0 = time.perf_counter()
            state, y = chain.step(state, pool[:, j * b : (j + 1) * b])
            ctx.span(i, time.perf_counter() - s0)
        keep.offer(i, y)
        del y
        queued.append((s0, Mark(ctx.device)))
        if len(queued) >= tr["in_flight"]:
            issued, mark = queued.popleft()
            with tracer.span("wait for a block"):
                mark.wait()
            lat.append(time.perf_counter() - issued)
        i += 1
    while queued:
        issued, mark = queued.popleft()
        mark.wait()
        lat.append(time.perf_counter() - issued)
    t1 = time.perf_counter()
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    traced = sum(1 for k in range(i) if tracer.counted(k))
    del state
    items = _items(ctx, pool, nblk, b, keep.kept)
    return Outcome(attempted=i,
                   metrics={"stream_samples_per_s": i * channels * b / (t1 - t0),
                            "block_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                   items=items, memory_peak_bytes=peak,
                   unit_work=ctx.work.block_work(ctx.stages[0], channels, b),
                   traces=[tracer.summarize(traced)])


def _items(ctx, pool, nblk: int, b: int, kept: list) -> list:
    """The sampled blocks as stretches of the stream for the reference."""
    ob = out_len(ctx.stages, b)
    lat = stream_latency(ctx.stages)
    first = ctx.stages[0]
    reach = lat + 2 * first["nfft"] + 512  # every filter's and frame's reach, with room
    margin = math.ceil(reach / ob)
    head_blocks = math.ceil((reach + lat) / ob) + 1

    def blocks(s0: int, k: int):
        return lambda: torch.cat([pool[:, (j % nblk) * b : (j % nblk + 1) * b]
                                  for j in range(s0, k + 1)], dim=-1)

    head = blocks(0, head_blocks - 1)
    items = []
    for k, y in kept:
        s0 = max(0, k - margin)
        a = (k - s0) * ob - lat
        items.append(Item(y=None if y is None else y[:, max(0, -a):], make_x=blocks(s0, k),
                          keep=(max(0, a), a + ob), ref_key=k, make_head=head,
                          label=f"block {k}"))
    return items


CONTROL_BLOCKS = 20000
"""The control's blocks are drawn from the first this many of a stream."""


def control_items(ctx) -> list:
    """Blocks drawn from the seed, for the control (``portbench.control``)."""
    cfg, tr = ctx.config, ctx.traffic
    channels = cfg["channels"] * tr["stack"]
    b = tr["block"]
    nblk = int(tr["pool_seconds"] * cfg["rate_in"]) // b
    pool = signal.make(ctx.seed, 0, 0, channels, 0, nblk * b, cfg["rate_in"], tr["signal"],
                       ctx.device)
    ks = random.Random(signal.derive(ctx.seed, "control")).sample(range(CONTROL_BLOCKS),
                                                                  tr["sample"])
    return _items(ctx, pool, nblk, b, [(k, None) for k in sorted(ks)])
