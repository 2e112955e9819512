"""Long recordings, ``stack`` of them side by side as channels,
time-sharded over ``ranks`` processes, one card each, through
``parallel.sharded_chain``, calls back to back.

This process is rank 0; it starts ranks 1 to ``ranks - 1`` (``spawn``),
and every rank joins one process group (NCCL on the cards, gloo on the
CPU) over ``tcp://127.0.0.1:<free port>``.  Each rank makes its own time
shard of the ``frames``-frame recordings on its device from the seed,
builds the chain and its sharded call on a (1, ranks) mesh, and warms it.
Rank 0 times ``calibrate_calls`` calls and fixes the window's call count
from them, so every rank runs the same calls.  After the window each
sampled call's output is gathered (``parallel.gather_audio``) into rank
0's host memory, and rank 0 holds it to the reference of the whole recording.

``file_samples_per_s``: the recordings' input samples, all ranks, times
the calls, over rank 0's window up to the barrier after the last call.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import sys
import time
import traceback
from collections import deque

import torch

from portbench import harness, program, signal
from portbench.compare import Item
from portbench.harness import Mark, Outcome, Reservoir
from portbench.reference import out_len

REPORT_TIMEOUT_S = 300.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(kind: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")


def _shard(ctx, rank: int, world: int) -> torch.Tensor:
    cfg, tr = ctx.config, ctx.traffic
    n_r = tr["frames"] // world
    return signal.make(ctx.seed, 0, rank, cfg["channels"] * tr["stack"], rank * n_r, n_r,
                       cfg["rate_in"], tr["signal"], ctx.device)


def _rank_run(ctx, init: str, world: int) -> dict:
    """One rank's set-up, window and gather."""
    import torch.distributed as dist

    tr = ctx.traffic
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    program.warm_library(ctx.device)
    ctx.note("library loaded")
    program.join_group(init, world, ctx.rank, ctx.device)
    ctx.note("group joined")
    x = _shard(ctx, ctx.rank, world)
    ctx.note("inputs made")
    mesh, call = program.sharded(program.build_chain(ctx.stages), world)
    for _ in range(2):
        call(x)
    ctx.sync()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(tr["calibrate_calls"]):
        call(x)
    ctx.sync()
    dist.barrier()
    calls = [max(1, round(ctx.seconds * tr["calibrate_calls"] / (time.perf_counter() - t)))]
    if ctx.trace:  # a traced run completes its sub-window
        calls[0] = max(calls[0], tr["trace_from"] + tr["trace_units"] + 1)
    dist.broadcast_object_list(calls, src=0)
    calls = calls[0]
    keep = Reservoir(ctx.seed, tr["sample"])
    marks: deque = deque()
    tracer = ctx.tracer
    dist.barrier()
    t0 = ctx.start_window()
    for i in range(calls):
        tracer.tick(i)
        with tracer.span("sharded_chain"):
            s0 = time.perf_counter()
            y = call(x)
            ctx.span(i, time.perf_counter() - s0)
        keep.offer(i, y)
        del y
        marks.append(Mark(ctx.device))
        if len(marks) >= 2:
            with tracer.span("wait for a call"):
                marks.popleft().wait()
    while marks:
        marks.popleft().wait()
    dist.barrier()
    ctx.sync()
    t1 = time.perf_counter()
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    traced = sum(1 for k in range(calls) if tracer.counted(k))
    del x, call
    # a gathered call is the whole recording: rank 0 keeps it in host
    # memory, so the card holds the reference's working set next
    gathered = []
    while keep.kept:
        k, y = keep.kept.pop(0)
        whole_y = program.gather(y, mesh)
        del y
        if ctx.rank == 0:
            gathered.append((k, whole_y.cpu()))
        del whole_y
    ctx.sync()
    dist.barrier()
    dist.destroy_process_group()
    return {"calls": calls, "seconds": t1 - t0, "peak": peak,
            "trace": tracer.summarize(traced), "gathered": gathered}


def worker(spec: dict, seed: int, seconds: float, trace: bool, rank: int, world: int,
           init: str, kind: str, reports) -> None:
    """Ranks 1 and up: run, then report to rank 0 (no tensors)."""
    torch.set_num_threads(1)
    try:
        ctx = harness.make_ctx(spec, seed, seconds, trace, _device(kind, rank), rank)
        got = _rank_run(ctx, init, world)
        reports.put({"rank": rank, "peak": got["peak"], "trace": got["trace"],
                     "forbidden": harness.forbidden_modules(), "error": None})
    except Exception:  # noqa: BLE001 -- reported to rank 0, which fails the run
        reports.put({"rank": rank, "error": traceback.format_exc()})


def run(ctx) -> Outcome:
    """Rank 0: start the other ranks, run, collect their reports."""
    tr = ctx.traffic
    world = tr["ranks"]
    program.warm_library(ctx.device)  # built once, before the ranks start
    init = f"tcp://127.0.0.1:{_free_port()}"
    mp = multiprocessing.get_context("spawn")
    reports = mp.Queue()
    procs = [mp.Process(target=worker, daemon=True,
                        args=(ctx.cell, ctx.seed, ctx.seconds, ctx.trace, r, world, init,
                              ctx.device.type, reports))
             for r in range(1, world)]
    for p in procs:
        p.start()
    got = None
    try:
        got = _rank_run(ctx, init, world)
        others = []
        deadline = time.monotonic() + REPORT_TIMEOUT_S
        while len(others) < world - 1:
            try:
                others.append(reports.get(timeout=1.0))
            except queue.Empty:
                if time.monotonic() > deadline or any(p.exitcode not in (None, 0)
                                                      for p in procs):
                    raise RuntimeError("a rank ended without reporting") from None
        for p in procs:
            p.join(60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join()
    for rep in sorted(others, key=lambda r: r["rank"]):
        if rep["error"]:
            raise RuntimeError(f"rank {rep['rank']} failed:\n{rep['error']}")
        if rep["forbidden"]:
            print(f"portbench: rank {rep['rank']} loaded {rep['forbidden']}", file=sys.stderr)
            raise RuntimeError("a rank loaded a forbidden module")
    cfg = ctx.config
    channels = cfg["channels"] * tr["stack"]
    n = tr["frames"]
    m = out_len(ctx.stages, n)

    def whole():
        return torch.cat([_shard(ctx, r, world) for r in range(world)], dim=-1)

    items = [Item(y=y, make_x=whole, keep=(0, m), ref_key="recording", label=f"call {k}")
             for k, y in got["gathered"]]
    return Outcome(attempted=got["calls"],
                   metrics={"file_samples_per_s": got["calls"] * channels * n / got["seconds"]},
                   items=items,
                   memory_peak_bytes=max([got["peak"]] + [r["peak"] for r in others]),
                   unit_work=ctx.work.call_work(ctx.stages[0], channels, n // world),
                   traces=[got["trace"]] + [r["trace"] for r in others])


def control_items(ctx) -> list:
    """The whole recording, for the control (``portbench.control``)."""
    world = ctx.traffic["ranks"]
    m = out_len(ctx.stages, ctx.traffic["frames"])
    return [Item(y=None, make_x=lambda: torch.cat([_shard(ctx, r, world) for r in range(world)],
                                                  dim=-1),
                 keep=(0, m), ref_key="recording", label="recording")]
