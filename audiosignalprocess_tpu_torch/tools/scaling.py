"""Scaling harness: the sharded config-5 style chain (resample 160/147 ->
64-tap FIR by overlap-save -> STFT gate with 4 noise frames) on (1, n)
meshes of n = 1, 2, 4, ... ranks, one JSON row a size with samples/s and
the scaling efficiency against the first size.

    python -m audiosignalprocess_tpu_torch.tools.scaling --json [--sizes 1,2,4]
    python -m audiosignalprocess_tpu_torch.tools.scaling --json --device cpu --sizes 1,2,4,8
    torchrun --standalone --nproc-per-node=4 -m audiosignalprocess_tpu_torch.tools.scaling --json

Each size starts its own group of ranks (``parallel.spawn_local``);
under torchrun the harness measures the one size of its group.  The
backend is NCCL on the GPUs, a rank a GPU, and gloo on the CPU; NCCL
does not put two ranks on one GPU, so sizes past the GPUs need
``--backend gloo``, whose ranks share the cards and stage every
transfer through the host (that measures the harness, not scaling).
Every rank holds a (channels, per_shard) time shard on a (1, n) mesh and
runs ``parallel.chain_shard_body`` ``iters`` times, each call's input
the last one's plus 1e-12 of its output (a data dependency between
calls); the time is the slowest rank's, by CUDA events on the card (the
host clock on the CPU) around the ``iters`` calls after one untimed
call.  A call launches ``resample_mac``, ``overlap_save_fused`` and
``gate_shard_fused`` on each rank (their plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.parallel import initialize, make_mesh, shard_audio, spawn_local
from audiosignalprocess_tpu_torch.parallel.sharded import chain_shard_body
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRStage, GateStage, ResampleStage
from audiosignalprocess_tpu_torch.utils.validate import check


def build_chain() -> Chain:
    chain = Chain([
        ResampleStage(up=160, down=147, fused=True),
        FIRStage(h=design_fir(64, 0.3), nfft=1024, fused=True),
        GateStage(nfft=1024, hop=256, noise_frames=4, fused=True),
    ])
    chain.build()
    return chain


def bench_mesh(ndev: int, channels: int, per_shard: int, iters: int = 8,
               device: str = "cuda") -> float:
    """Samples/s of the sharded chain on a (1, ndev) mesh: called on every
    rank of a group of ``ndev`` ranks (or on one process with no group)."""
    dev = torch.device(device)
    chain = build_chain()
    mesh = make_mesh(channel=1, time=ndev)
    n = per_shard * ndev
    x = np.random.default_rng(0).standard_normal((channels, n)).astype(np.float32)
    v = shard_audio(torch.as_tensor(x, device=dev), mesh)

    def call(c):
        y = chain_shard_body(chain, c, mesh)
        m = min(y.shape[-1], c.shape[-1])
        return c + 1e-12 * torch.nn.functional.pad(y[:, :m], (0, c.shape[-1] - m))

    v = call(v)  # untimed: the kernels load, the tables upload, the transfers connect
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if dist.is_initialized():
        dist.barrier()
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            v = call(v)
        stop.record()
        torch.cuda.synchronize(dev)
        per_iter = start.elapsed_time(stop) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            v = call(v)
        per_iter = (time.perf_counter() - t0) / iters
    check(bool(torch.isfinite(v).all()), "the sharded chain gave a non-finite output")
    if dist.is_initialized():  # the slowest rank's time
        t = torch.tensor([per_iter], dtype=torch.float64,
                         device=dev if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        per_iter = float(t.item())
    return channels * n / per_iter


def _rank(rank: int, world: int, channels: int, per_shard: int, iters: int,
          device: str) -> float:
    """One rank of a ``spawn_local`` group: its samples/s (every rank's
    is the slowest rank's)."""
    return bench_mesh(world, channels, per_shard, iters, device)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--per-shard", type=int, default=147 * 64)
    p.add_argument("--json", action="store_true")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--sizes", default=None,
                   help="comma list of rank counts (default: powers of 2 up to the GPUs "
                        "under NCCL, 1,2,4,8 under gloo)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, help="nccl for cuda and gloo for cpu by default")
    args = p.parse_args()
    dev = torch.device(args.device)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    shape = (args.channels, args.per_shard, args.iters, args.device)

    if "WORLD_SIZE" in os.environ:  # torchrun: the one size of this group
        initialize(backend=backend, device=args.device)
        sizes = [dist.get_world_size() if dist.is_initialized() else 1]
        measure = lambda nd: bench_mesh(nd, *shape)  # noqa: E731
        show = not dist.is_initialized() or dist.get_rank() == 0
    else:
        gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
        if args.sizes:
            sizes = [int(s) for s in args.sizes.split(",")]
        elif backend == "nccl":
            sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= gpus]
        else:
            sizes = [1, 2, 4, 8]
        check(backend != "nccl" or max(sizes) <= gpus,
              f"NCCL runs one rank a GPU: sizes {sizes} on {gpus} GPUs (--backend gloo shares "
              f"a card between ranks)")
        measure = lambda nd: spawn_local(_rank, nd, backend=backend, args=shape,  # noqa: E731
                                         device=args.device, timeout_s=600.0)[0]
        show = True
    base = None
    for nd in sizes:
        sps = measure(nd)
        if base is None:
            base = sps / nd  # per-rank throughput of the first size
        row = dict(devices=nd, samples_per_s=round(sps, 1),
                   scaling_eff=round(sps / (base * nd), 3), backend=backend,
                   device=args.device)
        if not show:
            continue
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(f"devices={nd:>3}  {sps / 1e6:10.2f} M samples/s  "
                  f"eff={100 * row['scaling_eff']:.1f}%  ({backend} on {args.device})", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
