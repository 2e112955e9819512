"""Process-group bring-up for the sharded programs.

The JAX package's ``parallel/launch.py`` brings up jax.distributed and
leaves the transport to XLA.  Here the comm layer is torch.distributed:
NCCL between GPUs, gloo between CPU processes (and, when asked for by
name, between processes that share one GPU; ``parallel/halo`` stages CUDA
tensors through host memory for it).  ``spawn_local`` runs a function in
a group of fresh processes on this host, the counterpart of
``tools/launch_multihost.py --simulate``.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from audiosignalprocess_tpu_torch.utils.validate import check

log = logging.getLogger("asp_torch.launch")

COLLECTIVE_TIMEOUT_S = 120.0
"""A collective or transfer that waits longer than this raises."""


def _torchrun_env() -> bool:
    return "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device: str | torch.device = "cuda") -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    Does nothing for a single process with no rendezvous configured (no
    ``init_method`` and no torchrun environment), as the JAX package's
    does, and nothing when the group exists already.  Under torchrun the
    rendezvous, world size and rank come from the environment.
    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo``
    for the CPU; gloo with CUDA tensors runs only when named.  With NCCL
    each process takes the GPU of its local rank.
    """
    if dist.is_initialized():
        return
    if init_method is None and not _torchrun_env():
        check(world_size in (None, 1),
              f"world_size={world_size} needs an init_method (or torchrun's environment)")
        log.info("single process; no process group")
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check(backend in ("nccl", "gloo"), f"backend must be 'nccl' or 'gloo', got {backend!r}")
    check(backend == "gloo" or dev.type == "cuda", "nccl needs a CUDA device")
    if init_method is None:
        init_method = "env://"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size or -1,
                            rank=-1 if rank is None else rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    log.info("process group: rank %d of %d, %s", dist.get_rank(), dist.get_world_size(),
             backend)


def warmup(fn, *args) -> None:
    """Run ``fn(*args)`` once and wait for the device and every rank: checks
    that the kernels load and the transfers connect before timing."""
    fn(*args)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()


def _run_rank(fn, rank, world, backend, init_method, device, args_path, results) -> None:
    """One process of ``spawn_local``: join the group, run fn, report."""
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        initialize(init_method, world, rank, backend, device)
        results.put((rank, True, fn(rank, world, *args)))
    except Exception:  # noqa: BLE001 -- reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _claim(device: str | torch.device) -> None:
    """Touch ``device`` once: without a GPU a CUDA device raises torch's
    own error here, before any rank starts (as the api one-shots do)."""
    torch.empty(0, device=device)


def spawn_local(fn, world: int, backend: str = "gloo", args: tuple = (),
                device: str = "cuda", timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes on this
    host (torch.multiprocessing, start method ``spawn``), joined in one
    process group over a ``file://`` store in a temporary directory (no
    TCP port, so several groups may run at once).  ``fn`` must be
    importable by name and return picklable values (numpy arrays, not
    tensors).  Returns the results in rank order.

    ``device`` reaches each rank's ``initialize``: the GPU unless the
    caller asks for the CPU (``device="cpu"``); without a GPU the default
    raises torch's own error and starts no process.  A rank that raises
    or dies, or a group that outlives ``timeout_s``, raises here, after
    every process of the group is stopped.
    """
    _claim(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="asp_rdzv_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        # the arguments go through a file: through the start pipe the parent
        # would wait for each child to import torch before starting the next
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        procs = [ctx.Process(target=_run_rank, daemon=True,
                             args=(fn, rank, world, backend, init_method, device, args_path,
                                   results))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {world} died "
                                           f"(exit code {procs[dead[0]].exitcode})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world - len(out)} of {world} ranks still "
                                           f"running after {timeout_s} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
