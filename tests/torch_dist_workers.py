"""Rank bodies of the port's distributed tests (``tests/test_torch_sharded*.py``,
``tests/test_torch_configs.py``, ``tests/test_torch_tracing.py`` and, on the
card, ``tests/test_torch_cuda.py``).

``parallel.spawn_local`` starts fresh processes that import this module
by name, so it imports no jax: a rank loads only torch and the port.
"""

from __future__ import annotations

import torch


def _sharded_op(kind: str, mesh, p: dict):
    """The callable on this rank's block for a case of kind ``kind``."""
    from audiosignalprocess_tpu_torch import parallel as par
    from audiosignalprocess_tpu_torch.parallel.halo import halo_left, halo_right

    if kind == "fir":
        return par.sharded_fir(mesh, p["h"], fused=p.get("fused", False))
    if kind == "overlap_save":
        return par.sharded_overlap_save(mesh, p["h"], p["nfft"], fused=p.get("fused", False))
    if kind == "resample":
        return par.sharded_resample(mesh, p["up"], p["down"], fused=p.get("fused", False))
    if kind == "gate":
        return par.sharded_noise_gate(mesh, **p)
    if kind == "stretch":
        return par.sharded_time_stretch(mesh, **p)
    if kind == "chain":
        p["chain"].build()
        return par.sharded_chain(mesh, p["chain"])
    if kind == "halo_left":
        return lambda v: halo_left(v, p["halo"], mesh)
    if kind == "halo_right":
        return lambda v: halo_right(v, p["halo"], mesh)
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(rank: int, world: int, cases: list, device: str = "cpu") -> dict | None:
    """Run each case ``(name, kind, (channel, time), params, x)`` on its
    mesh: the sharded op on this rank's block of x (on ``device``), the
    output gathered.
    ``kind == "stream"`` streams this rank's channels through
    ``params["chain"]`` instead (channel-parallel streaming).  A case whose
    op raises ValueError on every rank records ("raised", message).
    Returns {name: output} on rank 0 (numpy), None elsewhere."""
    from audiosignalprocess_tpu_torch.parallel import (
        gather_audio, make_mesh, shard_audio, shard_channels,
    )

    meshes, out = {}, {}
    for name, kind, shape, params, x in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        x = torch.as_tensor(x, device=device)
        try:
            if kind == "stream":
                y = params["chain"].stream(shard_channels(x, mesh), params["block"])
            else:
                y = _sharded_op(kind, mesh, dict(params))(shard_audio(x, mesh))
        except ValueError as e:
            out[name] = ("raised", str(e))
            continue
        out[name] = gather_audio(y, mesh).cpu().numpy()
    return out if rank == 0 else None


def record_sharded_chain(rank: int, world: int, chain, x) -> list | None:
    """``parallel.sharded_chain`` of ``chain`` over a (1, world) mesh with
    the span recorder on; returns rank 0's spans, None elsewhere."""
    from audiosignalprocess_tpu_torch.parallel import make_mesh, shard_audio, sharded_chain
    from audiosignalprocess_tpu_torch.utils import profiling

    mesh = make_mesh(1, world)
    chain.build()
    fn = sharded_chain(mesh, chain)
    xs = shard_audio(torch.as_tensor(x), mesh)
    profiling.enable(True)
    try:
        fn(xs)
    finally:
        profiling.enable(False)
    return profiling.spans() if rank == 0 else None


def fail_on(rank: int, world: int, bad_rank: int) -> int:
    """Raise on ``bad_rank`` while the others wait on it in a collective."""
    import torch.distributed as dist

    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def hang_on(rank: int, world: int, bad_rank: int) -> int:
    """Never return on ``bad_rank``."""
    import time

    while rank == bad_rank:
        time.sleep(1.0)
    return rank
