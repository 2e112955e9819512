"""The only module of the benchmark that imports the program under test,
``audiosignalprocess_tpu_torch``: the system's entry points, nothing of
its arithmetic.  Entries reach the program through these functions."""

from __future__ import annotations

import torch


def build_chain(stages: list[dict]):
    """``pipeline.Chain`` from a configuration's stage dictionaries, taps
    designed by the benchmark."""
    from audiosignalprocess_tpu_torch.pipeline import Chain

    return Chain.from_params([dict(s) for s in stages])


def warm_library(device: torch.device) -> None:
    """Build (first run in a checkout) and load the kernels' library."""
    if device.type == "cuda":
        from audiosignalprocess_tpu_torch.kernels import _build

        _build.load()


def join_group(init_method: str, world: int, rank: int, device: torch.device) -> None:
    """This process's place in the process group: NCCL on the card, gloo
    on the CPU."""
    from audiosignalprocess_tpu_torch.parallel import initialize

    initialize(init_method, world, rank, "nccl" if device.type == "cuda" else "gloo",
               device)


def sharded(chain, ranks: int):
    """(mesh, the sharded whole-file call of ``chain`` on a (1, ranks)
    mesh of time shards)."""
    from audiosignalprocess_tpu_torch.parallel import make_mesh, sharded_chain

    mesh = make_mesh(channel=1, time=ranks)
    return mesh, sharded_chain(mesh, chain)


def gather(y: torch.Tensor, mesh) -> torch.Tensor:
    """The whole output from every rank's block (every rank calls it)."""
    from audiosignalprocess_tpu_torch.parallel import gather_audio

    return gather_audio(y, mesh)
