"""The (channel, time) layout of the process group's ranks.

As in the JAX package's ``parallel/mesh.py``, the parallelism is
DP(channel) x SP(time): channel blocks are independent; a long recording
is cut into time blocks whose neighbours exchange halos (``halo.py``).
Ranks are laid out as the JAX mesh lays out devices, time innermost:
rank = c*time + t.  Each rank holds one (channels/channel,
samples/time) block of the planar signal.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from audiosignalprocess_tpu_torch.utils.validate import check


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (channel, time) mesh and its two groups:
    ``time_group``, the ranks of its channel block (its row, which the
    halos and the row collectives run over), and ``channel_group``, the
    ranks of its time block (its column).  A group of one rank is None."""

    channel: int
    time: int
    rank: int = 0
    backend: str | None = None
    time_group: object = None
    channel_group: object = None

    @property
    def c(self) -> int:
        """This rank's channel block."""
        return self.rank // self.time

    @property
    def t(self) -> int:
        """This rank's time block."""
        return self.rank % self.time

    def peer(self, t: int) -> int:
        """The global rank of time block ``t`` in this rank's row."""
        return self.c * self.time + t


def make_mesh(channel: int = 1, time: int = 1) -> Mesh:
    """A (channel, time) mesh over every rank of the process group.

    A 1x1 mesh needs no process group.  Otherwise the group holds exactly
    channel*time ranks, and every rank must call this with the same
    shape: each creates every row and column group, in the same order
    (``new_group`` is collective over the whole group).
    """
    need = channel * time
    check(channel >= 1 and time >= 1, f"mesh ({channel}, {time}) must be positive")
    if not dist.is_initialized():
        check(need == 1, f"a {channel}x{time} mesh needs {need} processes: "
                         f"call parallel.initialize first")
        return Mesh(1, 1)
    world = dist.get_world_size()
    check(world == need, f"a {channel}x{time} mesh needs {need} ranks, the group has {world}")
    rank = dist.get_rank()
    rows = cols = None
    if time > 1:
        for c in range(channel):
            g = dist.new_group([c * time + t for t in range(time)])
            rows = g if c == rank // time else rows
    if channel > 1:
        for t in range(time):
            g = dist.new_group([c * time + t for c in range(channel)])
            cols = g if t == rank % time else cols
    return Mesh(channel, time, rank, dist.get_backend(), rows, cols)


def shard_audio(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (channels/channel, samples/time) block of the planar
    (channels, samples) signal ``x``."""
    c, n = x.shape[-2], x.shape[-1]
    check(c % mesh.channel == 0 and n % mesh.time == 0,
          f"signal {tuple(x.shape)} does not split over a {mesh.channel}x{mesh.time} mesh")
    cb, nb = c // mesh.channel, n // mesh.time
    return x[..., mesh.c * cb : (mesh.c + 1) * cb, mesh.t * nb : (mesh.t + 1) * nb].contiguous()


def shard_channels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's channel block with every sample (the JAX package's
    ``channel_sharding``: P('channel', None)), for channel-parallel
    streaming."""
    c = x.shape[-2]
    check(c % mesh.channel == 0, f"{c} channels do not split over {mesh.channel} blocks")
    cb = c // mesh.channel
    return x[..., mesh.c * cb : (mesh.c + 1) * cb, :].contiguous()


def gather_audio(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole planar signal from every rank's block ``y`` (channels on
    axis -2, samples on -1), on every rank: gathered along the row, then
    along the column."""
    from audiosignalprocess_tpu_torch.parallel.halo import all_gather

    if mesh.time > 1:
        y = torch.cat(all_gather(y, mesh.time_group, mesh.backend), dim=-1)
    if mesh.channel > 1:
        y = torch.cat(all_gather(y, mesh.channel_group, mesh.backend), dim=-2)
    return y
