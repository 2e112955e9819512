"""Halo exchange along the time axis, and the row collectives.

Overlap-save and the resampler need the previous shard's last samples;
frame assembly needs the next shard's first nfft-hop samples.  Both are
single-hop neighbour transfers within the rank's row (the JAX package's
``lax.ppermute`` inside ``shard_map``), here one
``batch_isend_irecv`` over the mesh's time group.  Edge shards get zeros
(cold start, end of stream), matching the oracle's causal conventions.
A time axis of one shard skips communication.

Transport: gloo sends and receives host tensors only, so under gloo a
CUDA tensor goes through host memory for every transfer and collective
here.  The choice depends on the backend's name alone (it never reacts
to an error), and the arithmetic stays on the tensor's device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from audiosignalprocess_tpu_torch.utils.profiling import span
from audiosignalprocess_tpu_torch.utils.validate import check


def _staged(x: torch.Tensor, backend: str | None) -> torch.Tensor:
    """A contiguous copy of ``x`` the backend can send: on the host when
    gloo must carry a CUDA tensor."""
    if backend == "gloo" and x.is_cuda:
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def _shift(x: torch.Tensor, step: int, mesh) -> torch.Tensor:
    """Each time shard sends ``x`` to the shard ``step`` to its right and
    returns what the shard ``step`` to its left sent (zeros where there is
    none)."""
    with span("asp.collective.shift"):
        t, n = mesh.t, mesh.time
        buf = _staged(x, mesh.backend)
        recv = torch.zeros_like(buf)
        ops = []
        if 0 <= t + step < n:
            ops.append(dist.P2POp(dist.isend, buf, mesh.peer(t + step), mesh.time_group))
        if 0 <= t - step < n:
            ops.append(dist.P2POp(dist.irecv, recv, mesh.peer(t - step), mesh.time_group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device)


def halo_left(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """Prepend the left neighbour's last ``halo`` samples: (..., L) ->
    (..., halo + L).  Shard 0 receives zeros (causal cold start).  The
    halo must fit in one shard: the exchange is single-hop."""
    check(0 <= halo <= x.shape[-1], f"halo {halo} exceeds local shard length "
          f"{x.shape[-1]} (single-hop halo exchange)")
    if halo == 0:
        return x
    if mesh.time == 1:
        return torch.cat([x.new_zeros(x.shape[:-1] + (halo,)), x], dim=-1)
    return torch.cat([_shift(x[..., -halo:], 1, mesh), x], dim=-1)


def halo_right(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """Append the right neighbour's first ``halo`` samples: (..., L) ->
    (..., L + halo).  The last shard receives zeros (stream end)."""
    check(0 <= halo <= x.shape[-1], f"halo {halo} exceeds local shard length "
          f"{x.shape[-1]} (single-hop halo exchange)")
    if halo == 0:
        return x
    if mesh.time == 1:
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (halo,))], dim=-1)
    return torch.cat([x, _shift(x[..., :halo], -1, mesh)], dim=-1)


def send_right_add(tail: torch.Tensor, head: torch.Tensor, mesh) -> torch.Tensor:
    """Overlap-add boundary fix-up: add the left neighbour's ``tail`` into
    this shard's ``head`` (same length).  The sharded ISTFT's OLA spills
    nfft-hop samples into the next shard."""
    if mesh.time == 1:
        return head
    return head + _shift(tail, 1, mesh)


def broadcast_first(x: torch.Tensor, mesh) -> torch.Tensor:
    """Time shard 0's ``x`` on every shard of the row (the JAX package's
    psum of values that are zero off shard 0)."""
    if mesh.time == 1:
        return x
    with span("asp.collective.broadcast_first"):
        buf = _staged(x, mesh.backend)
        dist.broadcast(buf, src=mesh.peer(0), group=mesh.time_group)
        return buf.to(x.device)


def all_gather(x: torch.Tensor, group, backend: str | None) -> list[torch.Tensor]:
    """Every member's ``x`` from the group, in group rank order."""
    with span("asp.collective.all_gather"):
        buf = _staged(x, backend)
        parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf, group=group)
        return [p.to(x.device) for p in parts]
