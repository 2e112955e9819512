"""The comparison that decides ``correct``.

An ``Item`` is one output the timed path produced (a whole-file call, a
streamed block, a gathered sharded call) with what the reference needs
to compute the same output: the input the program was given (or the
stretch of the stream that produced the block), the stream's gate floors
where the item is a segment of a stream, and which samples of the
reference's whole-file output the item holds.  The number compared is
``max_rel_err``: over the items, the largest ||y - ref|| / ||ref||, each
norm over every channel and sample of the item, the reference in float64.

The control puts the reference in the program's place, computed with
every stage's input, taps, spectrum and output rounded to bfloat16
(``control=True``): the precision below the configuration's float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from portbench.reference import chain_floors, run_chain


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back (the control's storage precision)."""
    return t.to(torch.bfloat16).to(t.dtype)


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclass
class Item:
    """One output of the timed path and how to recompute it."""

    y: torch.Tensor | None  # the program's output (channels, m); None for the control
    make_x: Callable[[], torch.Tensor]  # the input stretch, float32 (channels, n)
    keep: tuple[int, int]  # [a, b) of the reference output that y holds
    ref_key: object  # items with the same key share one reference run
    make_head: Callable[[], torch.Tensor] | None = None  # a stream's first samples
    label: str = ""


def _floors(stages, item: Item, rows: slice, q) -> list | None:
    if item.make_head is None:
        return None
    head = item.make_head()[rows].to(torch.float64)
    return chain_floors(stages, head, q)


def compare(stages: list[dict], items: list[Item], rows: int,
            control: bool = False) -> dict:
    """Hold every item to the float64 reference, ``rows`` channels at a
    time.  Returns {label: rel_err} and ``max_rel_err``.  With
    ``control`` the item's output is the reference's own in bfloat16."""
    groups: dict = {}
    for it in items:
        groups.setdefault(it.ref_key, []).append(it)
    err = {id(it): [0.0, 0.0] for it in items}
    bad = set()
    for group in groups.values():
        first = group[0]
        x = first.make_x()
        channels = x.shape[0]
        for it in group:
            if it.y is not None and (it.y.shape[0] != channels
                                     or it.y.shape[1] != it.keep[1] - it.keep[0]):
                bad.add(id(it))
        for r0 in range(0, channels, rows):
            sl = slice(r0, min(channels, r0 + rows))
            x64 = x[sl].to(torch.float64)
            ref, _ = run_chain(stages, x64, _floors(stages, first, sl, exact))
            ref = ref[..., first.keep[0] : first.keep[1]]
            if control:
                got, _ = run_chain(stages, x64, _floors(stages, first, sl, bf16), bf16)
                got = got[..., first.keep[0] : first.keep[1]]
            for it in group:
                if id(it) in bad:
                    continue
                y = got if control else it.y[sl].to(ref.device)
                d = y.to(torch.float64) - ref
                err[id(it)][0] += float((d * d).sum())
                err[id(it)][1] += float((ref * ref).sum())
            del x64, ref
        del x
    out = {}
    for it in items:
        e, r = err[id(it)]
        ok = id(it) not in bad and r > 0.0 and math.isfinite(e)
        out[it.label] = math.sqrt(e / r) if ok else math.inf
    out["max_rel_err"] = max(out.values()) if out else math.inf
    return out
