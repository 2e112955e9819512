"""Faults planted underneath a run's timed path, for the check that
``correct`` comes out false.  Each function patches the program where
the fault would live and returns the undo.  A run names one in its spec
(``spec["patch"] = "portbench.tests.faults:<name>"``) so that the ranks
of a sharded run, started fresh, plant it too."""

from __future__ import annotations

import torch


def _patch(owner, name: str, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def _undo_all(undos):
    def undo():
        for u in reversed(undos):
            u()
    return undo


def state_unchanged():
    """``Chain.step`` hands back the carry it was given."""
    from audiosignalprocess_tpu_torch import pipeline

    step = pipeline.Chain.step

    def broken(self, states, x):
        return states, step(self, states, x)[1]

    return _patch(pipeline.Chain, "step", broken)


def _half(y: torch.Tensor) -> torch.Tensor:
    """Half of the channels left out, the mean of the rest in their place."""
    y = y.clone()
    h = y.shape[0] // 2
    y[h:] = y[:h].mean(dim=0)
    return y


def _negate_first(y: torch.Tensor) -> torch.Tensor:
    """One answer altered where it is produced: channel 0 negated."""
    y = y.clone()
    y[0] = -y[0]
    return y


def _outputs(alter):
    from audiosignalprocess_tpu_torch import parallel, pipeline

    step, full_flush, sharded = (pipeline.Chain.step, pipeline.Chain.full_flush,
                                 parallel.sharded_chain)

    def broken_step(self, states, x):
        states, y = step(self, states, x)
        return states, alter(y)

    def broken_flush(self, x):
        return alter(full_flush(self, x))

    def broken_sharded(mesh, chain):
        call = sharded(mesh, chain)
        return lambda x: alter(call(x))

    return _undo_all([_patch(pipeline.Chain, "step", broken_step),
                      _patch(pipeline.Chain, "full_flush", broken_flush),
                      _patch(parallel, "sharded_chain", broken_sharded)])


def half_batch():
    return _outputs(_half)


def answer_altered():
    return _outputs(_negate_first)


def no_exchange():
    """The exchange between ranks left out: every halo zero, no spill
    added, each rank's own noise floor."""
    from audiosignalprocess_tpu_torch.parallel import sharded

    def left(x, halo, mesh):
        return torch.cat([x.new_zeros(x.shape[:-1] + (halo,)), x], dim=-1) if halo else x

    def right(x, halo, mesh):
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (halo,))], dim=-1) if halo else x

    return _undo_all([_patch(sharded, "halo_left", left), _patch(sharded, "halo_right", right),
                      _patch(sharded, "send_right_add", lambda tail, head, mesh: head),
                      _patch(sharded, "broadcast_first", lambda x, mesh: x)])
