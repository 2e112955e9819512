"""The program's span recorder (``utils/profiling``) in a ``--trace 0``
run: the end-to-end metrics are measured with both of its sinks off, so
such a run never enables the recorder and never opens a span."""

import pytest

from portbench import harness
from portbench.tests.conftest import tiny_spec


@pytest.mark.parametrize("cell", ["fir_gate_48k.file", "config5_128ch.stream",
                                  "fir_gate_48k.stream512"])
def test_an_untraced_run_never_touches_the_recorder(cell, monkeypatch):
    import torch

    from audiosignalprocess_tpu_torch.utils import profiling

    def refuse(*args, **kwargs):
        raise AssertionError("a --trace 0 run reached the span recorder")

    profiling.enable(False)
    profiling.reset()
    monkeypatch.setattr(profiling, "enable", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    res, lines = harness.run_cell(tiny_spec(cell), 2**31 + 13, 0.5, False,
                                  torch.device("cpu"))
    assert res["correct"] and res["attempted"] > 0, lines
    assert not profiling.enabled() and profiling.spans() == []
