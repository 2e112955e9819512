"""The correctness check has to fail what it must: the control (the
reference in bfloat16 put in the program's place) and each fault a cell
can have, planted underneath a tiny run on the CPU (the look for a card
skipped): the carry handed back unchanged, half of the channels left
out, the exchange between ranks left out, one answer altered."""

import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import TINY, tiny_spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_fails_on_three_seeds(cell):
    spec = tiny_spec(cell)
    limit = spec["limits"]["max_rel_err"]
    for row in control.readings(spec, [2**31 + 21, 22, 23], CPU):
        assert row["max_rel_err"] > limit, row


FAULTS = [(cell, fault) for cell in sorted(TINY)
          for fault in (["half_batch", "answer_altered"]
                        + (["state_unchanged"] if ".stream" in cell else [])
                        + (["no_exchange"] if "sharded" in cell else []))]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    res, lines = harness.run_cell(tiny_spec(cell, fault), 2**31 + 31, 3.0, False, CPU)
    assert res["attempted"] >= 3, lines
    assert not res["correct"], lines
    assert res["checks"]["max_rel_err"]["value"] > res["checks"]["max_rel_err"]["limit"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", ["fir_gate_48k.file", "config5_128ch.stream",
                                  "fir_gate_48k.stream512"])
def test_the_control_fails_at_the_cells_size_on_the_card(cuda_device, cell):
    spec = harness.cell_spec(cell)
    for row in control.readings(spec, [2**31 + 41, 42, 43], cuda_device):
        assert row["max_rel_err"] > spec["limits"]["max_rel_err"], row
