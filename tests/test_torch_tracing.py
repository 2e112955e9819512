"""The port's spans and counters (``utils/profiling``): the recorder's
nesting and self times, the shared no-op with both sinks off, the
profiler's timeline, the spans of a CPU chain and of a gloo sharded chain,
and the counters.

Imports neither jax nor the JAX package, so the card's case runs where only
PyTorch is installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_tracing.py
"""

import importlib
import json

import numpy as np
import pytest
import torch

import torch_dist_workers
from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.parallel import spawn_local
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRGateStage, ResFIRGateStage
from audiosignalprocess_tpu_torch.utils import profiling
from audiosignalprocess_tpu_torch.utils.device import upload

H = design_fir(64, 0.3)
HE = design_fir(129, 0.05)
GATE = dict(nfft=1024, hop=256, noise_frames=4, fused=True)
KERNEL_MODULES = ("chain_kernel", "fft_kernel", "fir_kernel", "gate_kernel", "os_kernel",
                  "res_chain_kernel", "resample_kernel", "stretch_kernel")


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts with the recorder off and empty, and leaves it so."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _names(records) -> list:
    return [r[0] for r in records]


def _path(records, i) -> list:
    """The names from the root down to span i."""
    out = []
    while i is not None:
        out.append(records[i][0])
        i = records[i][3]
    return out[::-1]


def test_spans_nest_with_parents_and_roots():
    profiling.enable(True)
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    with profiling.span("e"):
        pass
    rs = profiling.spans()
    assert _names(rs) == ["a", "b", "c", "d", "e"]
    assert [r[3] for r in rs] == [None, 0, 1, 0, None]
    assert [r[4] for r in rs] == [0, 0, 0, 0, 4]
    for name, t0, t1, parent, _ in rs:
        assert t0 <= t1
        if parent is not None:
            assert rs[parent][1] <= t0 and t1 <= rs[parent][2], name


def test_recording_stops_and_resets():
    profiling.enable(True)
    with profiling.span("kept"):
        pass
    profiling.enable(False)
    with profiling.span("dropped"):
        pass
    assert _names(profiling.spans()) == ["kept"]
    profiling.reset()
    assert profiling.spans() == []


@pytest.mark.parametrize("records,want", [
    ([("p", 0, 100, None, 0), ("c1", 10, 30, 0, 0), ("c2", 40, 70, 0, 0)], [50, 20, 30]),
    ([("p", 0, 100, None, 0), ("c", 10, 90, 0, 0), ("g", 20, 50, 1, 0)], [20, 50, 30]),
    ([("p", 0, 100, None, 0), ("q", 200, 250, None, 1)], [100, 50]),
    ([("p", 0, None, None, 0), ("c", 10, 30, 0, 0)], [None, 20]),
], ids=["siblings", "grandchild", "two roots", "open parent"])
def test_self_time(records, want):
    assert profiling.self_ns(records) == want


def test_both_sinks_off_record_nothing_and_open_no_record_function(monkeypatch):
    def no_record_function(name):
        raise AssertionError(f"record_function({name!r}) with both sinks off")

    monkeypatch.setattr(profiling, "record_function", no_record_function)
    assert profiling.span("asp.a") is profiling.span("asp.b")
    chain = Chain([FIRGateStage(h=H, **GATE)])
    x = torch.randn(2, 4096)
    state = chain.init_state((2,), 2048, torch.float32, "cpu")
    chain.step(state, x[:, :2048])
    chain.full_flush(x)
    assert not profiling.enabled() and profiling.spans() == []
    with pytest.raises(KeyError):
        with profiling.span("asp.raises"):
            raise KeyError("an exception passes the no-op span")


def test_profiler_trace_holds_the_recorders_spans(tmp_path):
    chain = Chain([FIRGateStage(h=H, **GATE)])
    x = torch.randn(2, 2048)
    state = chain.init_state((2,), 2048, torch.float32, "cpu")
    profiling.enable(True)
    with profiling.trace(str(tmp_path)):
        chain.step(state, x)
    rs = profiling.spans()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    marks = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("asp.")}
    assert set(marks) == set(_names(rs))
    for name, _, _, parent, _ in rs:
        if parent is not None:
            p0, p1 = marks[rs[parent][0]]
            c0, c1 = marks[name]
            assert p0 <= c0 and c1 <= p1, (name, rs[parent][0])


def _cpu_chain(composite: bool) -> Chain:
    if composite:
        return Chain([ResFIRGateStage(up=160, down=147, h=H, env_h=HE, **GATE)])
    return Chain([FIRGateStage(h=H, **GATE)])


@pytest.mark.parametrize("composite,call,want", [
    (False, "step", [["asp.Chain.step", "asp.FIRGateStage.step",
                      "asp.kernel.fir_gate_step_fused"]]),
    (False, "full", [["asp.Chain.full", "asp.FIRGateStage.full",
                      "asp.kernel.fir_noise_gate_fused"]]),
    (False, "full_flush", [["asp.Chain.full_flush", "asp.Chain.full", "asp.FIRGateStage.full",
                            "asp.kernel.fir_noise_gate_fused"]]),
    (True, "step", [["asp.Chain.step", "asp.ResFIRGateStage.step",
                     "asp.kernel.res_fir_gate_step_fused"]]),
    (True, "full", [["asp.Chain.full", "asp.ResFIRGateStage.full",
                     "asp.kernel.resample_fir_gate_fused"],
                    ["asp.Chain.full", "asp.ResFIRGateStage.full", "asp.kernel.fir_mac"]]),
])
def test_chain_spans_from_entry_to_kernel_wrapper(composite, call, want):
    chain = _cpu_chain(composite)
    block = 1176 * 4 if composite else 2048
    x = torch.randn(2, 4 * block)
    state = chain.init_state((2,), block, torch.float32, "cpu")
    profiling.enable(True)
    if call == "step":
        chain.step(state, x[:, :block])
    else:
        getattr(chain, call)(x)
    rs = profiling.spans()
    leaves = [_path(rs, i) for i in range(len(rs))
              if not any(r[3] == i for r in rs)]
    assert leaves == want
    assert {r[4] for r in rs} == {0}


def test_sharded_chain_records_the_epilogue_and_collectives_on_rank_0():
    chain = Chain([ResFIRGateStage(up=160, down=147, h=H, env_h=HE, **GATE)])
    x = np.random.default_rng(5).standard_normal((2, 147 * 256)).astype(np.float32)
    rs = spawn_local(torch_dist_workers.record_sharded_chain, 2, args=(chain, x),
                     device="cpu", timeout_s=240.0)[0]
    names = _names(rs)
    assert names[0] == "asp.sharded_chain" and {r[4] for r in rs} == {0}
    shards = [_path(rs, i)[1] for i in range(len(rs)) if rs[i][3] == 0]
    assert shards == ["asp.shard.ResampleStage", "asp.shard.FIRStage",
                      "asp.shard.GateStage", "asp.shard.FIRStage"]
    norm = names.index("asp.spill_and_norm")
    assert _path(rs, norm) == ["asp.sharded_chain", "asp.shard.GateStage",
                               "asp.spill_and_norm"]
    assert {"asp.collective.shift", "asp.collective.broadcast_first"} <= set(names)
    assert any(_path(rs, i)[-2:] == ["asp.spill_and_norm", "asp.collective.shift"]
               for i in range(len(rs)))
    assert "asp.kernel.gate_shard_fused" in names


def test_counters_fold_in_every_wrappers_launches():
    wrappers = [fn for m in KERNEL_MODULES
                for fn in vars(importlib.import_module(
                    f"audiosignalprocess_tpu_torch.kernels.{m}")).values()
                if callable(fn) and hasattr(fn, "launches")]
    got = profiling.counters()
    assert {f"launches.{fn.__name__}" for fn in wrappers} <= set(got)
    assert len(wrappers) == 19
    before = fir_mac.launches
    try:
        fir_mac.launches += 3
        assert profiling.counters()["launches.fir_mac"] == got["launches.fir_mac"] + 3
    finally:
        fir_mac.launches = before
    assert "allocations" not in profiling.counters("cpu")


@pytest.mark.parametrize("device", ["cpu", None])
def test_upload_off_the_card_counts_nothing(device):
    before = profiling.counters()
    t = upload(np.ones(1000), torch.float32, device)
    assert t.device.type == "cpu"
    after = profiling.counters()
    assert (after["uploads"], after["upload_bytes"]) == (before["uploads"],
                                                         before["upload_bytes"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: uploads and launches count only on a card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_card_counts_uploads_and_times_launches(card):
    before = profiling.counters(card)
    upload(np.ones(1000), torch.float32, card)
    after = profiling.counters(card)
    assert after["uploads"] == before["uploads"] + 1
    assert after["upload_bytes"] == before["upload_bytes"] + 4000
    x = torch.randn(4, 4096, device=card)
    fir_mac(x, H)
    profiling.enable(True)
    fir_mac(x, H)
    profiling.enable(False)
    torch.cuda.synchronize(card)
    rs = profiling.spans()
    assert [(_path(rs, i)) for i in range(len(rs))] == [
        ["asp.kernel.fir_mac"], ["asp.kernel.fir_mac", "asp.launch"]]
    assert profiling.self_ns(rs)[0] >= 0
    assert profiling.counters(card)["allocations"] > after["allocations"]
    assert profiling.counters(card)["launches.fir_mac"] == after["launches.fir_mac"] + 2
