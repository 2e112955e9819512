"""The harness on the CPU: BENCHMARK.json against the contract's names
and arrows, the run without a card, the whole-name check for JAX and the
JAX package, the imports of the reference, and a run of every cell at a
tiny size through the CPU versions of the program's kernels."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import TINY, tiny_spec

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(w["name"] for w in BENCH["workloads"])) == len(BENCH["workloads"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (harness.PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.PKG / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200


def test_every_arrow_points_at_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        reported = set(m.get("workloads", e2e[m["moves"]]))
        assert reported and reported <= e2e[m["moves"]], m
        assert callable(harness.reader(m["name"]).read), m
    for cell in cells:
        assert any(cell in s for n, s in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_a_split_metric_takes_its_quantitys_reader_and_value():
    assert harness.by_base("idle_share.file.host_paced", {"idle_share"}) == "idle_share"
    assert harness.by_base("file_samples_per_s.host_paced",
                           {"file_samples_per_s": 1.0}) == "file_samples_per_s"
    assert harness.by_base("block_p95_ms", {"file_samples_per_s"}) is None


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["jax.numpy", "os"]) == ["jax"]
    assert harness.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert harness.forbidden_modules(["audiosignalprocess_tpu.ops.fft"]) == \
        ["audiosignalprocess_tpu"]
    assert harness.forbidden_modules(["audiosignalprocess_tpu_torch", "jaxtyping",
                                      "audiosignalprocess_tpu_torch.ops"]) == []


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_and_the_reference_imports_no_program():
    for path in harness.PKG.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "audiosignalprocess_tpu"}, path
    for path in (harness.PKG / "reference").rglob("*.py"):
        assert "audiosignalprocess_tpu_torch" not in _imports(path), path
    outside_tests = [p for p in harness.PKG.rglob("*.py") if "tests" not in p.parts]
    users = {p.name for p in outside_tests if "audiosignalprocess_tpu_torch" in
             p.read_text().replace('"""', "").split("import", 1)[-1] and
             any("audiosignalprocess_tpu_torch" in ast.unparse(n) for n in
                 ast.walk(ast.parse(p.read_text()))
                 if isinstance(n, (ast.Import, ast.ImportFrom)))}
    assert users == {"program.py"}, users


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["--workload", "fir_gate_48k.file", "--seed", "2147483999", "--seconds", "1",
                "--trace", "0"], ROOT, env)
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in out.stdout.splitlines())
    assert "CUDA" in out.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(["--workload", "fir_gate_48k.file", "--seed", "3", "--seconds", "1",
                "--trace", "0"], tmp_path, env)
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in out.stdout.splitlines())


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_each_cell_is_correct(cell, trace):
    import torch

    res, lines = harness.run_cell(tiny_spec(cell), 2**31 + 11, 0.5, trace,
                                  torch.device("cpu"))
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0, lines
    assert list(res)[-1] == "checks"
    assert lines[-1].startswith("check max_rel_err")
    want = {m["name"] for m in (tiny_spec(cell)["per_layer"] if trace
                                else tiny_spec(cell)["end_to_end"])}
    if trace:
        assert "busy_s" in res["device"] and "breakdown" in res
        # the CPU has no device trace: only the host span's reader reads
        assert set(res["metrics"]) <= want
    else:
        assert set(res["metrics"]) == want
    json.dumps(res)


@pytest.mark.requires_cuda
def test_one_short_run_on_the_card(cuda_device):
    out = _run(["--workload", "fir_gate_48k.file", "--seed", "2147484001", "--seconds", "2",
                "--trace", "0"], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"file_samples_per_s", "setup_s"}
