"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to a cell is found by name: the cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the traffic's entry (``entries/<entry>.py``,
which drives the program), the configuration's work count
(``work/<config>.py``), each per-layer metric's reader
(``metrics/<metric>.py``) and the cell's correctness limit
(``limits/<cell>.json``).  The program under test is reached only through
``portbench.program``; the reference (``portbench.reference``) imports
nothing of it.

A run: set-up (inputs made on the device from the seed, the chain built,
every shape of the cell warmed), the measured window of ``--seconds``,
then, with the program's state freed, the comparison of the sampled
outputs with the float64 reference.  With ``--trace 1`` a bounded
sub-window runs under ``torch.profiler`` and the run reports the
per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import portbench
from portbench.signal import derive

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audiosignalprocess_tpu")
"""Top-level module names no run may hold (the JAX package and JAX)."""
CACHE = ".portbench_cache"
"""The build and kernel caches' directory inside the checkout."""


def cache_env(root: Path = ROOT) -> None:
    """Point every compiler cache at fixed directories in the checkout."""
    base = root / CACHE
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (sys.modules by
    default), each compared whole: the part before the first dot."""
    top = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(top & set(FORBIDDEN))


def load_file(path: Path):
    """A module from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_base(name: str, have) -> str | None:
    """``name`` or the first of its bases (the name with its last dotted
    parts taken off: ``idle_share.file.host_paced``, ``idle_share.file``,
    ``idle_share``) that ``have`` holds.  A metric split over cells of
    another pace shares its quantity's reader and its entry's value."""
    while name not in have:
        if "." not in name:
            return None
        name = name.rsplit(".", 1)[0]
    return name


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name or base>.py``."""
    base = by_base(name, {p.stem for p in (PKG / "metrics").glob("*.py")})
    return load_file(PKG / "metrics" / f"{base}.py")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """Everything a run of ``workload`` needs, by name from BENCHMARK.json."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", cells)

    return {"name": workload, "config_name": cell["config"], "chips": cell["chips"],
            "config": _json(root / config["file"]),
            "traffic": _json(PKG / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)],
            "limits": _json(PKG / "limits" / f"{workload}.json")}


class Reservoir:
    """A uniform sample, drawn from the seed, of the window's outputs
    (reservoir sampling: the window's length is not known beforehand)."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(derive(seed, "sample"))
        self.size = size
        self.kept: list = []

    def offer(self, i: int, payload) -> None:
        if len(self.kept) < self.size:
            self.kept.append((i, payload))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.size:
                self.kept[j] = (i, payload)


class Mark:
    """Completion of the work queued so far on the device (an event);
    on the CPU the work is done when queued."""

    def __init__(self, device):
        import torch

        self.ev = None
        if device.type == "cuda":
            self.ev = torch.cuda.Event()
            self.ev.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self.ev is not None:
            self.ev.synchronize()


def process_age_s() -> float:
    """Seconds since this process started."""
    return portbench.START_AGE_S + time.perf_counter() - portbench.START_PERF


@dataclass
class Ctx:
    """What an entry gets: the cell, the run's arguments, the designed
    stages and the window's bookkeeping."""

    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    stages: list
    work: object
    rank: int = 0
    tracer: object = None
    undo: object = None
    setup_s: float = 0.0
    spans: list = field(default_factory=list)
    phases: list = field(default_factory=list)

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def note(self, what: str) -> None:
        """Mark the end of a phase of set-up (printed with the checks)."""
        self.sync()
        self.phases.append((what, process_age_s()))

    def start_window(self) -> float:
        """Close set-up and open the window; returns its start.  A traced
        run starts the profiler once here, in set-up."""
        self.tracer.warm()
        self.sync()
        self.setup_s = process_age_s()
        self.phases.append(("window opens", self.setup_s))
        return time.perf_counter()

    def running(self, deadline: float, i: int) -> bool:
        """Whether the window goes on to iteration i: until the deadline,
        and in a traced run until its sub-window is complete."""
        t = self.tracer
        return time.perf_counter() < deadline or (t.enabled and i <= t.start + t.count)

    def span(self, i: int, seconds: float) -> None:
        """The host time of iteration i's call into the program; the
        sub-window's own are left out (the profiler slows the host)."""
        if not self.tracer.counted(i):
            self.spans.append(seconds)


@dataclass
class Outcome:
    """What an entry's window produced."""

    attempted: int
    metrics: dict  # end-to-end name -> value
    items: list  # compare.Item of the sampled outputs
    memory_peak_bytes: int
    unit_work: tuple  # (bytes, operations) of one call or block on this rank
    traces: list = field(default_factory=list)  # TraceData per rank, rank 0 first


def make_ctx(spec: dict, seed: int, seconds: float, trace: bool, device,
             rank: int = 0) -> Ctx:
    from portbench.reference import design_taps
    from portbench.trace import Tracer

    traffic = spec["traffic"]
    ctx = Ctx(cell=spec, seed=seed, seconds=seconds, trace=trace, device=device,
              stages=[design_taps(s) for s in spec["config"]["stages"]],
              work=load_file(PKG / "work" / f"{spec['config_name']}.py"), rank=rank)
    ctx.tracer = Tracer(trace, traffic["trace_from"], traffic["trace_units"], device)
    ctx.undo = plant(spec)
    return ctx


def plant(spec: dict):
    """The fault a test names in the spec (``"patch": "module:function"``),
    planted in this process; returns its undo.  Runs name none."""
    if not spec.get("patch"):
        return lambda: None
    module, name = spec["patch"].split(":")
    return getattr(importlib.import_module(module), name)()


def entry_of(spec: dict):
    return importlib.import_module(f"portbench.entries.{spec['traffic']['entry']}")


def card(device) -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             phases: list | None = None) -> tuple[dict, list[str]]:
    """One run of the cell on ``device``: (result, check lines).  The look
    for a card is the caller's (``main``); ``phases`` are its set-up
    marks."""
    import torch

    from portbench.compare import compare

    ctx = make_ctx(spec, seed, seconds, trace, device)
    ctx.phases[:0] = phases or []
    try:
        out = entry_of(spec).run(ctx)
    finally:
        ctx.undo()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    traffic = spec["traffic"]
    t_check = time.perf_counter()
    got = compare(ctx.stages, out.items, traffic["ref_rows"])
    t_check = time.perf_counter() - t_check
    limit = spec["limits"]["max_rel_err"]
    worst = got["max_rel_err"]
    correct = bool(out.items) and worst <= limit
    metrics = {}
    if not trace:
        values = dict(out.metrics, setup_s=ctx.setup_s)
        for m in spec["end_to_end"]:
            base = by_base(m["name"], values)
            if base is not None:
                metrics[m["name"]] = {"value": values[base], "unit": m["unit"]}
    else:
        view = RunView(ctx, out)
        for m in spec["per_layer"]:
            value = reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": spec["chips"] if device.type == "cuda" else 1,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": sum(1 for k, v in got.items() if k != "max_rel_err" and not v <= limit),
              "metrics": metrics, "device": dev}
    if trace and out.traces and out.traces[0] is not None:
        ranks = [t for t in out.traces if t is not None]
        dev["busy_s"] = sum(t.busy_s for t in ranks) / len(ranks)
        dev["window_s"] = sum(t.window_s for t in ranks) / len(ranks)
        result["breakdown"] = {"device_ops": out.traces[0].device_ops(),
                               "idle_gaps": out.traces[0].idle_gaps}
    result["card"] = card(device)
    result["checks"] = {"max_rel_err": {"value": worst if math.isfinite(worst) else 1e308,
                                        "limit": limit}}
    lines = [f"portbench {spec['name']} seed {seed}: {len(out.items)} outputs compared "
             f"with the float64 reference",
             f"card: {result['card']}",
             "set-up: " + ", ".join(f"{w} at {t:.3f} s" for w, t in ctx.phases),
             f"the reference and the comparison took {t_check:.3f} s",
             f"check max_rel_err {worst!r} limit {limit!r} -> "
             f"{'correct' if correct else 'NOT correct'}"]
    return result, lines


class RunView:
    """What a per-layer reader sees of a traced run: rank 0's trace, the
    host spans and the work of one call or block."""

    def __init__(self, ctx: Ctx, out: Outcome):
        self.trace = out.traces[0] if out.traces else None
        self.spans = ctx.spans
        self.unit_work = out.unit_work


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    cache_env()
    import torch

    phases = [("torch imported", process_age_s())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {spec['chips']} CUDA device(s), this "
              f"machine has {have}: no run, no result", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda")
    phases.append(("CUDA ready", process_age_s()))
    result, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), phases=phases)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: no result", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
