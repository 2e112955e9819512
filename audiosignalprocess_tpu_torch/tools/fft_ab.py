"""Paired A/B of the Stockham FFT kernels between two checkouts, on one card.

    python -m audiosignalprocess_tpu_torch.tools.fft_ab PARENT CHANGE [--out DIR]

runs, from each checkout's own ``chip_smoke.py`` and package, phases 14 to
16 (the FFT kernels' checks against their float64 plain versions and
torch.fft, the entry points' launches, and phase 16's times of
``fft_stockham_lanes``, ``rfft_stockham`` and ``irfft_stockham`` beside a
copy probe and torch.fft) and phase 25 (``fft_stockham_manual``'s checks,
the slice under each pipe, and its round-robin times of the grid kernel,
the ring and torch.fft, each bracketed by its own copy probe), in turns
parent, change, change, parent: one process each, so the two versions of
the package never share one.  Each checkout builds its kernels at first
use.  Every process's output goes to ``DIR/fft_ab_<i>_<label>.log``; the
timing lines are printed, prefixed with the run.  Needs a CUDA device;
exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import collections, subprocess, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
    fir_gate_step_fused, fir_noise_gate_fused)
from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    gate_shard_fused, gate_step_fused, noise_gate_fused)
from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_fused
from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
    res_fir_gate_step_fused, resample_fir_gate_fused)
from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac
from audiosignalprocess_tpu_torch.kernels.stretch_kernel import stretch_step_fused
from audiosignalprocess_tpu_torch.ops.fir import design_fir

_build.build()
kernels = (fir_noise_gate_fused, fir_gate_step_fused, gate_step_fused, overlap_save_fused,
           fir_mac, resample_mac, resample_fir_gate_fused, res_fir_gate_step_fused,
           noise_gate_fused, fk.fft_stockham_lanes, fk.rfft_stockham, fk.irfft_stockham,
           stretch_step_fused, gate_shard_fused,
           *(getattr(fk, name) for name in cs.FFT_VARIANTS), fk.fft_stockham_manual)


def reset_counts():
    for k in kernels:
        k.launches = 0


dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi)
rng = np.random.default_rng(0)
h = design_fir(cs.TAPS, 0.3)
x = torch.as_tensor(cs.tone_burst(rng, *cs.HEADLINE), dtype=torch.float32, device=dev)
record = collections.defaultdict(dict)
cs.gate_fft_phases(dev, smi, rng, record, kernels, reset_counts, x, h)
cs.fft_manual_phase(dev, smi, record, kernels, reset_counts, h)
"""

SHOWN = ("[16 times] fft_stockham_lanes", "[16 times] copy probe", "[25 times]",
         "[14 kernel] FFT worst", "[25 kernel] fft_stockham_manual worst")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("parent", help="root of the parent's checkout")
    p.add_argument("change", help="root of the change's checkout")
    p.add_argument("--out", default="_scratch/fft_ab", help="directory for the runs' logs")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "ASP_SK_PIPE"}
    runs = (("parent", args.parent), ("change", args.change), ("change", args.change),
            ("parent", args.parent))
    for i, (label, root) in enumerate(runs):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                              capture_output=True, text=True)
        log = out / f"fft_ab_{i}_{label}.log"
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        for line in proc.stdout.splitlines():
            if line.startswith(SHOWN):
                print(f"[{i} {label}] {line}")
        if proc.returncode != 0:
            print(f"[{i} {label}] exit {proc.returncode}; see {log}:\n{proc.stderr[-3000:]}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
