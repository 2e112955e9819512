"""Shared helpers of the port's config drivers: the JAX package's
``tools/common.py``, which loads jax, in torch.

Each driver runs as ``python -m audiosignalprocess_tpu_torch.tools.run_config_N``
or, one process per rank, under ``torchrun``.  ``--check`` holds the
output to the port's float64 plain path on the CPU (which the CPU tests
hold to the oracle); ``--bench`` times the call with CUDA events on the
card and the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.parallel import Mesh, gather_audio
from audiosignalprocess_tpu_torch.utils.metrics import snr_db  # noqa: F401
from audiosignalprocess_tpu_torch.utils.validate import check


def make_signal(channels: int, rate: int, seconds: float, kind: str = "tone+noise",
                seed: int = 0) -> np.ndarray:
    """The drivers' deterministic multichannel signal (float64)."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = np.zeros((channels, n))
    for c in range(channels):
        f = 220.0 * (2.0 ** (c % 12 / 12.0))
        if kind == "tone+noise":
            x[c] = 0.01 * rng.standard_normal(n)
            gate = (t > 0.25 * seconds / 1.0) & (t < 0.7 * seconds)
            x[c] += np.where(gate, 0.5 * np.sin(2 * np.pi * f * t), 0.0)
        elif kind == "am":
            x[c] = (1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) * np.sin(2 * np.pi * f * t) * 0.4
        else:
            x[c] = 0.5 * np.sin(2 * np.pi * f * t)
    return x


def make_test_wav(path: str, channels: int, rate: int, seconds: float,
                  kind: str = "tone+noise", seed: int = 0) -> None:
    """Write the deterministic test signal as a float WAV."""
    write_wav(path, make_signal(channels, rate, seconds, kind, seed), rate, float_fmt=True)


def std_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--input", default=None, help="input WAV (generated if omitted)")
    p.add_argument("--output", default=None, help="output WAV path")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--check", action="store_true",
                   help="verify against the float64 plain path on the CPU")
    p.add_argument("--bench", action="store_true", help="timed re-runs")
    p.add_argument("--json", action="store_true", help="print metrics as JSON")
    p.add_argument("--seed", type=int, default=0,
                   help="generated-input RNG seed (ignored with --input)")
    p.add_argument("--no-fused", action="store_true",
                   help="the stages' unfused routes (plain PyTorch around ops.fft's FFTs) "
                        "instead of their fused kernels")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None,
                   help="process-group backend under torchrun: nccl for cuda and gloo "
                        "for cpu by default")
    return p


def load_or_make(args, channels: int, rate: int, kind: str = "tone+noise") -> np.ndarray:
    """The input as float32 (channels, n): the ``--input`` WAV, else the
    generated test signal (what a float32 WAV of it would read back)."""
    if args.input:
        x, r = read_wav(args.input, dtype=np.float32)
        check(r == rate, f"expected {rate} Hz input, got {r}")
        return x
    return make_signal(channels, rate, args.seconds, kind, seed=args.seed).astype(np.float32)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def report(name: str, x, out, dt: float | None, snr: float | None, args,
           ref: str = "f64_plain", bar: float = 60.0, extra: dict | None = None) -> None:
    """Print the run's record (rank 0 only).  ``snr`` is against ``ref``
    (``snr_db_vs_<ref>``; an infinite one, a bit-equal output, is
    recorded as null with ``bit_equal``), and parity means ``snr >= bar``;
    ``extra`` adds keys."""
    if rank() != 0:
        return
    rec = {"config": name, "device": str(args.device), "ranks": world(),
           "in_shape": list(np.shape(x)), "out_shape": list(np.shape(out))}
    if dt is not None:
        rec["seconds_per_run"] = round(dt, 6)
        rec["samples_per_s"] = round(float(np.prod(np.shape(x))) / dt, 1)
    if snr is not None:
        exact = snr == np.inf
        rec[f"snr_db_vs_{ref}"] = None if exact else round(snr, 2)
        if exact:
            rec["bit_equal"] = True
        rec["parity"] = bool(snr >= bar)
    rec.update(extra or {})
    if args.json:
        print(json.dumps(rec))
    else:
        for k, v in rec.items():
            print(f"  {k}: {v}")


def timed(fn, x, iters: int = 5):
    """(fn(x), seconds per call): CUDA events around ``iters`` calls on the
    card, the host clock on the CPU, after one untimed call."""
    out = fn(x)
    if x.is_cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return out, (time.perf_counter() - t0) / iters


def to_host(y: torch.Tensor, mesh: Mesh | None = None) -> np.ndarray:
    """The whole output as numpy: this rank's block ``y`` gathered across
    the ranks of ``mesh`` (every rank calls it), or ``y`` itself."""
    if mesh is not None:
        y = gather_audio(y, mesh)
    return y.cpu().numpy()


def maybe_write(args, out, rate: int) -> None:
    if args.output and rank() == 0:
        write_wav(args.output, np.asarray(out), rate, float_fmt=True)
