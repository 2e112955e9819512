"""A configuration's stage list run by the plain reference.

The stage dictionaries are those of ``portbench/configs/<config>.json``
with their taps already designed (``portbench.reference.design_taps``):
the same dictionaries the benchmark hands to the program.  Supported
stages: ``FIRGateStage`` (FIR -> STFT gate -> optional envelope) and
``ResFIRGateStage`` (causal polyphase resampler in front of it).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import dsp

TAP_DESIGNS = {"design_fir": dsp.design_fir, "resample_filter": dsp.resample_filter}
"""How a configuration names its taps: ``{"design_fir": [64, 0.3]}``."""


def design_taps(stage: dict) -> dict:
    """The stage with every tap spec replaced by its float64 taps."""
    out = dict(stage)
    for key, value in stage.items():
        if isinstance(value, dict) and len(value) == 1 and next(iter(value)) in TAP_DESIGNS:
            (name, args), = value.items()
            out[key] = TAP_DESIGNS[name](*args)
    return out


def out_len(stages: list[dict], n: int) -> int:
    """Output samples of the chain for n input samples."""
    for s in stages:
        if s["stage"] == "ResFIRGateStage":
            g = math.gcd(s["up"], s["down"])
            n = -(-n * (s["up"] // g) // (s["down"] // g))
    return n


def _fir_gate(s: dict, x: torch.Tensor, floor, q):
    y = dsp.fir(x, s["h"], q)
    y, floor = dsp.noise_gate(y, s["nfft"], s["hop"], s["threshold_db"], s["reduction_db"],
                              s["noise_frames"], s["window_kind"], floor, q)
    if s.get("env_h") is not None:
        y = dsp.envelope(y, s["env_h"], s.get("env_scale", math.pi / 2.0), q)
    return y, floor


def run_chain(stages: list[dict], x: torch.Tensor, floors: list | None = None,
              q=dsp._same) -> tuple[torch.Tensor, list]:
    """The whole-file output of the chain on ``x`` (..., n) in x's dtype,
    and the gate floor of each stage.  ``floors`` (one entry per stage,
    None to compute it) imposes a stream's floor on a segment of it."""
    used = []
    for i, s in enumerate(stages):
        floor = None if floors is None else floors[i]
        if s.get("release", 0.0) != 0.0:
            raise ValueError("the reference gate has no release smoothing")
        if s["stage"] == "ResFIRGateStage":
            x = dsp.resample(x, s["up"], s["down"], s["h_res"], q)
        elif s["stage"] != "FIRGateStage":
            raise ValueError(f"no reference for stage {s['stage']!r}")
        x, floor = _fir_gate(s, x, floor, q)
        used.append(floor)
    return x, used


def chain_floors(stages: list[dict], x_head: torch.Tensor, q=dsp._same) -> list:
    """The floors a stream starting with ``x_head`` settles on: those of
    the chain's whole-file run over its first samples (x_head must hold
    every stage's first noise frames)."""
    return run_chain(stages, x_head, None, q)[1]


def stream_latency(stages: list[dict]) -> int:
    """Output samples by which a stream of the chain lags its whole-file
    output: each gate's (nfft - hop) + noise_frames * hop, carried through
    the later rate changes."""
    lat = 0
    for s in stages:
        if s["stage"] == "ResFIRGateStage":
            lat = out_len([s], lat)
        lat += (s["nfft"] - s["hop"]) + s["noise_frames"] * s["hop"]
    return lat
