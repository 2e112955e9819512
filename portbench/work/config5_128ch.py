"""Bytes and float32 operations of config 5's chain, from the shapes
alone: the causal polyphase resampler (2 operations a tap of its phase,
ceil(taps/up) taps an output), the overlap-save FIR and the STFT gate as
in ``fir_gate_48k`` on the resampled signal, and the envelope (2
operations a tap an output); each input sample read once, each output
written once, and in a stream the carry read and written once a block."""

from __future__ import annotations

import math

from portbench.roofline import chain_flops


def _rates(stage: dict) -> tuple[int, int, int]:
    g = math.gcd(stage["up"], stage["down"])
    up, down = stage["up"] // g, stage["down"] // g
    return up, down, -(-len(stage["h_res"]) // up)


def _macs(stage: dict, channels: int, n_out: float) -> float:
    _, _, nk = _rates(stage)
    env = len(stage["env_h"]) if stage.get("env_h") is not None else 0
    return 2.0 * (nk + env) * channels * n_out


def call_work(stage: dict, channels: int, n_in: int) -> tuple[float, float]:
    """A whole recording of ``n_in`` input samples a channel."""
    up, down, _ = _rates(stage)
    nfft, hop, taps = stage["nfft"], stage["hop"], len(stage["h"])
    n_out = -(-n_in * up // down)
    frames = 1 + (n_out - nfft) // hop
    blocks = -(-n_out // (nfft - (taps - 1))) * (nfft - (taps - 1))
    flops = chain_flops(channels, blocks, frames, nfft, taps) + _macs(stage, channels, n_out)
    return 4.0 * channels * (n_in + n_out), flops


def carry_floats(stage: dict) -> int:
    """A channel's carry between blocks: the resampler's input history,
    then the FIR -> gate carry of ``fir_gate_48k`` and the envelope's."""
    up, down, nk = _rates(stage)
    nfft, hop = stage["nfft"], stage["hop"]
    env = len(stage["env_h"]) - 1 if stage.get("env_h") is not None else 0
    return nk + (len(stage["h"]) - 1) + 2 * (nfft - hop) + stage["noise_frames"] * hop \
        + nfft // 2 + 1 + env


def block_work(stage: dict, channels: int, b_in: int) -> tuple[float, float]:
    """One streamed block of ``b_in`` input samples a channel."""
    up, down, _ = _rates(stage)
    nfft, hop, taps = stage["nfft"], stage["hop"], len(stage["h"])
    b_out = b_in * up // down
    nbytes = 4.0 * channels * (b_in + b_out + 2 * carry_floats(stage))
    flops = chain_flops(channels, b_out, b_out / hop, nfft, taps) + _macs(stage, channels, b_out)
    return nbytes, flops
