"""Bytes and float32 operations of the 48 kHz FIR -> STFT gate chain,
from the shapes alone: whatever kernels compute it, the mathematics is an
overlap-save FIR (one forward and one inverse real transform a block of
nfft - taps + 1 samples) and the gate (one forward and one inverse real
transform a frame), each input sample read once, each output written
once, and in a stream the carry read and written once a block."""

from __future__ import annotations

from portbench.roofline import chain_flops


def call_work(stage: dict, channels: int, n: int) -> tuple[float, float]:
    """A whole file of ``n`` samples a channel."""
    nfft, hop, taps = stage["nfft"], stage["hop"], len(stage["h"])
    frames = 1 + (n - nfft) // hop
    blocks = -(-n // (nfft - (taps - 1))) * (nfft - (taps - 1))
    return 8.0 * channels * n, chain_flops(channels, blocks, frames, nfft, taps)


def carry_floats(stage: dict) -> int:
    """A channel's carry between blocks: the FIR's history, the gate's
    input overlap, its delay of noise_frames hops, its overlap-add tail
    and its floor."""
    nfft, hop = stage["nfft"], stage["hop"]
    return (len(stage["h"]) - 1) + 2 * (nfft - hop) + stage["noise_frames"] * hop \
        + nfft // 2 + 1


def block_work(stage: dict, channels: int, b: int) -> tuple[float, float]:
    """One streamed block of ``b`` samples a channel."""
    nfft, hop, taps = stage["nfft"], stage["hop"], len(stage["h"])
    nbytes = 4.0 * channels * (2 * b + 2 * carry_floats(stage))
    return nbytes, chain_flops(channels, b, b / hop, nfft, taps)
