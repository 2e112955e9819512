"""The benchmark's input: tone bursts over noise, made on the device from
the seed.

Each channel carries white noise and a tone (the config drivers'
"tone+noise": 220 Hz times 2**((c % 12)/12), here with a seeded phase)
that switches on and off: off for the first ``first_on_s`` seconds (so
every gate's noise floor sees noise only), then on for ``duty`` of every
``period_s``.  The schedule is drawn per channel from the seed, so the
gate both opens and closes in every block of every cell; the sizes never
depend on the seed.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

CHUNK = 1 << 18
"""Samples of time computed in float64 at once (bounds the temporary)."""


def derive(seed: int, *keys) -> int:
    """A 63-bit seed from ``seed`` and keys (pool file, rank, purpose)."""
    text = ":".join(str(k) for k in (seed, *keys)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def schedule(seed: int, recording: int, channels: int, sig: dict) -> dict:
    """Per-channel tone frequency, phase and burst timing of one
    recording (host, tiny)."""
    rng = np.random.default_rng(derive(seed, "schedule", recording))
    c = np.arange(channels)
    period = rng.uniform(*sig["period_s"], channels)
    return {"hz": sig["tone_hz"] * 2.0 ** ((c % 12) / 12.0),
            "phase": rng.uniform(0.0, 2.0 * np.pi, channels),
            "first_on": rng.uniform(*sig["first_on_s"], channels),
            "period": period,
            "on": period * rng.uniform(*sig["duty"], channels)}


def make(seed: int, recording: int, part: int, channels: int, start: int, n: int,
         rate: int, sig: dict, device) -> torch.Tensor:
    """Samples [start, start+n) of recording ``recording`` (a pool file),
    float32 (channels, n) on ``device``.  The noise of each ``part`` (a
    rank's time shard) is drawn apart, so any part is made alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "noise", recording, part))
    x = torch.randn((channels, n), generator=gen, device=device, dtype=torch.float32)
    x *= sig["noise_std"]
    sc = {k: torch.as_tensor(v, dtype=torch.float64, device=device)[:, None]
          for k, v in schedule(seed, recording, channels, sig).items()}
    for a in range(0, n, CHUNK):
        t = (start + a + torch.arange(min(CHUNK, n - a), device=device,
                                      dtype=torch.float64)) / rate
        since = t - sc["first_on"]
        on = (since >= 0) & (torch.remainder(since, sc["period"]) < sc["on"])
        tone = sig["tone_amp"] * torch.sin(2.0 * np.pi * sc["hz"] * t + sc["phase"])
        x[:, a : a + t.shape[-1]] += torch.where(on, tone, 0.0).to(torch.float32)
    return x
