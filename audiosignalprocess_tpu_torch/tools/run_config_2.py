"""Config 2: stereo 44.1 kHz -> zero-phase polyphase resample to 48 kHz
(160/147) -> 256-tap Hamming bandpass, on one device.

    python -m audiosignalprocess_tpu_torch.tools.run_config_2 --check [--device cpu] [--bench]

With the kernels (the default) the chain is one ``resample_mac`` launch
and one ``fir_mac`` launch; ``--no-fused`` runs the plain PyTorch
resampler and FIR.  ``--check`` holds the output to the float64 plain
chain on the CPU (>= 60 dB, exact length).
"""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu_torch.ops.resample import resample_poly
from audiosignalprocess_tpu_torch.tools.common import (
    load_or_make, maybe_write, report, snr_db, std_parser, timed, to_host,
)
from audiosignalprocess_tpu_torch.utils.validate import check

RATE_IN, RATE_OUT = 44100, 48000
UP, DOWN = 160, 147


def bandpass() -> np.ndarray:
    return design_fir(256, (0.1, 0.5), window_kind="hamming", pass_zero=False)


def chain(v: torch.Tensor, h, fused: bool = True) -> torch.Tensor:
    """Resample 44.1 -> 48 kHz (zero phase), then the bandpass."""
    return fir_direct(resample_poly(v, UP, DOWN, fused=fused), h, fused=fused)


def main():
    args = std_parser(__doc__).parse_args()
    x = load_or_make(args, channels=2, rate=RATE_IN, kind="am")
    h = bandpass()
    fused = not args.no_fused
    xd = torch.as_tensor(x, device=args.device)
    y, dt = (timed(lambda v: chain(v, h, fused), xd) if args.bench
             else (chain(xd, h, fused), None))
    out = to_host(y)

    snr = None
    if args.check:
        ref = chain(torch.as_tensor(x, dtype=torch.float64), h, fused=False).numpy()
        check(out.shape == ref.shape, f"structural mismatch {out.shape} vs {ref.shape}")
        snr = snr_db(ref, out)
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE_OUT)
    report("config2_stereo_resample_bandpass", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
