"""Config 1: mono 16 kHz -> 64-tap Hann FIR lowpass by overlap-save at
nfft 1024 -> WAV, held to the float64 plain path.

    python -m audiosignalprocess_tpu_torch.tools.run_config_1 [--device cpu] [--bench]

With the kernels (the default) the filter is one ``overlap_save_fused``
launch; ``--no-fused`` runs the FFT route (``rfft_stockham`` +
``irfft_stockham`` on the card).  Config 1 is the parity config: the
driver always checks the output against the float64 plain overlap-save
on the CPU (>= 60 dB, exact length).
"""

from __future__ import annotations

import torch

from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.tools.common import (
    load_or_make, maybe_write, report, snr_db, std_parser, timed, to_host,
)
from audiosignalprocess_tpu_torch.utils.validate import check

RATE = 16000
NFFT = 1024


def main():
    args = std_parser(__doc__).parse_args()
    x = load_or_make(args, channels=1, rate=RATE)
    h = design_fir(64, 0.25, window_kind="hann")

    def fn(v):
        return overlap_save(v, h, NFFT, fused=not args.no_fused)

    xd = torch.as_tensor(x, device=args.device)
    y, dt = timed(fn, xd) if args.bench else (fn(xd), None)
    out = to_host(y)

    ref = overlap_save(torch.as_tensor(x[0], dtype=torch.float64), h, NFFT,
                       impl="torch").numpy()
    check(out.shape == (1, ref.shape[0]), f"structural mismatch {out.shape} vs {ref.shape}")
    snr = snr_db(ref, out[0])
    check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE)
    report("config1_mono_fir_overlap_save", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
