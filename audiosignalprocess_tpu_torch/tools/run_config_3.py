"""Config 3: the 8-channel 48 kHz STFT (1024/256) spectral noise gate and
ISTFT, channel-sharded over the ranks (one rank: the whole batch).

    python -m audiosignalprocess_tpu_torch.tools.run_config_3 --check
    torchrun --standalone --nproc-per-node=4 -m audiosignalprocess_tpu_torch.tools.run_config_3 --check

With the kernels (the default) each rank runs ``noise_gate_fused`` on its
channels; ``--check`` holds the gathered output to the float64 plain gate
on the CPU (>= 60 dB) and its zero tail.
"""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.parallel import (
    initialize, make_mesh, shard_audio, sharded_noise_gate,
)
from audiosignalprocess_tpu_torch.pipeline import GateStage
from audiosignalprocess_tpu_torch.tools.common import (
    load_or_make, maybe_write, report, snr_db, std_parser, timed, to_host, world,
)
from audiosignalprocess_tpu_torch.utils.validate import check

RATE = 48000
CHANNELS = 8
NFFT, HOP = 1024, 256


def main():
    args = std_parser(__doc__).parse_args()
    initialize(backend=args.backend, device=args.device)
    x = load_or_make(args, channels=CHANNELS, rate=RATE)
    n = (x.shape[-1] // HOP) * HOP
    x = x[:, :n]
    ch = world()
    check(CHANNELS % ch == 0, f"{ch} ranks do not split {CHANNELS} channels")
    mesh = make_mesh(channel=ch, time=1)
    fn = sharded_noise_gate(mesh, NFFT, HOP, fused=not args.no_fused)
    xs = shard_audio(torch.as_tensor(x, device=args.device), mesh)

    y, dt = timed(fn, xs) if args.bench else (fn(xs), None)
    out = to_host(y, mesh)

    snr = None
    if args.check:
        ref = GateStage(NFFT, HOP).full(torch.as_tensor(x, dtype=torch.float64)).numpy()
        out_len = NFFT + ((n - NFFT) // HOP) * HOP
        check(out.shape == ref.shape, f"structural mismatch {out.shape} vs {ref.shape}")
        check(np.allclose(out[:, out_len:], 0.0, atol=1e-6), "tail not zero")
        snr = snr_db(ref, out)
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE)
    report(f"config3_8ch_noise_gate_{ch}ranks", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
