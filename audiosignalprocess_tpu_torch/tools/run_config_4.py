"""Config 4: the 64-channel 96 kHz long FIR (4096-tap Blackman lowpass)
by overlap-save at nfft 16384, with halo exchange over a (channel, time)
mesh of the ranks.

    python -m audiosignalprocess_tpu_torch.tools.run_config_4 --check
    torchrun --standalone --nproc-per-node=4 -m audiosignalprocess_tpu_torch.tools.run_config_4 --check

The mesh is the JAX driver's choice: the largest of 8, 4, 2, 1 channel
blocks that divides both the ranks and the 64 channels, the rest of the
ranks on time (``--mesh CxT`` overrides it).  With the kernels (the
default) each shard runs ``overlap_save_fused``, its left halo as the
history; ``--check`` holds four channels to the float64 plain
overlap-save on the CPU (torch.fft; >= 60 dB).
"""

from __future__ import annotations

import torch

from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.parallel import (
    initialize, make_mesh, shard_audio, sharded_overlap_save,
)
from audiosignalprocess_tpu_torch.tools.common import (
    load_or_make, maybe_write, report, snr_db, std_parser, timed, to_host, world,
)
from audiosignalprocess_tpu_torch.utils.validate import check

RATE = 96000
CHANNELS = 64
TAPS = 4096
NFFT = 16384


def mesh_shape(ranks: int) -> tuple[int, int]:
    """(channel, time): channel-major, the leftover factor on time."""
    ch = next(c for c in (8, 4, 2, 1) if ranks % c == 0 and CHANNELS % c == 0)
    return ch, ranks // ch


def main():
    p = std_parser(__doc__)
    p.add_argument("--mesh", default=None, help="CxT, e.g. 2x2 (default: see above)")
    args = p.parse_args()
    initialize(backend=args.backend, device=args.device)
    x = load_or_make(args, channels=CHANNELS, rate=RATE)
    h = design_fir(TAPS, 0.1, window_kind="blackman")
    ch, tm = (tuple(int(v) for v in args.mesh.split("x")) if args.mesh
              else mesh_shape(world()))
    n = (x.shape[-1] // (tm * 256)) * (tm * 256)
    x = x[:, :n]
    mesh = make_mesh(channel=ch, time=tm)
    fn = sharded_overlap_save(mesh, h, NFFT, fused=not args.no_fused)
    xs = shard_audio(torch.as_tensor(x, device=args.device), mesh)

    y, dt = timed(fn, xs) if args.bench else (fn(xs), None)
    out = to_host(y, mesh)

    snr = None
    if args.check:
        ref = overlap_save(torch.as_tensor(x[:4], dtype=torch.float64), h, NFFT,
                           impl="torch").numpy()
        check(out.shape == x.shape, "structural mismatch")
        snr = snr_db(ref, out[:4])
        check(snr >= 60.0, f"parity FAILED: {snr:.1f} dB")

    maybe_write(args, out, RATE)
    report(f"config4_64ch_4096tap_halo_{ch}x{tm}", x, out, dt, snr, args)


if __name__ == "__main__":
    main()
