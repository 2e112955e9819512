"""Paired A/B of the Stockham FFT kernels (or, with ``--chain``, the
whole-file chain kernels) between checkouts, on one card.

    python -m audiosignalprocess_tpu_torch.tools.fft_ab PARENT CHANGE [MORE ...]
        [--out DIR] [--quick] [--sizes N ...] [--chain] [--only NAMES] [--sass]

runs, from each checkout's own ``chip_smoke.py`` and package:

- phases 14 to 16 (the FFT kernels' checks against their float64 plain
  versions and torch.fft, the entry points' launches, phase 16's times of
  ``fft_stockham_lanes``, ``rfft_stockham`` and ``irfft_stockham`` beside a
  copy probe and torch.fft) and phase 25 (``fft_stockham_manual``'s checks,
  the slice under each pipe, the grid kernel, the ring and torch.fft timed
  round-robin);
- then this file's own timing, the same in every checkout (lines ``[ab
  real]``): on 4096 rows of each ``--sizes`` (1024 and 4096 unless told),
  ``rfft_stockham``, ``torch.fft.rfft``, ``irfft_stockham``,
  ``torch.fft.irfft``, the complex kernel on the same points and
  ``ops.fft.rfft``/``irfft`` (the kernels with the complex tensor's glue
  around them), round-robin: chip_smoke's ``time_ms`` (events around
  back-to-back calls, which a launch's host cost can pace) as a share of
  a paired copy probe, and the device time of
  launches queued behind ``torch.cuda._sleep``, which the host's launch
  cost cannot hide in; ``[ab ptxas]`` lines give the real kernels'
  registers and spills where the process built them.

With ``--chain`` the timing is the whole-file kernels' on the batched
body instead (lines ``[ab chain]``): ``fir_noise_gate_fused`` at 64 x
480000, ``resample_fir_gate_fused`` at 64 x 441000 -> 480000 (160/147),
``noise_gate_fused`` at 64 and 8 x 480000 and ``gate_shard_fused`` on one
shard (shard 1 of chip_smoke's four of 64 x 479232) on ``bench.py``'s
white noise, each call with its wrapper's prologue, 6 reps round-robin:
the device time of 10 calls queued behind ``torch.cuda._sleep`` (about
50 ms, so the wrappers' host prologues do not pace them) and
chip_smoke's ``time_ms``; and the two FIR -> gate step kernels at
chip_smoke's phase 9b shape (64 channels, one block of 4096 or 4704 raw
samples, the carry after 12 blocks of white noise; ``fir_gate_step_fused``
also with the 129-tap envelope; ``gate_step_fused`` and
``stretch_step_fused`` at 4/3 at the same block, the stretch also at
147/160, a block of 147 hops, and both at nfft 8192, hop 2048, 16 hops a
block), 20 launches queued behind the sleep; ``overlap_save_fused`` and
``fir_mac`` the same way at that shape (their stages' steps: the
kernel and its stage's glue), each kernel alone on one contiguous block
with its carry, both on the whole file (64 x 480000) and
``overlap_save_fused`` on config 4's shard (16 x 384000, 4096 taps, nfft
16384: ``run_config_4``'s 4-rank mesh, 4 s); ``--only`` keeps the arms
whose names hold one of its comma-separated substrings;
in a checkout whose whole-file body runs at nfft 8192 the four
whole-file kernels also at 8192/2048 (64 x 480000; ``noise_gate_fused``
also with release 0.6, the sequential launch);
``[ab ptxas]`` then gives the kernels' registers and spills, and ``[ab
chain]`` their registers, local memory and CTAs an SM from the CUDA
runtime where the checkout has the query.
Without ``--quick`` each checkout first runs its own kernels on
chip_smoke's phase 3 and 10 cases and on gate cases (tone bursts from
fixed seeds; the gate alone at nfft 256 to 4096, release 0 to 0.9, and
shards with all, some and one valid frame) and prints ``[ab chain]
reading`` lines: SNR against the float64 plain version and the plain
gate's flipped decisions, so the parent's readings stand beside the
change's.

``--sass`` then compares the built libraries' SASS (``cuobjdump -sass``)
of the first checkout with each other one, kernel by kernel (demangled
names without parameters, a thread-count template argument of 256
dropped, instructions without addresses or encodings): ``[ab sass]``
lines count the identical kernels and list the others with their
instruction counts and how many instructions differ.

``--quick`` runs only the timing.  The checkouts run in mirrored turns
(parent, change, change, parent; A, B, C, C, B, A for three), one process
each, so two versions of the package never share one; each builds its
kernels at first use.  Every process's output goes to
``DIR/fft_ab_<i>_<label>.log``; the timing lines are printed, prefixed
with the run.  Needs a CUDA device; exits non-zero if a run fails.
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
from audiosignalprocess_tpu_torch.ops import fft as ops_fft
from audiosignalprocess_tpu_torch.utils.metrics import snr_db

CHAIN_CASES = [  # (resampling, channels, n, taps, release, nfft, hop): phases 3 and 10's
    (False, 2, 48128, 64, 0.0, 1024, 256), (False, 4, 32768, 64, 0.6, 1024, 256),
    (False, 2, 32768, 384, 0.0, 1024, 256), (False, 2, 48128, 64, 0.0, 256, 64),
    (False, 2, 48128, 64, 0.6, 512, 128), (False, 2, 48128, 30, 0.0, 512, 256),
    (False, 3, 48128, 1, 0.0, 1024, 512), (False, 5, 48128, 64, 0.0, 1024, 128),
    (False, 2, 60000, 64, 0.0, 2048, 512), (False, 1, 60000, 384, 0.6, 2048, 256),
    (True, 2, 47040, 64, 0.0, 1024, 256), (True, 1, 47040, 384, 0.0, 1024, 256),
    (True, 2, 47040, 64, 0.0, 256, 64), (True, 3, 47040, 64, 0.6, 512, 128),
    (True, 1, 47040, 30, 0.0, 1024, 512), (True, 2, 55125, 64, 0.0, 2048, 256),
]
GATE_CASES = [  # (channels, n, release, nfft, hop): the gate alone
    (2, 48128, 0.0, 1024, 256), (2, 48128, 0.9, 1024, 256), (2, 48128, 0.0, 2048, 512),
    (2, 48128, 0.5, 512, 128), (2, 48128, 0.0, 4096, 512), (3, 40077, 0.0, 1024, 256),
    (2, 48128, 0.0, 256, 64), (2, 48128, 0.6, 256, 32),
]

log = _build.build()[1].splitlines()
chain = "--chain" in sys.argv
kern = (("noise_gate_kernel", "gate_step_kernel", "stretch_step_kernel") if chain
        else ("rfft_stockham_kernel",))
for i, line in enumerate(log):  # ptxas's report of the timed kernels, where this call built them
    if "Compiling entry function" in line and any(k in line for k in kern):
        name = line.split("'")[1]
        used = next((x.split(":", 1)[-1].strip() for x in log[i + 1:i + 6] if "Used" in x), "")
        spill = next((x.split(":", 1)[-1].strip() for x in log[i + 1:i + 6] if "spill" in x), "")
        print(f"[ab ptxas] {name}: {used}; {spill}")
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
if "--quick" not in sys.argv and not chain:
    cs.gate_fft_phases(dev, smi, rng, record, kernels, reset_counts, x, h)
    cs.fft_manual_phase(dev, smi, record, kernels, reset_counts, h)
del x

src = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB
dst = torch.empty_like(src)


def probe():
    return 2 * src.numel() * 4 / cs.time_ms(lambda: dst.copy_(src), reps=10, warmup=2) * 1e3


def queued_ms(fn, reps=20, cycles=10 ** 7):
    # device time of fn() over reps launches queued while the card sleeps
    # (10^7 cycles: about 5 ms at 2 GHz): the events bracket device work only
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


if chain:
    from audiosignalprocess_tpu_torch.kernels import chain_kernel as ck
    from audiosignalprocess_tpu_torch.kernels import res_chain_kernel as rk
    h = design_fir(cs.TAPS, 0.3)
    xa = torch.as_tensor(np.random.default_rng(0).standard_normal(cs.HEADLINE).astype(np.float32),
                         device=dev)
    xr = torch.as_tensor(np.random.default_rng(0).standard_normal(cs.RES_HEADLINE)
                         .astype(np.float32), device=dev)
    from audiosignalprocess_tpu_torch.kernels import gate_kernel as gk
    infos = {"fir_noise_gate_fused": lambda: ck.fir_noise_gate_info(device=dev),
             "resample_fir_gate_fused":
                 lambda: rk.resample_fir_gate_info(cs.UP, cs.DOWN, h, device=dev)}
    if hasattr(gk, "noise_gate_info"):  # a checkout with the gate on the batched body
        infos.update({"noise_gate_fused": lambda: gk.noise_gate_info(device=dev),
                      "noise_gate_fused release 0.6":
                          lambda: gk.noise_gate_info(release=0.6, device=dev)})
    for name, info in infos.items():
        print(f"[ab chain] {name} on {smi}: {info()}")
    if "--quick" not in sys.argv:  # the readings of chip_smoke's phase 3 and 10 cases
        from audiosignalprocess_tpu_torch.kernels.chain_kernel import fir_noise_gate_ref
        from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import resample_fir_gate_ref
        from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
        from audiosignalprocess_tpu_torch.ops.resample import resample_poly
        for i, (res, c, n, taps, release, nfft, hop) in enumerate(CHAIN_CASES):
            g = torch.as_tensor(cs.tone_burst(np.random.default_rng(1000 + i), c, n), device=dev)
            hc = design_fir(taps, 0.2 if taps == 384 else 0.3)
            kw = dict(nfft=nfft, hop=hop, release=release)
            if res:
                y = resample_fir_gate_fused(g.float(), cs.UP, cs.DOWN, hc, **kw)
                ref = resample_fir_gate_ref(g, cs.UP, cs.DOWN, hc, **kw)
                g = resample_poly(g, cs.UP, cs.DOWN, zero_phase=False)
            else:
                y = fir_noise_gate_fused(g.float(), hc, **kw)
                ref = fir_noise_gate_ref(g, hc, **kw)
            flips = cs.decision_flips(overlap_save(g, hc, nfft, impl="torch"), nfft, hop)
            name = "resample_fir_gate_fused" if res else "fir_noise_gate_fused"
            print(f"[ab chain] reading {name} {c}x{n} nfft={nfft} hop={hop} taps={taps} "
                  f"release={release}: snr_vs_f64_plain={snr_db(ref, y):.2f} dB "
                  f"decision_flips_f32_vs_f64={flips}")
        for i, (c, n, release, nfft, hop) in enumerate(GATE_CASES):
            g = torch.as_tensor(cs.tone_burst(np.random.default_rng(2000 + i), c, n), device=dev)
            kw = dict(nfft=nfft, hop=hop, release=release)
            y = noise_gate_fused(g.float(), **kw)
            ref = gk.noise_gate_ref(g, **kw)
            print(f"[ab chain] reading noise_gate_fused {c}x{n} nfft={nfft} hop={hop} "
                  f"release={release}: snr_vs_f64_plain={snr_db(ref, y):.2f} dB "
                  f"decision_flips_f32_vs_f64={cs.decision_flips(g, nfft, hop)}")
        xs = torch.as_tensor(cs.tone_burst(np.random.default_rng(20), *cs.SHARD_HEADLINE),
                             device=dev)
        for t, nv in ((1, None), (3, None), (1, 100), (1, 1)):
            ext, floor, nv_file = cs.gate_shard_inputs(xs, t, cs.SHARDS)
            ext32, floor32, _ = cs.gate_shard_inputs(xs.float(), t, cs.SHARDS)
            nv = nv_file if nv is None else nv
            y = gate_shard_fused(ext32, floor32, nv, cs.NFFT, cs.HOP)
            ref = gk.gate_shard_ref(ext, floor, nv, cs.NFFT, cs.HOP)
            end = (nv - 1) * cs.HOP + cs.NFFT
            print(f"[ab chain] reading gate_shard_fused shard {t} of {cs.SHARDS} "
                  f"{tuple(ext.shape)} n_valid={nv}: snr_vs_f64_plain={snr_db(ref, y):.2f} dB "
                  f"zero_past_last_frame={not bool(y[:, end:].any())}")
    xs = torch.as_tensor(np.random.default_rng(0).standard_normal(cs.SHARD_HEADLINE)
                         .astype(np.float32), device=dev)
    ext, floor, nv = cs.gate_shard_inputs(xs, 1, cs.SHARDS)
    xg8 = xa[:8].contiguous()
    h_env = design_fir(cs.ENV_TAPS, 0.01)
    h4 = design_fir(cs.C4_TAPS, 0.1, window_kind="blackman")
    x4 = torch.as_tensor(np.random.default_rng(0).standard_normal((16, 384000)).astype(np.float32),
                         device=dev)  # run_config_4's shard on its 4-rank mesh (4 x 1), 4 s
    hist4 = torch.as_tensor(np.random.default_rng(1).standard_normal((16, cs.C4_TAPS - 1))
                            .astype(np.float32), device=dev)
    # one stream block (chip_smoke's BLOCK) and the stages' carries, for the
    # two kernels alone without their stages' glue (abs, scale, the carry's cat)
    xblk = xa[:, : cs.BLOCK].contiguous()
    hist_os = xa[:, cs.BLOCK : cs.BLOCK + cs.TAPS - 1].contiguous()
    hist_env = xa[:, cs.BLOCK : cs.BLOCK + cs.ENV_TAPS - 1].abs().contiguous()
    from audiosignalprocess_tpu_torch.kernels import fir_kernel as fmk
    from audiosignalprocess_tpu_torch.kernels import os_kernel as osk
    for name, mod, info, kw in (("overlap_save_fused", osk, "overlap_save_info", {}),
                                ("overlap_save_fused nfft 16384", osk, "overlap_save_info",
                                 dict(nfft=cs.C4_NFFT)),
                                ("fir_mac", fmk, "fir_mac_info", dict(taps=cs.ENV_TAPS))):
        if hasattr(mod, info):  # a checkout with the redesigned kernel
            print(f"[ab chain] {name} on {smi}: {getattr(mod, info)(device=dev, **kw)}")
    arms = {"fir_noise_gate_fused": lambda: fir_noise_gate_fused(xa, h),
            "resample_fir_gate_fused": lambda: resample_fir_gate_fused(xr, cs.UP, cs.DOWN, h),
            "noise_gate_fused 64": lambda: noise_gate_fused(xa),
            "noise_gate_fused 8": lambda: noise_gate_fused(xg8),
            "gate_shard_fused": lambda: gate_shard_fused(ext, floor, nv, cs.NFFT, cs.HOP),
            "overlap_save_fused whole file": lambda: overlap_save_fused(xa, h, cs.NFFT),
            "fir_mac whole file": lambda: fir_mac(xa, h_env),
            "overlap_save_fused config 4 shard":
                lambda: overlap_save_fused(x4, h4, cs.C4_NFFT, hist4),
            "overlap_save_fused kernel alone 64x4096":
                lambda: overlap_save_fused(xblk, h, cs.NFFT, hist_os),
            "fir_mac kernel alone 64x4096": lambda: fir_mac(xblk, h_env, hist_env)}
    if hasattr(gk, "REGS_MAX_NFFT"):  # a checkout whose whole-file body runs at nfft 8192
        from audiosignalprocess_tpu_torch.ops.stft import frame
        big = dict(nfft=8192, hop=2048)
        big_ext = xs[:, : 58 * 2048 + 6144].contiguous()  # a shard of 58 hops and its halo
        big_floor = gk.noise_floor(frame(big_ext[:, : 6144 + cs.NOISE_FRAMES * 2048], 8192, 2048)
                                   * gk.file_tables(8192, 2048, "hann", dev)[0]).contiguous()
        arms.update({
            "fir_noise_gate_fused 8192": lambda: fir_noise_gate_fused(xa, h, **big),
            "resample_fir_gate_fused 8192":
                lambda: resample_fir_gate_fused(xr, cs.UP, cs.DOWN, h, **big),
            "noise_gate_fused 8192": lambda: noise_gate_fused(xa, **big),
            "noise_gate_fused 8192 release 0.6": lambda: noise_gate_fused(xa, release=0.6, **big),
            "gate_shard_fused 8192":
                lambda: gate_shard_fused(big_ext, big_floor, 58, 8192, 2048)})
        for name, info in (("noise_gate_fused", lambda: gk.noise_gate_info(8192, 2048, 0.0, dev)),
                           ("fir_noise_gate_fused",
                            lambda: ck.fir_noise_gate_info(8192, 2048, cs.TAPS, 0.0, dev)),
                           ("resample_fir_gate_fused", lambda: rk.resample_fir_gate_info(
                               cs.UP, cs.DOWN, h, nfft=8192, hop=2048, device=dev))):
            print(f"[ab chain] {name} nfft 8192 on {smi}: {info()}")
    # the step kernels at chip_smoke's phase 9b shape: 64 channels, one
    # block (BLOCK, or RES_BLOCK raw for the resampler) with the carry after
    # STEP_WARM blocks of white noise, 20 launches queued behind the sleep
    from audiosignalprocess_tpu_torch.pipeline import (
        Chain, FIRGateStage, GateStage, ResFIRGateStage, StretchStage)
    gate = dict(nfft=cs.NFFT, hop=cs.HOP, noise_frames=cs.NOISE_FRAMES)
    big = dict(nfft=8192, hop=2048)
    from audiosignalprocess_tpu_torch.pipeline import EnvelopeStage, FIRStage
    steps = {"overlap_save_fused": (FIRStage(h=h, nfft=cs.NFFT, fused=True), cs.BLOCK),
             "fir_mac": (EnvelopeStage(h_env, fused=True), cs.BLOCK),
             "fir_gate_step_fused": (FIRGateStage(h=h, **gate), cs.BLOCK),
             "fir_gate_step_fused + envelope": (
                 FIRGateStage(h=h, env_h=design_fir(cs.ENV_TAPS, 0.01), **gate), cs.BLOCK),
             "res_fir_gate_step_fused": (ResFIRGateStage(cs.UP, cs.DOWN, h=h, **gate),
                                         cs.RES_BLOCK),
             "gate_step_fused": (GateStage(fused=True, **gate), cs.BLOCK),
             "stretch_step_fused 4/3": (StretchStage(4, 3, nfft=cs.NFFT, hop=cs.HOP, fused=True),
                                        cs.BLOCK),
             "stretch_step_fused 147/160": (
                 StretchStage(147, 160, nfft=cs.NFFT, hop=cs.HOP, fused=True), 147 * cs.HOP),
             "gate_step_fused 8192": (GateStage(fused=True, noise_frames=cs.NOISE_FRAMES, **big),
                                      16 * 2048),
             "stretch_step_fused 4/3 8192": (StretchStage(4, 3, fused=True, **big), 16 * 2048)}
    step_arms = {}
    for name, (stage, block) in steps.items():
        sc = Chain([stage])
        xb = torch.as_tensor(np.random.default_rng(9).standard_normal(
            (64, (cs.STEP_WARM + 1) * block)), dtype=torch.float32, device=dev)
        st = sc.init_state((64,), block, torch.float32, dev)
        for k in range(cs.STEP_WARM):
            st, _ = sc.step(st, xb[:, k * block:(k + 1) * block])
        step_arms[name] = (lambda sc=sc, st=st, xl=xb[:, cs.STEP_WARM * block:]:
                           sc.step(st, xl))
    from audiosignalprocess_tpu_torch.kernels import stretch_kernel as sk
    for name, mod, info in (("fir_gate_step_fused", ck, "fir_gate_step_info"),
                            ("res_fir_gate_step_fused", rk, "res_fir_gate_step_info"),
                            ("gate_step_fused", gk, "gate_step_info"),
                            ("stretch_step_fused", sk, "stretch_step_info")):
        if hasattr(mod, info):  # a checkout with the step on the batched body
            print(f"[ab chain] {name} on {smi}: {getattr(mod, info)(device=dev)}")
    for name, mod, info in (("gate_step_fused", gk, "gate_step_info"),
                            ("stretch_step_fused", sk, "stretch_step_info")):
        if hasattr(mod, info):
            print(f"[ab chain] {name} nfft 8192 on {smi}: "
                  f"{getattr(mod, info)(nfft=8192, hop=2048, device=dev)}")
    only = [a for a in sys.argv if a.startswith("--only=")]
    if only:  # the arms named (substrings) alone
        keep = only[0][len("--only="):].split(",")
        arms = {a: f for a, f in arms.items() if any(k in a for k in keep)}
        step_arms = {a: f for a, f in step_arms.items() if any(k in a for k in keep)}
    got = {arm: [] for arm in [*arms, *step_arms]}
    for _ in range(6):
        for arm, fn in arms.items():
            got[arm].append((queued_ms(fn, reps=10, cycles=10 ** 8),  # the prologue's host time
                             cs.time_ms(fn, reps=10, warmup=2)))
        for arm, fn in step_arms.items():
            got[arm].append((queued_ms(fn, reps=20, cycles=10 ** 8),
                             cs.time_ms(fn, reps=20, warmup=2)))
    print(f"[ab chain] {smi}, 6 reps round-robin, medians: " + "; ".join(
        f"{arm} queued device {np.median([r[0] for r in v]):.4f} ms (reps "
        f"{', '.join(f'{r[0]:.4f}' for r in v)}), time_ms {np.median([r[1] for r in v]):.4f} ms"
        for arm, v in got.items()))
    sys.exit(0)

sizes = [int(a) for a in sys.argv[1:] if a.isdigit()] or [1024, 4096]
for n in sizes:
    xr = torch.randn(4096, n, device=dev)
    sr, si = fk.rfft_stockham(xr)
    spec = torch.complex(sr, si)
    zr, zi = sr[:, : n // 2].contiguous(), si[:, : n // 2].contiguous()  # the same points, complex
    nbytes = 4 * 4096 * (n + 2 * (n // 2 + 1))
    arms = {"rfft_stockham": lambda: fk.rfft_stockham(xr),
            "torch.fft.rfft": lambda: torch.fft.rfft(xr),
            "irfft_stockham": lambda: fk.irfft_stockham(sr, si, n),
            "torch.fft.irfft": lambda: torch.fft.irfft(spec, n),
            f"fft_stockham_lanes 4096x{n // 2}": lambda: fk.fft_stockham_lanes(zr, zi, -1.0),
            "ops.fft.rfft": lambda: ops_fft.rfft(xr),
            "ops.fft.irfft": lambda: ops_fft.irfft(spec, n)}
    got = {arm: [] for arm in arms}
    for _ in range(6):
        for arm, fn in arms.items():
            pre = probe()
            ms = cs.time_ms(fn, reps=10, warmup=2)
            post = probe()
            got[arm].append((ms, nbytes / ms * 1e3 / (0.5 * (pre + post)), queued_ms(fn)))
    print(f"[ab real] 4096x{n} f32 on {smi}, 6 reps round-robin, medians: " + "; ".join(
        f"{arm} {np.median([r[0] for r in v]):.4f} ms = "
        f"{np.median([r[1] for r in v]) * 100:.1f} % of the paired probe "
        f"(reps {', '.join(f'{r[0]:.4f}' for r in v)}), queued device "
        f"{np.median([r[2] for r in v]):.4f} ms (reps {', '.join(f'{r[2]:.4f}' for r in v)})"
        for arm, v in got.items()))
"""

def sass_kernels(lib: Path, tools: Path) -> dict:
    """Each kernel's SASS in a built library: {key: instructions}, the key
    its demangled name without parameters and with a thread-count template
    argument of 256 dropped, the instructions without addresses or
    encodings."""
    import re

    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)):
            funcs[name].append(m[1])
    names = list(funcs)
    plain = subprocess.run([str(tools / "cu++filt")], input="".join(n + "\n" for n in names),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    key = lambda d: re.sub(r", (\(int\))?256>$", ">",
                           re.sub(r"^void |\([^()]*\)$", "", d.strip()))
    return {key(d): funcs[n] for n, d in zip(names, plain)}


def sass_compare(roots: list[str]) -> None:
    """[ab sass]: the first checkout's kernels against each other one's."""
    from audiosignalprocess_tpu_torch.kernels._build import _nvcc

    tools = Path(_nvcc()).parent
    libs = [max((Path(r) / "audiosignalprocess_tpu_torch" / "_build").glob("libasp_kernels_*.so"),
                key=lambda f: f.stat().st_mtime) for r in roots]
    base = sass_kernels(libs[0], tools)
    for root, lib in zip(roots[1:], libs[1:]):
        other = sass_kernels(lib, tools)
        same = sorted(k for k in base.keys() & other.keys() if base[k] == other[k])
        diff = sorted(k for k in base.keys() & other.keys() if base[k] != other[k])
        print(f"[ab sass] {roots[0]} against {root}: {len(same)} kernels identical, "
              f"{len(diff)} differ, {len(base.keys() - other.keys())} only in the first, "
              f"{len(other.keys() - base.keys())} only in the second")
        for k in same:
            print(f"[ab sass] identical: {k} ({len(base[k])} instructions)")
        for k in diff:
            a, b = base[k], other[k]
            n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            print(f"[ab sass] differs: {k}: {len(a)} against {len(b)} instructions, "
                  f"{n} differ in place, the first at {i}: {a[i:i + 3]} against {b[i:i + 3]}")


SHOWN = ("[16 times] fft_stockham_lanes", "[16 times] rfft_stockham",
         "[16 times] irfft_stockham", "[16 times] bench.py", "[16 times] copy probe",
         "[25 times]", "[14 kernel] FFT worst", "[14 real] worst",
         "[25 kernel] fft_stockham_manual worst", "[ab real]", "[ab ptxas]", "[ab chain]",
         "[5 times]", "[13 times] whole")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="+", metavar="ROOT",
                   help="checkout roots, the parent's first (two or more)")
    p.add_argument("--out", default="_scratch/fft_ab", help="directory for the runs' logs")
    p.add_argument("--quick", action="store_true", help="only the [ab real] timing")
    p.add_argument("--sizes", type=int, nargs="+", default=[1024, 4096],
                   help="row lengths of the [ab real] timing (4096 rows each)")
    p.add_argument("--chain", action="store_true",
                   help="time the whole-file chain kernels ([ab chain]) instead")
    p.add_argument("--sass", action="store_true",
                   help="then compare the built libraries' SASS ([ab sass])")
    p.add_argument("--only", default=None,
                   help="with --chain: time only the arms whose names hold one of these "
                        "comma-separated substrings")
    args = p.parse_args(argv)
    if len(args.roots) < 2:
        p.error("two or more checkouts")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "ASP_SK_PIPE"}
    roots = args.roots + args.roots[::-1]
    labels = ["parent", "change"] if len(args.roots) == 2 else [Path(r).name for r in args.roots]
    labels = labels + labels[::-1]
    child = ([sys.executable, "-c", CHILD] + (["--quick"] if args.quick else [])
             + (["--chain"] if args.chain else []) + ([f"--only={args.only}"] if args.only else [])
             + [str(n) for n in args.sizes])
    for i, (label, root) in enumerate(zip(labels, roots)):
        proc = subprocess.run(child, cwd=root, env=env, capture_output=True, text=True)
        log = out / f"fft_ab_{i}_{label}.log"
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        for line in proc.stdout.splitlines():
            if line.startswith(SHOWN):
                print(f"[{i} {label}] {line}")
        if proc.returncode != 0:
            print(f"[{i} {label}] exit {proc.returncode}; see {log}:\n{proc.stderr[-3000:]}")
            return 1
    if args.sass:
        sass_compare(args.roots)
    return 0


if __name__ == "__main__":
    sys.exit(main())
