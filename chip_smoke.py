"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audiosignalprocess_tpu_torch/csrc``
with nvcc (one compile per source, in parallel), checks each kernel
against its plain PyTorch version on the card, and drives the port's
paths through the user entry points at 64 channels x 10 s of 48 kHz
audio, counting the kernel launches of each run:

- the whole-file FIR -> noise-gate chain (``Chain.full_flush``,
  ``api.chain_file``): ``fir_noise_gate_fused``;
- path A, block streaming of the composite stage (``Chain.stream`` of
  ``FIRGateStage``, ``api.chain_file(block=...)``):
  ``fir_gate_step_fused`` per block, the envelope folded in;
- path B, the same chain stage by stage: ``overlap_save_fused``,
  ``gate_step_fused`` and ``fir_mac`` per block;
- the config-5 resampler front end, 64 channels x 10 s of 44.1 kHz audio
  to 48 kHz (``ResFIRGateStage`` at 160/147): path 1, the whole file
  (``resample_fir_gate_fused``, then ``fir_mac`` for the envelope); path
  C, ``res_fir_gate_step_fused`` per block, the envelope folded in; path
  D, ``ResampleStage(fused=True) -> FIRGateStage``: ``resample_mac`` and
  ``fir_gate_step_fused`` per block (``resample_mac`` and
  ``fir_noise_gate_fused`` for the whole file); ``api.chain_file`` across
  rates and ``api.resample_file``;
- the config-3 gate alone, 8 and 64 channels x 10 s at 48 kHz
  (``Chain([GateStage(fused=True)]).full_flush``, ``api.noise_gate_file``):
  ``noise_gate_fused``; the FFT family behind ``ops.fft``'s default
  ``impl="auto"`` (``GateStage(fused=False).full``, ``ops.overlap_save``,
  ``api.lowpass_file``: ``rfft_stockham`` + ``irfft_stockham``;
  ``ops.fft.fft``/``ifft``: ``fft_stockham_lanes``), ``api.bandpass_file``
  and ``api.envelope_file`` (``fir_mac``), and bench.py's True and False
  modes through the port;
- the phase vocoder at 64 x 480000: streams S1 (speed-up 4/3, block
  4096), S2 (slow-down 3/4, block 4608) and S3 (stretch 1/2 then resample
  1/2, an octave up): ``stretch_step_fused`` per block (and
  ``resample_mac`` on S3); the whole-file ``StretchStage.full_flush``,
  ``api.time_stretch_file`` (``rfft_stockham`` + ``irfft_stockham``) and
  ``api.pitch_shift_file`` (those and ``resample_mac``);
- the sharded whole-file program (``parallel``): ``gate_shard_fused`` on
  the four time shards of 64 x 479232; a one-rank NCCL group on a 1x1
  mesh (``sharded_noise_gate(fused=True)``: ``noise_gate_fused``;
  ``sharded_chain`` of the config-5 composite at 64 x 441000 -> 480000:
  ``resample_mac``, ``overlap_save_fused`` and ``gate_shard_fused``); four
  ranks sharing the card over gloo (``spawn_local``) on (1, 4) and (2, 2)
  meshes: the time-sharded gate, config 4's halo'd overlap-save (64 x
  384000 at 96 kHz, 4096 taps, nfft 16384) and the sharded config-5
  chain; the config-3 and config-4 drivers with ``--check``, and config 4
  under torchrun with four ranks;
- the FFT variant impls of ``ops.fft`` (the JAX package's ``pallas``,
  ``pallas_r2``, ``pallas_r2_stages``, ``pallas_cg``): ``fft_fourstep``,
  ``fft_radix2_lanes``, ``fft_radix2_stages`` and ``fft_pease_lanes``,
  each checked alone (at every n to 16384 and at the slice's rows, and
  ``fft_radix2_stages`` bit for bit against ``fft_radix2_lanes``) and
  driving the unfused chain ``FIRStage(nfft=1024, impl=X) ->
  GateStage(impl=X)`` at 64 x 480000 (``bench.py``'s False mode with
  ``impl=X``): four launches of the variant's kernel per call, on the
  512-point rows of the real transforms;
- ``fft_stockham_manual``, the copy-ring Stockham kernel, at the ring's
  edges and at the rows the main path and the timings give it, and the
  same chain with ``impl="stockham_split"`` (the JAX
  package's hardware route for real transforms) under
  ``ASP_SK_PIPE=manual``: four launches of it per call, none of
  ``fft_stockham_lanes``; timed beside the grid kernel and torch.fft in
  the JAX A/B's protocol (arms round-robin, each bracketed by a copy
  probe).

- configs 1, 2 and 5 through the port's drivers (phase 27): config 1's
  overlap-save (``overlap_save_fused``), config 2's zero-phase resampler
  and bandpass (``resample_mac``, ``fir_mac``) and config 5 at 128 x
  169344, streamed by the four stages (``resample_mac``,
  ``overlap_save_fused``, ``gate_step_fused``, ``fir_mac`` a block) and
  by the composite (``res_fir_gate_step_fused`` a block), sharded on a
  one-rank NCCL group, and behind the native decode thread and SPSC ring
  (``run_ring``: against ``Chain.stream``, K = 3, a restart from a carry
  checkpoint, drained), each with exact launch counts; then the drivers
  as processes (config 5 sharded also under torchrun on four gloo ranks)
  and the scaling harness;

- the unfused float32 routes (phase 28): path A as
  ``FIRGateStage(fused=False)`` at 64 x 480000, whole file and drained
  stream, and config 5 as ``run_config_5``'s ``--composite --no-fused``
  chain at 128 x 169344 (stream and ring, then the driver's ring process):
  two ``rfft_stockham`` and two ``irfft_stockham`` a call or a block; the
  unfused ``GateStage`` and ``StretchStage(4, 3)`` steps under ``auto``
  and each kernel impl at 64 channels in blocks of 4096 and 128 in blocks
  of 10240: one real-transform pair a block on the impl's kernel; each
  block's launches checked, no fused kernel and no torch.fft call, every
  channel against the float64 plain chain, ``auto`` timed beside the
  fused route;

- the whole-file kernels on the batched body at nfft 8192, hop 2048 (one
  transform of 512 threads a batch, one exchange buffer, the span in
  device memory: phase 26):
  ``noise_gate_fused``, ``fir_noise_gate_fused``,
  ``resample_fir_gate_fused`` and ``gate_shard_fused`` against their
  plain versions, each raising a ValueError naming SMEM_LIMIT at nfft
  16384, and their device time at 64 x 480000.

It times each kernel against its plain version, each path per stream, and
the FFTs against torch.fft and a copy-bandwidth probe.  Every phase prints
its lines and raises on failure.  The second-to-last line is the kernels'
JSON record, each kernel with its bound (``bound_ms``, ``bound_by``: the
larger of its bytes over the memory rate and its float32 operations over
the float32 peak, the H100 SXM's published figures in ``utils.metrics``) and,
where one PyTorch call computes the same function, that call's time
(``library_ms``), and for the real FFT kernels both again on launches
queued behind a sleep of the card (``device_ms``, ``library_device_ms``);
``device_ms`` is also the queued device time of a whole-file call of the
chain and gate kernels, and for the six stream kernels that of one launch
at its stream's block shape (phase 9b, which ranks them by launches x
(device time - bound) a launch, and gives the step kernels', the
overlap-save kernel's and the MAC's registers, local bytes and CTAs an
SM); the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device it exits
1 and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FS = 48000
SNR_MIN_DB = 60.0  # float32 kernel vs float64 plain version; the gate's
# hard thresholds make bit-level parity meaningless (a few borderline bins
# flip), so the bar is the oracle-parity SNR the repo uses everywhere
HEADLINE = (64, 480000)  # 64 channels x 10 s at 48 kHz (bench.py)
NFFT, HOP, TAPS, NOISE_FRAMES = 1024, 256, 64, 8
BLOCK, ENV_TAPS = 4096, 129  # bench.py's stream modes: block 4096, design_fir(129, 0.01)
LINEAR_MIN_DB = 100.0  # fir_mac and overlap_save_fused are linear: no gate decisions


def tone_burst(rng, c, n):
    """Tone burst in low noise (the kernel tests' signal)."""
    t = np.arange(n) / FS
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / FS) & (t < 0.7 * n / FS),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def oracle_chain(x, h, nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES,
                 threshold_db=6.0, reduction_db=60.0):
    """The float64 numpy oracle chain, written out with numpy's own FFT and
    a direct convolution: causal FIR, then the STFT gate with WOLA."""
    from audiosignalprocess_tpu_torch.ops.stft import wola_clamp
    from audiosignalprocess_tpu_torch.ops.windows import window_np

    n = x.shape[-1]
    y = np.stack([np.convolve(xc, h)[:n] for xc in x])
    w = window_np("hann", nfft, periodic=True)
    nf = 1 + (n - nfft) // hop
    idx = np.arange(nfft)[None, :] + hop * np.arange(nf)[:, None]
    spec = np.fft.rfft(y[:, idx] * w)
    mag = np.abs(spec)
    floor = mag[:, :noise_frames].mean(axis=1, keepdims=True)
    mask = np.where(mag > floor * 10 ** (threshold_db / 20), 1.0,
                    10 ** (-reduction_db / 20))
    frames = np.fft.irfft(spec * mask, nfft) * w
    out = np.zeros((x.shape[0], nfft + (nf - 1) * hop))
    norm = np.zeros(out.shape[-1])
    for k in range(nf):
        out[:, k * hop : k * hop + nfft] += frames[:, k]
        norm[k * hop : k * hop + nfft] += w * w
    return out / wola_clamp(norm)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of fn() over reps calls, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def copy_probe(dev):
    """() -> bytes/s of a 256 MB device copy (read + write), timed anew at
    each call."""
    src = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    return lambda: 2 * src.numel() * 4 / time_ms(lambda: dst.copy_(src), reps=10, warmup=2) * 1e3


def queued_ms(fn, reps=20, cycles=10 ** 7):
    """Device time of fn() over reps calls queued while the card sleeps
    (torch.cuda._sleep(cycles), about 5 ms at 2 GHz by default): the events
    bracket device work only, so a kernel shorter than its launch's host
    cost is timed as the card runs it.  A wrapper with a long host prologue
    needs the sleep to outlast the enqueue of all reps calls."""
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


def round_robin(arms, nbytes, probe, reps, timer=None):
    """Time each arm (name: fn) ``reps`` times in turns, each timing
    (``timer(fn)``, else time_ms over 10 calls) bracketed by its own copy
    probe; per arm the medians (ms, bytes/s as a share of the mean of its
    two probes) and every rep's ms, and the probes' range (bytes/s)."""
    timer = timer or (lambda fn: time_ms(fn, reps=10, warmup=2))
    got = {arm: [] for arm in arms}
    probes = []
    for _ in range(reps):
        for arm, fn in arms.items():
            pre = probe()
            ms = timer(fn)
            post = probe()
            got[arm].append((ms, nbytes / ms * 1e3 / (0.5 * (pre + post))))
            probes += [pre, post]
    med = {arm: (float(np.median([r[0] for r in v])), float(np.median([r[1] for r in v])),
                 [r[0] for r in v]) for arm, v in got.items()}
    return med, (min(probes), max(probes))


def round_robin_text(med, probes):
    return "; ".join(f"{arm} {ms:.4f} ms = {frac * 100:.1f} % of the paired probe (reps "
                     f"{', '.join(f'{r:.4f}' for r in each)} ms)"
                     for arm, (ms, frac, each) in med.items()) + (
        f"; probe {probes[0] / 1e12:.4f} to {probes[1] / 1e12:.4f} TB/s")


def stream_ms(fn, reps=3):
    """Mean device time of a whole stream fn() over reps runs, after one
    warm-up run (CUDA events around the loop of blocks)."""
    return time_ms(fn, reps=reps, warmup=1)


def decision_flips(g_in, nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES,
                   threshold_db=6.0):
    """Gate decisions (|X| > floor * threshold) of the plain whole-file gate
    on the gate's input g_in, float32 against float64: the count of bins
    float32 rounding flips on this input, among the bins within 60 dB of
    their channel's peak (in a filter's stopband the rounding is the
    signal, and flips there carry no energy)."""
    from audiosignalprocess_tpu_torch.ops.stft import stft

    dec, mag64 = [], None
    for dt in (torch.float32, torch.float64):
        mag = stft(g_in.to(dt), nfft, hop, impl="torch").abs()
        floor = mag[..., :noise_frames, :].mean(dim=-2, keepdim=True)
        dec.append(mag > floor * 10.0 ** (threshold_db / 20.0))
        mag64 = mag
    loud = mag64 > 1e-3 * mag64.amax(dim=(-2, -1), keepdim=True)
    return int(((dec[0] != dec[1]) & loud).sum())


def flips_text(snr, flips):
    """The flipped bins beside a gate reading (the plain gate's, float32
    against float64: a kernel's own float32 rounding may flip others), and
    where it counts none whether the reading holds 100 dB."""
    return f" decision_flips_f32_vs_f64={flips}" + (
        "" if flips else f" (none counted: >= 100 dB {'held' if snr >= 100.0 else 'not held'})")


def chain_ptxas(log, kernel):
    """ptxas's registers and spills of each instantiation of a kernel on the
    batched bodies (``kernel``: its function's name) in the build log (none
    where this process did not build): <R, RS, release> of the whole-file
    kernels (``fir_noise_gate_kernel``, ``res_fir_noise_gate_kernel``,
    ``noise_gate_kernel``; <R, RS, release, 512> for the 512-thread one of
    nfft 8192), <R, RS, threads> of the step kernels
    (``fir_gate_step_kernel``, ``res_fir_gate_step_kernel``: a cluster of
    two CTAs a channel at 256 threads, one CTA at 512), <outputs,
    super-cycles a thread> of ``resample_mac_kernel``."""
    import re

    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            ent = line.split("'")[1]
            hit = f"{len(kernel)}{kernel}I" in ent  # the mangled name's identifier
            m = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E(?:Li(\d+)E)?", ent)
            step = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", ent)
            if hit and m:
                threads = f",{m[4]}" if m[4] and m[4] != "256" else ""
                name = f"<{m[1]},{m[2]},{m[3]}{threads}>"
            elif hit and step:
                name = f"<{step[1]},{step[2]},{step[3]}>"
            else:
                two = re.search(r"ILi(\d+)ELi(\d+)EE", ent)
                name = f"<{two[1]},{two[2]}>" if hit and two else None
        elif name and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif name and "Used" in line:
            out.append(f"{name} {line.split('Used')[1].split(',')[0].strip()} {spill}")
            name = None
    return "; ".join(out) if out else "not built in this process"


def check_kernel(record, phase, name, y, ref, kernel, before, calls, bar, extra=""):
    """One kernel result against its float64 plain version ``ref``: print
    the line, raise SystemExit unless shape, finiteness, the SNR bar and
    the launch count (``calls`` since ``before``) hold, and fold the error
    and SNR into ``record``."""
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    snr = snr_db(ref, y)
    err = float((y.double() - ref).abs().max())
    line = (f"[{phase} kernel] {name}: shape {tuple(y.shape)} launches "
            f"{kernel.launches - before}/{calls} snr_vs_f64_plain={snr:.2f} dB "
            f"max_abs_err={err:.3e}{extra}")
    print(line)
    if not (tuple(y.shape) == tuple(ref.shape) and bool(torch.isfinite(y).all())
            and snr >= bar and kernel.launches - before == calls):
        raise SystemExit(f"phase {phase} failed: {line}")
    rec = record.setdefault(kernel.__name__, dict(max_abs_err=0.0, min_snr_db=np.inf))
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["min_snr_db"] = min(rec["min_snr_db"], snr)


def idle_text(share):
    return ("not measured (no device activity in the profile)" if share is None
            else f"{share * 100:.1f} %")


def device_idle_share(fn):
    """Share of the span from the first to the last device activity of
    fn() in which the device runs nothing (torch.profiler); None when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return 1.0 - busy / (cur_e - spans[0][0])


FS_IN = 44100  # config 5: a 44.1 kHz file resampled to 48 kHz at 160/147
UP, DOWN = 160, 147
RES_HEADLINE = (64, 441000)  # 10 s at 44.1 kHz -> (64, 480000), bench.py's res_* modes
RES_BLOCK = 4704  # 8 * 588 raw samples -> 5120 resampled, bench.py's res_step
RES_OUT = -(-RES_HEADLINE[1] * UP // DOWN)  # 480000 at 48 kHz


def upfirdn_oracle(x, h, up, down):
    """The causal polyphase resample written as zero-stuff -> filter ->
    decimate with scipy's upfirdn, independent of the port's code:
    ceil(n*up/down) samples."""
    from scipy.signal import upfirdn

    n_out = -(-x.shape[-1] * up // down)
    return np.stack([upfirdn(h, r, up, down)[:n_out] for r in x])


def resampler_phases(dev, smi, rng, record, kernels, reset_counts, wav_x48, log=""):
    """Phases 10-13: the config-5 resampler front end (resample_mac,
    resample_fir_gate_fused, res_fir_gate_step_fused).  Adds the three
    kernels to ``record``; raises SystemExit on a failure."""
    from audiosignalprocess_tpu_torch import api
    from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
        fir_gate_step_fused, fir_noise_gate_fused,
    )
    from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac
    from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
        res_fir_gate_step_fused, resample_fir_gate_fused, resample_fir_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import (
        resample_mac, resample_mac_ref,
    )
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.ops.resample import history_len, resample_filter
    from audiosignalprocess_tpu_torch.pipeline import (
        Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage, ResampleStage,
        ResFIRGateStage,
    )
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    h, h_env = design_fir(TAPS, 0.3), design_fir(ENV_TAPS, 0.01)
    gate = dict(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES)
    c = RES_HEADLINE[0]

    # ---- phase 10: the three kernels vs their float64 plain versions on
    # the card, at the shapes the paths give them
    for up, down, n, mode in ((UP, DOWN, RES_BLOCK, "history"), (DOWN, UP, 4800, "history"),
                              (UP, DOWN, RES_HEADLINE[1], "causal"),
                              (DOWN, UP, RES_HEADLINE[1], "zero_phase")):
        x64 = torch.as_tensor(rng.standard_normal((c, n)), device=dev)
        hist = None
        if mode == "history":
            hn = history_len(len(resample_filter(up, down)), up, down)
            hist = torch.as_tensor(rng.standard_normal((c, hn)), device=dev)
        zp = mode == "zero_phase"
        before = resample_mac.launches
        y = resample_mac(x64.float(), up, down, zero_phase=zp,
                         history=None if hist is None else hist.float())
        torch.cuda.synchronize()
        extra = ""
        if mode == "causal":
            oracle = upfirdn_oracle(x64[:2].cpu().numpy(), resample_filter(up, down), up, down)
            extra = f" snr_vs_f64_upfirdn(2 rows)={snr_db(oracle, y[:2]):.2f} dB"
        check_kernel(record, 10, f"resample_mac {up}/{down} {c}x{n} {mode}", y,
                     resample_mac_ref(x64, up, down, zero_phase=zp, history=hist),
                     resample_mac, before, 1, LINEAR_MIN_DB, extra)

    for ch, n, up, down, taps, release, nfft, hop in (
            (2, 47040, UP, DOWN, TAPS, 0.0, NFFT, HOP),
            (2, 16384, 2, 1, 96, 0.7, NFFT, HOP),
            (1, 47040, UP, DOWN, 384, 0.0, NFFT, HOP),
            (*RES_HEADLINE, UP, DOWN, TAPS, 0.0, NFFT, HOP),
            (2, 47040, UP, DOWN, TAPS, 0.0, 256, 64),
            (3, 47040, UP, DOWN, TAPS, 0.6, 512, 128),
            (1, 47040, UP, DOWN, 30, 0.0, NFFT, 512),
            (2, 55125, UP, DOWN, TAPS, 0.0, 2048, 256)):
        hc = design_fir(taps, {TAPS: 0.3, 96: 0.25, 384: 0.2, 30: 0.3}[taps])
        x64 = torch.as_tensor(tone_burst(rng, ch, n), device=dev)
        before = (resample_fir_gate_fused.launches, resample_mac.launches)
        y = resample_fir_gate_fused(x64.float(), up, down, hc, nfft=nfft, hop=hop,
                                    release=release)
        torch.cuda.synchronize()
        if resample_mac.launches != before[1]:
            raise SystemExit("phase 10 failed: the whole-file kernel's floor launched resample_mac")
        ref = resample_fir_gate_ref(x64, up, down, hc, nfft=nfft, hop=hop, release=release)
        flips = decision_flips(FIRStage(h=hc, nfft=nfft).full(ResampleStage(up, down).full(x64)),
                               nfft, hop)
        extra = flips_text(snr_db(ref, y), flips)
        if (ch, n, nfft) == (2, 47040, NFFT) and taps == TAPS:
            u = upfirdn_oracle(x64.cpu().numpy(), resample_filter(up, down), up, down)
            extra += f" snr_vs_f64_oracle={snr_db(oracle_chain(u, hc), y):.2f} dB"
        check_kernel(record, 10, f"resample_fir_gate_fused {up}/{down} {ch}x{n} nfft={nfft} "
                     f"hop={hop} taps={taps} release={release}", y, ref,
                     resample_fir_gate_fused, before[0], 1, SNR_MIN_DB, extra)

    n_short = 16 * RES_BLOCK
    x_short = torch.as_tensor(tone_burst(rng, c, n_short), device=dev)
    x_drain = x_short[:, : n_short - 1234]
    for release in (0.0, 0.6):
        for drain in (False, True):
            xs = x_drain if drain else x_short
            flips = decision_flips(FIRStage(h=h, nfft=NFFT).full(
                ResampleStage(UP, DOWN).full(xs)))
            for env_h in (None, h_env):
                chain_s = Chain([ResFIRGateStage(UP, DOWN, h=h, env_h=env_h,
                                                 release=release, **gate)])
                chain_s.build()
                calls = (chain_s.drain_blocks(xs.shape[-1], RES_BLOCK) if drain
                         else xs.shape[-1] // RES_BLOCK)
                before = res_fir_gate_step_fused.launches
                y = chain_s.stream(xs.float(), RES_BLOCK, drain=drain)
                torch.cuda.synchronize()
                ref = chain_s.stream(xs, RES_BLOCK, drain=drain)  # float64: the plain composition
                check_kernel(record, 10, f"res_fir_gate_step_fused release={release} "
                             f"drain={drain} env={env_h is not None}", y, ref,
                             res_fir_gate_step_fused, before, calls, SNR_MIN_DB,
                             f" decision_flips_f32_vs_f64={flips}")

    # ---- phase 11: paths 1, C and D at the full width (64 x 441000 at
    # 44.1 kHz -> 64 x RES_OUT = 480000), each driven with every count at 0 just
    # before and read just after
    n = RES_HEADLINE[1]
    x_res = torch.as_tensor(tone_burst(rng, *RES_HEADLINE), dtype=torch.float32, device=dev)

    def res_chain(env_h=None):
        return Chain([ResFIRGateStage(UP, DOWN, h=h, env_h=env_h, **gate)])

    def path_d():
        return Chain([ResampleStage(UP, DOWN, fused=True), FIRGateStage(h=h, **gate)])

    runs = {}
    for name, make, drained, on_path in (
            ("1", res_chain, False, {resample_fir_gate_fused: 1}),
            ("1+env", lambda: res_chain(h_env), False, {resample_fir_gate_fused: 1, fir_mac: 1}),
            ("C", res_chain, True, {res_fir_gate_step_fused: None}),
            ("C+env", lambda: res_chain(h_env), True, {res_fir_gate_step_fused: None}),
            ("D", path_d, True, {resample_mac: None, fir_gate_step_fused: None}),
            ("D whole", path_d, False, {resample_mac: 1, fir_noise_gate_fused: 1})):
        chain_p = make()
        chain_p.build()
        blocks = chain_p.drain_blocks(n, RES_BLOCK)
        reset_counts()
        y = (chain_p.stream(x_res, RES_BLOCK, drain=True) if drained
             else chain_p.full_flush(x_res))
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        want = {k.__name__: (blocks if on_path.get(k, 0) is None else on_path.get(k, 0))
                for k in kernels}
        runs[name] = (y, counts)
        mode = f"Chain.stream(drain=True) blocks={blocks}" if drained else "Chain.full_flush"
        line = f"[11 path {name}] {mode} {tuple(y.shape)} launches={counts}"
        print(line)
        if counts != want or tuple(y.shape) != (c, RES_OUT) or not bool(torch.isfinite(y).all()):
            raise SystemExit(f"phase 11 failed: {line} (want {want})")
    ref1 = res_chain().full_flush(x_res.double())
    for name, ref in (("1 vs float64 plain", ref1), ("C vs 1", runs["1"][0]),
                      ("C+env vs 1+env", runs["1+env"][0]), ("D vs D whole", runs["D whole"][0]),
                      ("D vs 1", runs["1"][0])):
        snr = snr_db(ref, runs[name.split()[0]][0])
        line = f"[11 path {name}] on the card: snr={snr:.2f} dB"
        print(line)
        if snr < SNR_MIN_DB:
            raise SystemExit(f"phase 11 failed: {line}")
    record["resample_fir_gate_fused"]["launches"] = runs["1"][1]["resample_fir_gate_fused"]
    record["res_fir_gate_step_fused"]["launches"] = runs["C"][1]["res_fir_gate_step_fused"]
    record["resample_mac"]["launches"] = runs["D whole"][1]["resample_mac"]  # per file, as ms

    # ---- phase 12: api.chain_file across rates and api.resample_file,
    # cuda vs cpu
    wav_x = tone_burst(rng, 8, 2 * FS_IN).astype(np.float32) * 0.5
    with tempfile.TemporaryDirectory() as tmp:
        p44, p48 = str(Path(tmp) / "in44.wav"), str(Path(tmp) / "in48.wav")
        write_wav(p44, wav_x, FS_IN, float_fmt=True)
        write_wav(p48, wav_x48, FS, float_fmt=True)
        for fn, p_in, kw, rate_out in (
                (api.chain_file, p44, dict(rate_out=FS), FS),
                (api.chain_file, p44, dict(rate_out=FS, block=RES_BLOCK), FS),
                (api.chain_file, p44, dict(rate_out=FS, envelope_hz=50.0), FS),
                (api.chain_file, p48, dict(rate_out=FS_IN), FS_IN),
                (api.resample_file, p44, dict(rate_out=FS), FS)):
            outs = {}
            reset_counts()
            for d in ("cuda", "cpu"):
                fn(p_in, str(Path(tmp) / f"{d}.wav"), device=d, float_fmt=True, **kw)
                outs[d], rate = read_wav(str(Path(tmp) / f"{d}.wav"), dtype=np.float64)
            counts = {k.__name__: k.launches for k in kernels if k.launches}
            snr = snr_db(outs["cpu"], outs["cuda"])
            n_in = wav_x.shape[-1] if p_in == p44 else wav_x48.shape[-1]
            in_rate = FS_IN if p_in == p44 else FS
            line = (f"[12 api.{fn.__name__}] {in_rate} Hz 8x{n_in} {kw}: launches={counts} "
                    f"shape={outs['cuda'].shape} snr_vs_cpu_plain={snr:.2f} dB")
            print(line)
            if (snr < SNR_MIN_DB or rate != rate_out or not counts
                    or outs["cuda"].shape != (8, -(-n_in * rate_out // in_rate))):
                raise SystemExit(f"phase 12 failed: {line}")

    # ---- phase 13: times on bench.py's white noise, 64 x 441000 at 44.1 kHz
    noise = np.random.default_rng(0).standard_normal(RES_HEADLINE).astype(np.float32)
    xn = torch.as_tensor(noise, device=dev)
    samples = RES_HEADLINE[0] * RES_OUT  # output samples
    ms = time_ms(lambda: resample_fir_gate_fused(xn, UP, DOWN, h))
    plain_ms = time_ms(lambda: resample_fir_gate_ref(xn, UP, DOWN, h))
    two = path_d()
    two.build()
    two_ms = time_ms(lambda: two.full_flush(xn))
    device_ms = queued_ms(lambda: resample_fir_gate_fused(xn, UP, DOWN, h), reps=10,
                          cycles=10 ** 8)
    two_device_ms = queued_ms(lambda: two.full_flush(xn), reps=10, cycles=10 ** 8)
    print(f"[13 times] whole file {RES_HEADLINE[0]}x{RES_HEADLINE[1]} -> {RES_OUT} f32 white "
          f"noise on {smi}: resample_fir_gate_fused {ms:.4f} ms "
          f"({samples / ms * 1e3:.4e} out samples/s), plain {plain_ms:.4f} ms, "
          f"res_two (resample_mac + fir_noise_gate_fused) {two_ms:.4f} ms; device time of "
          f"queued calls: resample_fir_gate_fused {device_ms:.4f} ms, res_two "
          f"{two_device_ms:.4f} ms")
    record["resample_fir_gate_fused"].update(ms=ms, plain_ms=plain_ms, device_ms=device_ms)
    from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import resample_fir_gate_info

    print(f"[13 kernel] resample_fir_gate_fused {UP}/{DOWN} on {smi}, from the CUDA runtime "
          f"(registers, local bytes a thread, CTAs an SM by the occupancy API): parallel "
          f"launch {resample_fir_gate_info(UP, DOWN, h, device=dev)}, sequential (release > 0) "
          f"{resample_fir_gate_info(UP, DOWN, h, release=0.6, device=dev)}; ptxas <R,RS>: "
          f"{chain_ptxas(log, 'res_fir_noise_gate_kernel')}")
    mac_ms = time_ms(lambda: resample_mac(xn, UP, DOWN, zero_phase=False))
    mac_plain_ms = time_ms(lambda: resample_mac_ref(xn, UP, DOWN, zero_phase=False))
    mac_device_ms = queued_ms(lambda: resample_mac(xn, UP, DOWN, zero_phase=False), reps=10,
                              cycles=10 ** 8)
    conv = resample_conv1d(xn, UP, DOWN, resample_filter(UP, DOWN), zero_phase=False)
    conv_snr = snr_db(resample_mac_ref(xn.double(), UP, DOWN, zero_phase=False), conv())
    if conv_snr < LINEAR_MIN_DB:
        raise SystemExit(f"phase 13 failed: the conv1d yardstick reads {conv_snr:.2f} dB "
                         f"against float64")
    lib_ms = time_ms(conv)
    lib_device_ms = queued_ms(conv, reps=10, cycles=10 ** 8)
    print(f"[13 times] resample_mac whole file {RES_HEADLINE[0]}x{RES_HEADLINE[1]} -> "
          f"{RES_OUT} f32 causal (res_two's first launch) on {smi}: kernel {mac_ms:.4f} ms "
          f"({samples / mac_ms * 1e3:.4e} out samples/s), plain {mac_plain_ms:.4f} ms; device "
          f"time of queued calls {mac_device_ms:.4f} ms; library (one strided conv1d of "
          f"{UP} phase channels, TF32 off, {conv_snr:.2f} dB against float64) {lib_ms:.4f} ms, "
          f"queued {lib_device_ms:.4f} ms")
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac_info

    block_info = resample_mac_info(channels=RES_HEADLINE[0], nout=RES_BLOCK * UP // DOWN,
                                   device=dev)
    print(f"[13 kernel] resample_mac {UP}/{DOWN} on {smi}, from the CUDA runtime (registers, "
          f"local bytes a thread, CTAs an SM by the occupancy API and by the geometry's model; "
          f"outputs and super-cycles a thread, threads, shared memory, grid): whole file {resample_mac_info(device=dev)}, "
          f"path D's block {block_info}; ptxas <q,p>: {chain_ptxas(log, 'resample_mac_kernel')}")
    record["resample_mac"].update(ms=mac_ms, plain_ms=mac_plain_ms, device_ms=mac_device_ms,
                                  library_ms=lib_ms, library_device_ms=lib_device_ms)

    def plain_c(env_h=None):
        return Chain([ResampleStage(UP, DOWN), FIRStage(h=h, nfft=NFFT, impl="torch"),
                      GateStage(impl="torch", **gate)]
                     + ([EnvelopeStage(env_h)] if env_h is not None else []))

    timed = [  # (name, kernel chain, plain chain)
        ("path C", res_chain(), plain_c()),
        ("path C+env", res_chain(h_env), plain_c(h_env)),
        ("path D", path_d(), plain_c()),
        ("resample_mac", Chain([ResampleStage(UP, DOWN, fused=True)]),
         Chain([ResampleStage(UP, DOWN)])),
    ]
    times = {}
    for name, kern, plain in timed:
        kern.build()
        plain.build()
        times[name] = (stream_ms(lambda: kern.stream(xn, RES_BLOCK, drain=True)),
                       stream_ms(lambda: plain.stream(xn, RES_BLOCK, drain=True)))
        print(f"[13 times] {name} stream of {RES_HEADLINE[0]}x{RES_HEADLINE[1]} f32, block "
              f"{RES_BLOCK}, {kern.drain_blocks(RES_HEADLINE[1], RES_BLOCK)} blocks, on {smi}: "
              f"kernels {times[name][0]:.4f} ms ({samples / times[name][0] * 1e3:.4e} out "
              f"samples/s), plain {times[name][1]:.4f} ms")
    path_c = res_chain()
    path_c.build()
    idle = device_idle_share(lambda: path_c.stream(xn, RES_BLOCK, drain=True))
    idle_plain = device_idle_share(lambda: plain_c().stream(xn, RES_BLOCK, drain=True))
    print(f"[13 idle] path C stream under torch.profiler on {smi}: device idle "
          f"{idle_text(idle)} of its span; plain version {idle_text(idle_plain)}")
    record["res_fir_gate_step_fused"].update(ms=times["path C"][0], plain_ms=times["path C"][1])
    record["resample_mac"].update(source="resample_kernel.cu", replaces="resample_kernel.py:78")
    record["resample_fir_gate_fused"].update(source="res_chain_kernel.cu",
                                             replaces="res_chain_kernel.py:149")
    record["res_fir_gate_step_fused"].update(source="res_fir_gate_step_kernel.cu",
                                             replaces="res_chain_kernel.py:476")


FFT_SIZES = (2, 4, 8, 256, 1024, 4096)
FFT_BATCHES = (1, 100, 4096)
FFT_TIMED = 4096  # rows of the timed FFTs (benchmarks/roofline.py's sizes)
# rfft_stockham and irfft_stockham on the register passes: with FFT_SIZES,
# every pass count, each shorter last pass, the leading pass of three (n =
# 512, 8192, 131072) and the scratch path (n = 32768, 131072)
REAL_SIZES = (16, 32, 64, 128, 512, 2048, 8192, 16384, 32768, 131072)
REAL_MIN_DB = 130.0  # the register kernels read >= 136 dB against float64
REAL_TIMED = (1024, 4096)  # rows of FFT_TIMED, timed round-robin against torch.fft


def fft_flops(n, transforms=1.0):
    """Nominal float32 operations of ``transforms`` complex n-point radix-2
    FFTs, ``ops.fft.fft_flops`` each (a real transform of n points counts
    half)."""
    from audiosignalprocess_tpu_torch.ops.fft import fft_flops as one

    return transforms * one(n)


def chip_peaks():
    """(bytes/s, float32 operations/s) of the card's published peaks, from
    ``utils.metrics`` (``detect_chip()``)."""
    from audiosignalprocess_tpu_torch.utils.metrics import detect_chip

    chip = detect_chip()
    return chip.hbm_gbps * 1e9, chip.f32_tflops * 1e12


def set_bound(rec, nbytes, flops):
    """bound_ms: the larger of the bytes over the memory rate and the
    operations over the float32 peak, and which of the two it is."""
    peak_bytes_s, peak_flop_s = chip_peaks()
    t_bytes, t_ops = nbytes / peak_bytes_s * 1e3, flops / peak_flop_s * 1e3
    rec.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")


def chain_flops(channels, samples, frames, nfft=NFFT, taps=TAPS):
    """Overlap-save FIR blocks and gate frames of ``channels`` x ``samples``
    samples: each block and each frame is a forward and an inverse real
    nfft-point transform (one complex transform's worth)."""
    blocks = -(-samples // (nfft - (taps - 1)))
    return channels * fft_flops(nfft, blocks + frames)


def resample_conv1d(x, up, down, h, zero_phase=True):
    """The yardstick library call for resample_mac (the port never calls
    it): () -> x (C, n) resampled by one strided conv1d with ``up`` output
    channels, phase s's reversed taps placed at its newest raw offset
    floor((s*down + delay)/up), stride down, then a reshape of (C, up,
    cycles) to (C, nout); TF32 off, restored afterwards."""
    from audiosignalprocess_tpu_torch.ops.resample import phase_bank, taps_per_phase

    c, n = x.shape
    nk = taps_per_phase(len(h), up)
    delay = (len(h) - 1) // 2 if zero_phase else 0
    nout = -(-n * up // down)
    cycles = -(-nout // up)
    off = (np.arange(up) * down + delay) // up
    w = np.zeros((up, 1, int(off.max()) + nk))
    bank = phase_bank(h, up)[:, ::-1]
    for s in range(up):
        w[s, 0, off[s]:off[s] + nk] = bank[(s * down + delay) % up]
    wt = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    right = max(0, (cycles - 1) * down + w.shape[-1] - (nk - 1) - n)
    xp = torch.nn.functional.pad(x.reshape(c, 1, n), (nk - 1, right))

    def call():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = torch.nn.functional.conv1d(xp, wt, stride=down)
        return y.transpose(1, 2).reshape(c, cycles * up)[:, :nout]

    return call


def conv_ms(x, taps):
    """The yardstick library call for a causal FIR: one conv1d over the
    whole input, TF32 off (the port never calls it)."""
    w = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype,
                        device=x.device).reshape(1, 1, -1)
    xp = torch.nn.functional.pad(x.reshape(x.shape[0], 1, -1), (len(taps) - 1, 0))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return time_ms(lambda: torch.nn.functional.conv1d(xp, w))


def poisoned_call(fn, numel, dev, copies=4):
    """fn() after ``copies`` blocks of ``numel`` floats were filled with NaN
    and freed: the caching allocator hands that memory back to the
    output's torch.empty, so a position the kernel leaves unwritten shows
    as NaN (where the previous call's result would otherwise stand in for
    it).  Returns (fn(), whether the output lies in the NaN-filled memory;
    the wrapper's own temporaries may have taken some of it first)."""
    blocks = [torch.full((numel,), float("nan"), device=dev) for _ in range(copies)]
    spans = sorted((b.data_ptr(), b.data_ptr() + 4 * numel) for b in blocks)
    del blocks
    y = fn()
    lo, hi = y.data_ptr(), y.data_ptr() + y.numel() * y.element_size()
    for a, b in spans:  # the poisoned blocks may lie end to end
        if a <= lo < b:
            lo = b
    return y, lo >= hi


def gate_fft_phases(dev, smi, rng, record, kernels, reset_counts, x_main, h, log=""):
    """Phases 14-16: the config-3 gate (noise_gate_fused) and the standalone
    FFT kernels (fft_stockham_lanes, rfft_stockham, irfft_stockham).  Adds
    the four kernels to ``record``; raises SystemExit on a failure."""
    from audiosignalprocess_tpu_torch import api
    from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
    from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import fir_noise_gate_fused
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
        noise_gate_fused, noise_gate_info, noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_fused
    from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
    from audiosignalprocess_tpu_torch.ops import fft
    from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
    from audiosignalprocess_tpu_torch.pipeline import Chain, GateStage
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    def check_runs(runs, n, b, bar, worst):
        """Launch each (kernel, launch, plain f64, torch.fft f64) once: its
        SNR against both at least ``bar``, its shape, finite values and one
        launch; the readings as text."""
        parts = []
        for kernel, launch, ref, lib_ref in runs:
            before = kernel.launches
            y = launch()
            torch.cuda.synchronize()
            snr, snr_lib = snr_db(ref, y), snr_db(lib_ref, y)
            err = float((y.double() - ref).abs().max())
            rec = record.setdefault(kernel.__name__, dict(max_abs_err=0.0, min_snr_db=np.inf))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["min_snr_db"] = min(rec["min_snr_db"], snr)
            worst[kernel.__name__] = min(worst.get(kernel.__name__, np.inf), snr, snr_lib)
            parts.append(f"{kernel.__name__} {snr:.2f}/{snr_lib:.2f}")
            if not (tuple(y.shape) == tuple(ref.shape) and bool(torch.isfinite(y).all())
                    and min(snr, snr_lib) >= bar and kernel.launches == before + 1):
                raise SystemExit(f"phase 14 failed: {kernel.__name__} n={n} b={b} "
                                 f"snr={snr:.2f} snr_vs_torch_fft={snr_lib:.2f} (bar {bar}) "
                                 f"launches={kernel.launches - before}")
        return ", ".join(parts)

    # ---- phase 14: the four kernels vs their float64 plain versions
    worst = {}
    for n in FFT_SIZES:
        for b in FFT_BATCHES:
            xr = torch.as_tensor(rng.standard_normal((b, n)), device=dev)
            xi = torch.as_tensor(rng.standard_normal((b, n)), device=dev)
            runs = []  # (kernel, launch, plain f64, torch.fft f64)
            for sign in (-1.0, 1.0):
                lib = torch.fft.fft if sign < 0 else (lambda z: torch.fft.ifft(z) * n)
                runs.append((fk.fft_stockham_lanes,
                             lambda s=sign: torch.cat(fk.fft_stockham_lanes(
                                 xr.float(), xi.float(), s)),
                             torch.cat(fk.fft_stockham_lanes_ref(xr, xi, sign)),
                             torch.view_as_real(lib(torch.complex(xr, xi))).permute(2, 0, 1)
                             .reshape(2 * b, n)))
            if n >= 4:
                spec = torch.fft.rfft(xr)
                sr, si = spec.real.contiguous(), spec.imag.contiguous()
                runs.append((fk.rfft_stockham, lambda: torch.cat(fk.rfft_stockham(xr.float())),
                             torch.cat(fk.rfft_stockham_ref(xr)), torch.cat([sr, si])))
                runs.append((fk.irfft_stockham,
                             lambda: fk.irfft_stockham(sr.float(), si.float(), n),
                             fk.irfft_stockham_ref(sr, si, n), xr))
            print(f"[14 kernel] FFT n={n} batch={b}: snr_vs_f64_plain/torch.fft_f64 dB: "
                  + check_runs(runs, n, b, LINEAR_MIN_DB, worst))
    print(f"[14 kernel] FFT worst reading over n in {FFT_SIZES}, batch in {FFT_BATCHES} "
          f"(against the float64 plain version and torch.fft float64): "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in worst.items()))

    # ---- phase 14b: the real kernels at every pass shape, batches 1 and a
    # CTA's rows + 1, the edge bins' imaginary parts set (both drop them)
    worst_real = {}
    for n in REAL_SIZES:
        for b in (1, fk.real_stockham_geometry(n)[0] + 1):
            x = torch.as_tensor(rng.standard_normal((b, n)), device=dev)
            spec = torch.fft.rfft(x)
            sr, si = spec.real.contiguous(), spec.imag.clone()
            si[:, 0], si[:, -1] = 1.0, -1.0
            runs = [(fk.rfft_stockham, lambda: torch.cat(fk.rfft_stockham(x.float())),
                     torch.cat(fk.rfft_stockham_ref(x)), torch.cat([spec.real, spec.imag])),
                    (fk.irfft_stockham, lambda: fk.irfft_stockham(sr.float(), si.float(), n),
                     fk.irfft_stockham_ref(sr, si, n), torch.fft.irfft(torch.complex(sr, si), n))]
            print(f"[14 real] n={n} batch={b}: snr_vs_f64_plain/torch.fft_f64 dB: "
                  + check_runs(runs, n, b, REAL_MIN_DB, worst_real))
    print(f"[14 real] worst reading over n in {REAL_SIZES}, batches 1 and a CTA's rows + 1 "
          f"(bar {REAL_MIN_DB:.0f} dB against the float64 plain version and torch.fft float64): "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in worst_real.items()))

    # the gate: each output's memory NaN-filled before the call (poisoned_call), so
    # a position the kernel never writes shows as not finite
    noise = np.random.default_rng(1).standard_normal(HEADLINE)
    for name, x64, kw in (
            ("tone burst 2x48128 release 0", tone_burst(rng, 2, 48128), {}),
            ("tone burst 2x48128 release 0.9", tone_burst(rng, 2, 48128), dict(release=0.9)),
            ("tone burst 2x48128 nfft 2048 hop 512", tone_burst(rng, 2, 48128),
             dict(nfft=2048, hop=512)),
            ("tone burst 2x48128 nfft 512 hop 128 release 0.5", tone_burst(rng, 2, 48128),
             dict(nfft=512, hop=128, release=0.5)),
            ("tone burst 2x48128 nfft 4096 hop 512", tone_burst(rng, 2, 48128),
             dict(nfft=4096, hop=512)),
            ("tone burst 3x40000+77 ragged", tone_burst(rng, 3, 40077), {}),
            (f"white noise {HEADLINE[0]}x{HEADLINE[1]}", noise, {})):
        x64 = torch.as_tensor(x64, device=dev)
        g = dict(nfft=kw.get("nfft", NFFT), hop=kw.get("hop", HOP))
        ref = noise_gate_ref(x64, **kw)
        x32 = x64.float()
        before = noise_gate_fused.launches
        y, nan_filled = poisoned_call(lambda: noise_gate_fused(x32, **kw), ref.numel(), dev)
        torch.cuda.synchronize()
        check_kernel(record, 14, f"noise_gate_fused {name}", y, ref, noise_gate_fused, before,
                     1, SNR_MIN_DB, flips_text(snr_db(ref, y), decision_flips(x64, **g))
                     + f" output_in_nan_filled_block={nan_filled}")
    print(f"[14 kernel] noise_gate_fused (and gate_shard_fused, the same parallel launch) on "
          f"{smi}, from the CUDA runtime (registers, local bytes a thread, CTAs an SM by the "
          f"occupancy API): parallel launch {noise_gate_info(NFFT, HOP, 0.0, dev)}, sequential "
          f"(release > 0) {noise_gate_info(NFFT, HOP, 0.6, dev)}; ptxas <R,RS,release>: "
          f"{chain_ptxas(log, 'noise_gate_kernel')}")

    # ---- phase 15: the paths through the entry points, each driven with
    # every count at 0 just before and read just after
    def counted(fn):
        reset_counts()
        y = fn()
        torch.cuda.synchronize()
        return y, {k.__name__: k.launches for k in kernels if k.launches}

    for c in (8, HEADLINE[0]):  # config 3: 8 ch x 10 s at 48 kHz; bench.py's 64
        x = x_main[:c]
        chain3 = Chain([GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=True)])
        chain3.build()
        y, counts = counted(lambda: chain3.full_flush(x))
        ref = Chain([GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES)]).full_flush(
            x.double())
        snr = snr_db(ref, y)
        line = (f"[15 config 3] Chain([GateStage(fused=True)]).full_flush {tuple(y.shape)} "
                f"launches={counts} snr_vs_f64_plain={snr:.2f} dB")
        print(line)
        if counts != {"noise_gate_fused": 1} or tuple(y.shape) != tuple(x.shape) \
                or not bool(torch.isfinite(y).all()) or snr < SNR_MIN_DB:
            raise SystemExit(f"phase 15 failed: {line}")
        record["noise_gate_fused"]["launches"] = counts["noise_gate_fused"]

    x8 = x_main[:8, :2 * FS]
    real_ffts = {"rfft_stockham": 1, "irfft_stockham": 1}
    for name, op, want, bar in (  # op on float32 (the kernels), then float64 (torch.fft)
            ("GateStage(fused=False).full",
             GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES).full, real_ffts,
             SNR_MIN_DB),
            ("ops.overlap_save", lambda v: overlap_save(v, h, NFFT), real_ffts, LINEAR_MIN_DB),
            ("ops.fft.fft complex64",
             lambda v: fft.fft(torch.complex(v, v.flip(-1))[:, :4096]),
             {"fft_stockham_lanes": 1}, LINEAR_MIN_DB),
            ("ops.fft.ifft complex64",
             lambda v: fft.ifft(torch.complex(v, v.flip(-1))[:, :4096]),
             {"fft_stockham_lanes": 1}, LINEAR_MIN_DB)):
        y, counts = counted(lambda: op(x8))
        ref = op(x8.double())
        if y.is_complex():
            y, ref = torch.view_as_real(y), torch.view_as_real(ref)
        snr = snr_db(ref, y)
        line = f"[15 path] {name} 8x{2 * FS} f32: launches={counts} snr_vs_f64={snr:.2f} dB"
        print(line)
        if counts != want or snr < bar:
            raise SystemExit(f"phase 15 failed: {line}")
        for k, v in counts.items():
            record[k]["launches"] = v

    wav_x = (0.5 * tone_burst(rng, 8, 2 * FS)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        p_in = str(Path(tmp) / "in.wav")
        write_wav(p_in, wav_x, FS, float_fmt=True)
        for fn, kw, want, bar in (
                (api.noise_gate_file, {}, {"noise_gate_fused": 1}, SNR_MIN_DB),
                (api.lowpass_file, dict(cutoff_hz=3000.0),
                 {"rfft_stockham": 1, "irfft_stockham": 1}, LINEAR_MIN_DB),
                (api.bandpass_file, dict(lo_hz=300.0, hi_hz=3000.0), {"fir_mac": 1},
                 LINEAR_MIN_DB),
                (api.envelope_file, {}, {"fir_mac": 1}, LINEAR_MIN_DB)):
            outs = {}
            for d in ("cuda", "cpu"):
                out = str(Path(tmp) / f"{d}.wav")
                y, counts = counted(lambda: fn(p_in, out, device=d, float_fmt=True, **kw))
                if d == "cuda":
                    launched = counts
                outs[d] = read_wav(out, dtype=np.float64)[0]
            snr = snr_db(outs["cpu"], outs["cuda"])
            line = (f"[15 api.{fn.__name__}] 8x{2 * FS} {kw}: launches={launched} "
                    f"shape={outs['cuda'].shape} snr_vs_cpu_plain={snr:.2f} dB")
            print(line)
            if launched != want or snr < bar or outs["cuda"].shape != outs["cpu"].shape:
                raise SystemExit(f"phase 15 failed: {line}")

    def bench_true(v):  # bench.py's True mode: two fused kernels
        return noise_gate_fused(overlap_save_fused(v, h, NFFT), NFFT, HOP,
                                noise_frames=NOISE_FRAMES)

    def bench_false(v):  # bench.py's False mode: the unfused ops (Stockham FFTs)
        return noise_gate(overlap_save(v, h, NFFT), NFFT, HOP, noise_frames=NOISE_FRAMES)

    y, counts = counted(lambda: bench_true(x_main))
    y_false, counts_false = counted(lambda: bench_false(x_main))
    ref = fir_noise_gate_fused(x_main, h)
    snr, snr_false = snr_db(ref, y), snr_db(ref, y_false)
    line = (f"[15 bench modes] {HEADLINE[0]}x{HEADLINE[1]} tone bursts: True launches={counts} "
            f"snr_vs_fir_noise_gate_fused={snr:.2f} dB; False launches={counts_false} "
            f"snr_vs_fir_noise_gate_fused={snr_false:.2f} dB")
    print(line)
    if (counts != {"overlap_save_fused": 1, "noise_gate_fused": 1}
            or counts_false != {"rfft_stockham": 2, "irfft_stockham": 2}
            or min(snr, snr_false) < SNR_MIN_DB):
        raise SystemExit(f"phase 15 failed: {line}")

    # ---- phase 16: times
    src = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    copy_bw = 2 * src.numel() * 4 / copy_ms * 1e3
    peak_bytes_s = chip_peaks()[0]
    print(f"[16 times] copy probe (read + write 256 MB) on {smi}: {copy_ms:.4f} ms, "
          f"{copy_bw / 1e12:.4f} TB/s = {copy_bw / peak_bytes_s * 100:.1f} % of "
          f"{peak_bytes_s / 1e12:.2f} TB/s")
    del src, dst
    for n in (1024, 4096):
        xr = torch.randn(FFT_TIMED, n, device=dev)
        xi = torch.randn(FFT_TIMED, n, device=dev)
        z = torch.complex(xr, xi)
        sr, si = fk.rfft_stockham(xr)
        spec = torch.complex(sr, si)
        b = FFT_TIMED
        for kernel, call, plain, lib, nbytes, flops in (
                (fk.fft_stockham_lanes, lambda: fk.fft_stockham_lanes(xr, xi, -1.0),
                 lambda: fk.fft_stockham_lanes_ref(xr, xi, -1.0), lambda: torch.fft.fft(z),
                 16 * b * n, b * fft_flops(n)),
                (fk.rfft_stockham, lambda: fk.rfft_stockham(xr), lambda: fk.rfft_stockham_ref(xr),
                 lambda: torch.fft.rfft(xr), 4 * b * (n + 2 * (n // 2 + 1)),
                 b * fft_flops(n, 0.5)),
                (fk.irfft_stockham, lambda: fk.irfft_stockham(sr, si, n),
                 lambda: fk.irfft_stockham_ref(sr, si, n), lambda: torch.fft.irfft(spec, n),
                 4 * b * (n + 2 * (n // 2 + 1)), b * fft_flops(n, 0.5))):
            ms, plain_ms, lib_ms = time_ms(call), time_ms(plain), time_ms(lib)
            rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
            set_bound(rec, nbytes, flops)
            bw = nbytes / ms * 1e3
            print(f"[16 times] {kernel.__name__} {b}x{n} f32 on {smi}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, torch.fft (library) {lib_ms:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); {bw / 1e9:.1f} GB/s = "
                  f"{bw / copy_bw * 100:.1f} % of the copy probe, "
                  f"{bw / peak_bytes_s * 100:.1f} % of {peak_bytes_s / 1e12:.2f} TB/s")
            if n == 1024:
                record[kernel.__name__].update(rec)
    for c in (8, HEADLINE[0]):
        xn = torch.as_tensor(np.random.default_rng(0).standard_normal((c, HEADLINE[1])),
                             dtype=torch.float32, device=dev)
        ms = time_ms(lambda: noise_gate_fused(xn))
        plain_ms = time_ms(lambda: noise_gate_ref(xn))
        # 10 calls queued behind a 10^8-cycle sleep: the wrapper's floor
        # prologue would pace back-to-back calls
        device_ms = queued_ms(lambda: noise_gate_fused(xn), reps=10, cycles=10 ** 8)
        frames = 1 + (HEADLINE[1] - NFFT) // HOP
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=None, device_ms=device_ms)
        set_bound(rec, 4 * c * (HEADLINE[1] + NFFT + (frames - 1) * HOP),
                  c * fft_flops(NFFT, frames))
        print(f"[16 times] noise_gate_fused {c}x{HEADLINE[1]} f32 white noise on {smi}: "
              f"kernel {ms:.4f} ms ({c * HEADLINE[1] / ms * 1e3:.4e} samples/s; device time "
              f"of queued calls {device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        if c == HEADLINE[0]:
            record["noise_gate_fused"].update(rec)
            true_ms, false_ms = time_ms(lambda: bench_true(xn)), time_ms(lambda: bench_false(xn))
            true_dev = queued_ms(lambda: bench_true(xn), reps=10, cycles=10 ** 8)
            print(f"[16 times] bench.py modes through the port, {c}x{HEADLINE[1]} f32 white "
                  f"noise on {smi}: True (overlap_save_fused + noise_gate_fused) "
                  f"{true_ms:.4f} ms (device time of queued calls {true_dev:.4f} ms), False "
                  f"(ops with Stockham FFTs) {false_ms:.4f} ms")
    # ---- phase 16b: the real kernels against torch.fft round-robin, each
    # timing bracketed by its own copy probe (phase 25c's protocol) and
    # taken on launches queued behind a sleep of the card (queued_ms): at
    # 4096 x 1024 a launch's host cost exceeds the kernel's time.  Their
    # medians at n = 1024 go to the JSON line as device_ms and
    # library_device_ms, beside phase 16's ms and library_ms
    probe = copy_probe(dev)
    b = FFT_TIMED
    for n in REAL_TIMED:
        x = torch.randn(b, n, device=dev)
        sr, si = fk.rfft_stockham(x)
        spec = torch.complex(sr, si)
        arms = {"rfft_stockham": lambda: fk.rfft_stockham(x),
                "torch.fft.rfft (library)": lambda: torch.fft.rfft(x),
                "irfft_stockham": lambda: fk.irfft_stockham(sr, si, n),
                "torch.fft.irfft (library)": lambda: torch.fft.irfft(spec, n)}
        med, probes = round_robin(arms, 4 * b * (n + 2 * (n // 2 + 1)), probe, MANUAL_REPS,
                                  queued_ms)
        print(f"[16 real] {b}x{n} f32 on {smi}, {MANUAL_REPS} reps round-robin, device time "
              f"of queued launches, medians: "
              f"{round_robin_text(med, probes)}")
        if n == 1024:
            for k, lib in (("rfft_stockham", "torch.fft.rfft (library)"),
                           ("irfft_stockham", "torch.fft.irfft (library)")):
                record[k].update(device_ms=med[k][0], library_device_ms=med[lib][0])
        del x, sr, si, spec
    del probe
    for k, src_, rep in (("noise_gate_fused", "gate_kernel.cu", "gate_kernel.py:188"),
                         ("fft_stockham_lanes", "fft_kernel.cu", "fft_kernel.py:1147"),
                         ("rfft_stockham", "fft_kernel.cu", "fft_kernel.py:1486"),
                         ("irfft_stockham", "fft_kernel.cu", "fft_kernel.py:1568")):
        record[k].update(source=src_, replaces=rep)


STRETCH_M = {(4, 3): 16, (3, 4): 18, (1, 2): 16, (147, 160): 147}  # frames per block
STRETCH_PATHS = {"S1": ((4, 3), 4096), "S2": ((3, 4), 4608), "S3": ((1, 2), 4096)}


def stretch_work(c, n, p, q, block, nfft=NFFT, hop=HOP):
    """(bytes, operations) of a drained stretch stream of c channels x n
    samples in blocks of ``block``: per block and channel the input and
    output read or written once, the tails, z0 and acc read and written
    once, the old FIFO rows that survive the block (depth - m) read and the
    whole new FIFO written; m forward and mo inverse real transforms."""
    from audiosignalprocess_tpu_torch.kernels.stretch_kernel import stretch_slots
    from audiosignalprocess_tpu_torch.pipeline import Chain, StretchStage

    chain = Chain([StretchStage(p, q, nfft=nfft, hop=hop)])
    chain.build()
    st = chain.stages[0]
    m = block // hop
    mo, d, nb = m * q // p, nfft - hop, nfft // 2 + 1
    depth = stretch_slots(m, p, q, st.n_skip, st.off)[0]
    fifo = 2 * (max(depth - m, 0) + depth) * nb  # re and im
    per = 4 * (block + mo * hop + 2 * (2 * d + 4 * nb) + fifo)
    blocks = c * chain.drain_blocks(n, block)
    return blocks * per, blocks * fft_flops(nfft, 0.5 * (m + mo))


def vocoder_phases(dev, smi, record, kernels, reset_counts):
    """Phases 17-19: the phase vocoder (stretch_step_fused; the whole-file
    stretch and pitch shift on rfft_stockham, irfft_stockham and
    resample_mac).  Adds stretch_step_fused to ``record``; raises
    SystemExit on a failure."""
    from audiosignalprocess_tpu_torch import api
    from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
    from audiosignalprocess_tpu_torch.kernels.stretch_kernel import stretch_step_fused
    from audiosignalprocess_tpu_torch.pipeline import Chain, ResampleStage, StretchStage
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    def counted(fn):
        reset_counts()
        y = fn()
        torch.cuda.synchronize()
        return y, {k.__name__: k.launches for k in kernels if k.launches}

    # ---- phase 17: the kernel vs its float64 and float32 plain versions
    # on the card, over the rates and frame sizes of the tests
    rng = np.random.default_rng(17)
    geos = [(pq, nh) for pq in STRETCH_M for nh in ((256, 64), (NFFT, HOP), (2048, 512))]
    rate = StretchStage.from_rate(2.0 ** (1.0 / 3.0), 64)
    geos.append(((rate.p, rate.q), (256, 64)))
    worst32 = np.inf
    for (p, q), (nfft, hop) in geos:
        block = STRETCH_M.get((p, q), p) * hop
        for drain in (False, True):
            n = 5 * block + (321 if drain else 0)
            x64 = torch.as_tensor(rng.standard_normal((8, n)), device=dev)
            kern = Chain([StretchStage(p, q, nfft=nfft, hop=hop, fused=True)])
            plain = Chain([StretchStage(p, q, nfft=nfft, hop=hop, impl="torch")])
            kern.build()
            calls = kern.drain_blocks(n, block) if drain else n // block
            before = stretch_step_fused.launches
            y = kern.stream(x64.float(), block, drain=drain)
            torch.cuda.synchronize()
            s32 = snr_db(plain.stream(x64.float(), block, drain=drain), y)
            worst32 = min(worst32, s32)
            check_kernel(record, 17, f"stretch_step_fused {p}/{q} nfft {nfft} hop {hop} "
                         f"block {block} 8x{n} drain={drain}", y,
                         plain.stream(x64, block, drain=drain), stretch_step_fused, before,
                         calls, SNR_MIN_DB, f" snr_vs_f32_plain={s32:.2f} dB")
            if s32 < 65.0:
                raise SystemExit(f"phase 17 failed: {s32:.2f} dB against the float32 plain step")
    print(f"[17 kernel] stretch_step_fused worst reading against the float32 plain step: "
          f"{worst32:.2f} dB (bar 65 dB)")

    # ---- phase 18: S1-S3, W1 and W2 at the full width (bench.py's white
    # noise), each driven with every count at 0 just before and read just
    # after
    c, n = HEADLINE
    xn = torch.as_tensor(np.random.default_rng(0).standard_normal(HEADLINE),
                         dtype=torch.float32, device=dev)

    def path(name):
        (p, q), _ = STRETCH_PATHS[name]
        stages = [StretchStage(p, q, nfft=NFFT, hop=HOP, fused=True)]
        if name == "S3":
            stages.append(ResampleStage(1, 2, fused=True))
        return Chain(stages)

    runs = {}
    for name, (_, block) in STRETCH_PATHS.items():
        chain = path(name)
        chain.build()
        blocks = chain.drain_blocks(n, block)
        y, counts = counted(lambda: chain.stream(xn, block, drain=True))
        want = {"stretch_step_fused": blocks}
        if name == "S3":
            want["resample_mac"] = blocks
        snr = snr_db(chain.full_flush(xn.double()), y)
        line = (f"[18 path {name}] {chain.stages[0].p}/{chain.stages[0].q} "
                f"Chain.stream(drain=True) block {block} blocks={blocks} {tuple(y.shape)} "
                f"launches={counts} snr_vs_f64_full_flush={snr:.2f} dB")
        print(line)
        if counts != want or tuple(y.shape) != (c, chain.out_len(n)) \
                or not bool(torch.isfinite(y).all()) or snr < SNR_MIN_DB:
            raise SystemExit(f"phase 18 failed: {line} (want {want})")
        runs[name] = counts
    real = {"rfft_stockham": 1, "irfft_stockham": 1}
    whole = Chain([StretchStage(4, 3)])
    whole.build()
    y, counts = counted(lambda: whole.full_flush(xn))
    snr = snr_db(whole.full_flush(xn.double()), y)
    line = (f"[18 path W1] Chain([StretchStage(4, 3)]).full_flush {tuple(y.shape)} "
            f"launches={counts} snr_vs_f64={snr:.2f} dB")
    print(line)
    if counts != real or snr < SNR_MIN_DB or tuple(y.shape) != (c, n * 3 // 4):
        raise SystemExit(f"phase 18 failed: {line}")
    wav_x = (0.25 * xn.cpu().numpy()).clip(-1.0, 1.0)
    with tempfile.TemporaryDirectory() as tmp:
        p_in = str(Path(tmp) / "in.wav")
        write_wav(p_in, wav_x, FS, float_fmt=True)
        for fn, kw, want in ((api.time_stretch_file, dict(rate_factor=1.25), real),
                             (api.pitch_shift_file, dict(semitones=3.0),
                              dict(real, resample_mac=1))):
            outs = {}
            for d in ("cuda", "cpu"):
                out = str(Path(tmp) / f"{d}.wav")
                t0 = time.perf_counter()
                _, launched = counted(lambda: fn(p_in, out, device=d, float_fmt=True, **kw))
                secs = time.perf_counter() - t0
                if d == "cuda":
                    counts, cuda_s = launched, secs
                outs[d] = read_wav(out, dtype=np.float64)[0]
            snr = snr_db(outs["cpu"], outs["cuda"])
            line = (f"[18 api.{fn.__name__}] {c}x{n} {kw}: launches={counts} "
                    f"shape={outs['cuda'].shape} snr_vs_cpu={snr:.2f} dB (cuda call "
                    f"{cuda_s:.2f} s, cpu call {secs:.2f} s, host clock)")
            print(line)
            if counts != want or snr < SNR_MIN_DB or outs["cuda"].shape != outs["cpu"].shape:
                raise SystemExit(f"phase 18 failed: {line}")
    record["stretch_step_fused"]["launches"] = runs["S1"]["stretch_step_fused"]

    # ---- phase 19: times per drained stream (kernel, then the same stream
    # through the float32 plain step), the device idle share of S1, bound
    times = {}
    for name, ((p, q), block) in STRETCH_PATHS.items():
        kern = path(name)
        plain = Chain([StretchStage(p, q, nfft=NFFT, hop=HOP, impl="torch")]
                      + ([ResampleStage(1, 2)] if name == "S3" else []))
        kern.build()
        plain.build()
        times[name] = (stream_ms(lambda: kern.stream(xn, block, drain=True)),
                       stream_ms(lambda: plain.stream(xn, block, drain=True)))
        nbytes, flops = stretch_work(c, n, p, q, block)
        rec = {}
        set_bound(rec, nbytes, flops)
        print(f"[19 times] {name} {p}/{q} stream of {c}x{n} f32 white noise, block {block}, "
              f"{kern.drain_blocks(n, block)} blocks, on {smi}: kernels {times[name][0]:.4f} ms "
              f"({c * n / times[name][0] * 1e3:.4e} in samples/s), plain f32 "
              f"{times[name][1]:.4f} ms; stretch bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.4f} GFLOP)")
        if name == "S1":
            record["stretch_step_fused"].update(rec, ms=times[name][0], plain_ms=times[name][1])
    s1 = path("S1")
    s1.build()
    idle = device_idle_share(lambda: s1.stream(xn, 4096, drain=True))
    plain1 = Chain([StretchStage(4, 3, nfft=NFFT, hop=HOP, impl="torch")])
    plain1.build()
    idle_plain = device_idle_share(lambda: plain1.stream(xn, 4096, drain=True))
    print(f"[19 idle] S1 stream under torch.profiler on {smi}: device idle {idle_text(idle)} "
          f"of its span; plain version {idle_text(idle_plain)}")
    record["stretch_step_fused"].update(source="stretch_step_kernel.cu",
                                        replaces="stretch_kernel.py:125", library_ms=None)


def earlier_bounds(record, h, h_env, xn, blocks, res_blocks):
    """bound_ms and library_ms of the eight kernels of the earlier phases, for
    the work each timed run did: whole files of HEADLINE (48 kHz; fir_mac
    and overlap_save_fused too, on the input their conv1d takes) or
    RES_HEADLINE -> RES_OUT (config 5), and drained streams of ``blocks``
    blocks of BLOCK (48 kHz) or ``res_blocks`` of RES_BLOCK (config 5)."""
    from audiosignalprocess_tpu_torch.ops.resample import resample_filter

    c, n = HEADLINE
    nk = -(-len(resample_filter(UP, DOWN)) // UP)
    frames = 1 + (n - NFFT) // HOP
    sn = blocks * BLOCK  # a stream's samples per channel (in and out)
    s_frames = sn // HOP
    res_in, res_out = res_blocks * RES_BLOCK, res_blocks * (RES_BLOCK * UP // DOWN)
    res_frames = 1 + (RES_OUT - NFFT) // HOP
    work = {  # kernel: (bytes, operations)
        "fir_noise_gate_fused": (8 * c * n, chain_flops(c, n, frames)),
        "fir_gate_step_fused": (8 * c * sn, chain_flops(c, sn, s_frames)),
        "gate_step_fused": (8 * c * sn, c * fft_flops(NFFT, s_frames)),
        "overlap_save_fused": (8 * c * n, chain_flops(c, n, 0)),  # one whole-file launch
        "fir_mac": (8 * c * n, 2.0 * len(h_env) * c * n),
        "resample_mac": (4 * c * (RES_HEADLINE[1] + RES_OUT), 2.0 * nk * c * RES_OUT),
        "resample_fir_gate_fused": (4 * c * (RES_HEADLINE[1] + RES_OUT),
                                    2.0 * nk * c * RES_OUT + chain_flops(c, RES_OUT, res_frames)),
        "res_fir_gate_step_fused": (4 * c * (res_in + res_out),
                                    2.0 * nk * c * res_out
                                    + chain_flops(c, res_out, res_out // HOP)),
    }
    for k, (nbytes, flops) in work.items():
        set_bound(record[k], nbytes, flops)
        record[k].setdefault("library_ms", None)
    record["fir_mac"]["library_ms"] = conv_ms(xn, h_env)
    record["overlap_save_fused"]["library_ms"] = conv_ms(xn, h)


def step_device_phase(dev, smi, record, kernels, h, h_env, log=""):
    """Phase 9b: the device time of one launch of each stream kernel at its
    stream's block shape (64 channels; BLOCK, or RES_BLOCK for the
    resampler), the carry in place: a one-stage chain stepped through
    STEP_WARM blocks of white noise, then its next step queued 20 times
    behind a 10^8-cycle sleep (queued_ms), each launching the kernel once.
    Writes ``device_ms`` (a launch) to ``record`` and ranks the kernels by
    launches x (device time - bound) a launch, the bound a launch being the
    stream's over its launches (a whole-file launch's scaled to a block for
    overlap_save_fused and fir_mac).  resample_mac runs at path D's block
    (``ResampleStage(fused=True)``, its history carried): its launch goes to
    ``block_device_ms`` (``device_ms`` stays phase 13's whole file), ranked
    by path D's launches a stream, the bound a launch the block's bytes
    (input, history, output) over the memory rate.  Run after
    earlier_bounds."""
    from audiosignalprocess_tpu_torch.pipeline import (
        Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage, ResampleStage, ResFIRGateStage,
        StretchStage,
    )

    gate = dict(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES)
    c = HEADLINE[0]
    steps = {  # kernel: (stage, block)
        "fir_gate_step_fused": (FIRGateStage(h=h, **gate), BLOCK),
        "gate_step_fused": (GateStage(fused=True, **gate), BLOCK),
        "overlap_save_fused": (FIRStage(h=h, nfft=NFFT, fused=True), BLOCK),
        "fir_mac": (EnvelopeStage(h_env, fused=True), BLOCK),
        "res_fir_gate_step_fused": (ResFIRGateStage(UP, DOWN, h=h, **gate), RES_BLOCK),
        "stretch_step_fused": (StretchStage(4, 3, nfft=NFFT, hop=HOP, fused=True), BLOCK),
        "resample_mac": (ResampleStage(UP, DOWN, fused=True), RES_BLOCK),  # path D's block
    }
    path_d = Chain([ResampleStage(UP, DOWN, fused=True), FIRGateStage(h=h, **gate)])
    path_d.build()
    path_d_blocks = path_d.drain_blocks(RES_HEADLINE[1], RES_BLOCK)
    by_name = {k.__name__: k for k in kernels}
    rng = np.random.default_rng(9)
    rank = []
    for name, (stage, block) in steps.items():
        chain = Chain([stage])
        x = torch.as_tensor(rng.standard_normal((c, (STEP_WARM + 1) * block)),
                            dtype=torch.float32, device=dev)
        states = chain.init_state((c,), block, torch.float32, dev)
        for k in range(STEP_WARM):
            states, _ = chain.step(states, x[:, k * block:(k + 1) * block])
        xb = x[:, STEP_WARM * block:]
        kernel = by_name[name]
        before = kernel.launches
        chain.step(states, xb)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise SystemExit(f"phase 9b failed: a {name} step launched it "
                             f"{kernel.launches - before} times")
        device_ms = queued_ms(lambda: chain.step(states, xb), cycles=10 ** 8)
        rec = record[name]
        launches = rec["launches"]
        if name == "resample_mac":  # a launch a block of path D; device_ms stays the file's
            launches = path_d_blocks
            bound = 4 * c * (block + states[0].shape[-1] + block * UP // DOWN) / (
                chip_peaks()[0]) * 1e3
            rec["block_device_ms"] = device_ms
        else:
            whole = name in ("overlap_save_fused", "fir_mac")
            bound = rec["bound_ms"] * (block / HEADLINE[1] if whole else 1.0 / launches)
            rec["device_ms"] = device_ms
        rank.append((launches * (device_ms - bound), name, device_ms, bound, launches))
        print(f"[9b times] {name} one launch at {c}x{block} f32, the carry after "
              f"{STEP_WARM} blocks, on {smi}: device time of queued launches {device_ms:.4f} ms, "
              f"bound a launch {bound:.4f} ms ({rec['bound_by']})")
    print(f"[9b rank] launches x (device time - bound) a launch, on {smi}: " + "; ".join(
        f"{name} {n_l} x ({ms:.4f} - {b:.4f}) = {cost:.4f} ms"
        for cost, name, ms, b, n_l in sorted(rank, reverse=True)))
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import fir_gate_step_info
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import gate_step_info
    from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import res_fir_gate_step_info
    from audiosignalprocess_tpu_torch.kernels.stretch_kernel import stretch_step_info

    def big_step_info(info, block, **kw):  # at nfft 8192
        return info(nfft=BIG_NFFT, hop=BIG_HOP, block=block, device=dev, **kw)

    big_res = 5 * BIG_HOP * DOWN // UP  # raw samples: 5 resampled hops

    print(f"[9b kernel] the step kernels on the batched register body on {smi}, from the CUDA "
          f"runtime (registers, local bytes a thread, CTAs an SM by the occupancy API; fs: new "
          f"frames a segment): fir_gate_step_fused {c}x{BLOCK} "
          f"{fir_gate_step_info(block=BLOCK, device=dev)}, with the envelope "
          f"{fir_gate_step_info(env_taps=len(h_env), block=BLOCK, device=dev)}, release 0.6 "
          f"{fir_gate_step_info(block=BLOCK, release=0.6, device=dev)}; "
          f"res_fir_gate_step_fused {c}x{RES_BLOCK} "
          f"{res_fir_gate_step_info(block=RES_BLOCK, device=dev)}, with the envelope "
          f"{res_fir_gate_step_info(env_taps=len(h_env), block=RES_BLOCK, device=dev)}; at "
          f"nfft {BIG_NFFT} (512 threads, one CTA a channel): fir_gate_step_fused "
          f"{c}x{4 * BIG_HOP} {big_step_info(fir_gate_step_info, 4 * BIG_HOP)}, with the "
          f"envelope {big_step_info(fir_gate_step_info, 4 * BIG_HOP, env_taps=len(h_env))}, "
          f"release 0.6 {big_step_info(fir_gate_step_info, 4 * BIG_HOP, release=0.6)}; "
          f"res_fir_gate_step_fused {c}x{big_res} "
          f"{big_step_info(res_fir_gate_step_info, big_res)}, with the envelope "
          f"{big_step_info(res_fir_gate_step_info, big_res, env_taps=len(h_env))}; "
          f"gate_step_fused {c}x{BLOCK} {gate_step_info(block=BLOCK, device=dev)}, release 0.6 "
          f"{gate_step_info(block=BLOCK, release=0.6, device=dev)}, at nfft {BIG_NFFT} "
          f"{c}x{4 * BIG_HOP} {big_step_info(gate_step_info, 4 * BIG_HOP)}; "
          f"stretch_step_fused {stretch_step_info(device=dev)}, at nfft {BIG_NFFT} "
          f"{stretch_step_info(BIG_NFFT, BIG_HOP, device=dev)}; "
          f"ptxas <R,RS,threads>: fir_gate_step_kernel "
          f"{chain_ptxas(log, 'fir_gate_step_kernel')}"
          f"; res_fir_gate_step_kernel {chain_ptxas(log, 'res_fir_gate_step_kernel')}"
          f"; gate_step_kernel {chain_ptxas(log, 'gate_step_kernel')}"
          f"; stretch_step_kernel {chain_ptxas(log, 'stretch_step_kernel')}")
    from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac_info
    from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_info

    print(f"[9b kernel] overlap_save_fused (batched register passes) and fir_mac (register "
          f"tiles) on {smi}, from the CUDA runtime (registers, local bytes a thread, CTAs an SM "
          f"by the occupancy API, threads, shared memory): overlap_save_fused nfft {NFFT} "
          f"{overlap_save_info(NFFT, dev)}, at config 4's nfft {C4_NFFT} "
          f"{overlap_save_info(C4_NFFT, dev)}; fir_mac {len(h_env)} taps "
          f"{fir_mac_info(len(h_env), dev)}, config 2's 256 taps {fir_mac_info(256, dev)}; "
          f"ptxas <R,RS,threads>: overlap_save_kernel {chain_ptxas(log, 'overlap_save_kernel')}")


STEP_WARM = 12  # blocks stepped before a step kernel's timed launch

BIG_NFFT, BIG_HOP = 8192, 2048  # the whole-file kernels' largest transform: 512 threads, one buffer
BIG_N = 69632  # the input of the nfft 8192 fault (ROADMAP Queue 3)


def big_nfft_input(dev, n=BIG_N):
    """(1, n) float64: 0.01 x default_rng(0) noise plus a unit 440 Hz sine
    over the middle third."""
    x = 0.01 * np.random.default_rng(0).standard_normal((1, n))
    t = np.arange(n) / FS
    x[0, n // 3: 2 * n // 3] += np.sin(2 * np.pi * 440.0 * t[n // 3: 2 * n // 3])
    return torch.as_tensor(x, device=dev)


def big_nfft_phase(dev, smi, kernels, log=""):
    """Phase 26: the four whole-file kernels at nfft 8192, hop 2048 (one
    transform of 512 threads a batch, one exchange buffer): each against
    its float64 plain version (>= 60 dB, flips counted, one launch, no
    other kernel) at release 0 and 0.6 on the fault's input, each raising
    a ValueError naming SMEM_LIMIT at nfft 16384 with no launch, and their
    device time at 64 x 480000 (the shard's on 59 hops and its spill; 10
    calls queued behind a sleep) beside the bound, with registers, local
    bytes and CTAs an SM."""
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
        fir_noise_gate_fused, fir_noise_gate_info, fir_noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
        gate_shard_fused, gate_shard_ref, noise_floor, noise_gate_fused, noise_gate_info,
        noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
        resample_fir_gate_fused, resample_fir_gate_info, resample_fir_gate_ref,
    )
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
    from audiosignalprocess_tpu_torch.ops.resample import resample_filter, resample_poly
    from audiosignalprocess_tpu_torch.ops.stft import frame
    from audiosignalprocess_tpu_torch.ops.windows import window
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    nfft, hop, d = BIG_NFFT, BIG_HOP, BIG_NFFT - BIG_HOP
    h = design_fir(TAPS, 0.3)
    x = big_nfft_input(dev)
    xr = x[:, : BIG_N * DOWN // UP]
    ext = x[:, : 30 * hop + d]
    w = window("hann", nfft, periodic=True, dtype=torch.float64, device=dev)
    floor = noise_floor(frame(ext[:, : d + NOISE_FRAMES * hop], nfft, hop) * w)
    u = resample_poly(xr, UP, DOWN, zero_phase=False)
    flips = {"noise_gate_fused": decision_flips(x, nfft, hop),
             "fir_noise_gate_fused": decision_flips(overlap_save(x, h, nfft, impl="torch"),
                                                    nfft, hop),
             "resample_fir_gate_fused": decision_flips(overlap_save(u, h, nfft, impl="torch"),
                                                       nfft, hop),
             "gate_shard_fused": decision_flips(ext, nfft, hop)}
    for release in (0.0, 0.6):
        kw = dict(nfft=nfft, hop=hop, release=release)
        n_valid = 27 if release else 30  # the shard has no release: fewer valid frames
        runs = {"noise_gate_fused": (lambda: noise_gate_fused(x.float(), **kw),
                                     lambda: noise_gate_ref(x, **kw)),
                "fir_noise_gate_fused": (lambda: fir_noise_gate_fused(x.float(), h, **kw),
                                         lambda: fir_noise_gate_ref(x, h, **kw)),
                "resample_fir_gate_fused": (
                    lambda: resample_fir_gate_fused(xr.float(), UP, DOWN, h, **kw),
                    lambda: resample_fir_gate_ref(xr, UP, DOWN, h, **kw)),
                "gate_shard_fused": (
                    lambda: gate_shard_fused(ext.float(), floor.float(), n_valid, nfft, hop),
                    lambda: gate_shard_ref(ext, floor, n_valid, nfft, hop))}
        for name, (fn, plain) in runs.items():
            before = {k.__name__: k.launches for k in kernels}
            y = fn()
            torch.cuda.synchronize()
            launched = {k.__name__: k.launches - before[k.__name__] for k in kernels
                        if k.launches != before[k.__name__]}
            ref = plain()
            snr = snr_db(ref, y)
            line = (f"[26 kernel] {name} nfft={nfft} hop={hop} "
                    + (f"n_valid={n_valid}" if name == "gate_shard_fused" else
                       f"release={release}")
                    + f" on {tuple(x.shape)}: shape {tuple(y.shape)} launches={launched} "
                    f"snr_vs_f64_plain={snr:.2f} dB" + flips_text(snr, flips[name]))
            print(line)
            if not (tuple(y.shape) == tuple(ref.shape) and bool(torch.isfinite(y).all())
                    and snr >= SNR_MIN_DB and launched == {name: 1}):
                raise SystemExit(f"phase 26 failed: {line}")
    # nfft 16384: one transform needs more shared memory than a block has
    x16 = big_nfft_input(dev, 4 * 16384).float()
    kw16 = dict(nfft=16384, hop=4096)
    for name, fn in (("noise_gate_fused", lambda: noise_gate_fused(x16, **kw16)),
                     ("fir_noise_gate_fused", lambda: fir_noise_gate_fused(x16, h, **kw16)),
                     ("resample_fir_gate_fused",
                      lambda: resample_fir_gate_fused(x16, UP, DOWN, h, **kw16)),
                     ("gate_shard_fused", lambda: gate_shard_fused(
                         x16[:, : 8 * 4096 + 12288], torch.ones(1, 8193, device=dev), 5,
                         **kw16))):
        before = sum(k.launches for k in kernels)
        try:
            fn()
        except ValueError as err:
            ok = "SMEM_LIMIT" in str(err) and sum(k.launches for k in kernels) == before
            print(f"[26 kernel] {name} nfft=16384 hop=4096 raises: {str(err)[:150]}")
            if not ok:
                raise SystemExit(f"phase 26 failed: {name} at nfft 16384: {err}")
        else:
            raise SystemExit(f"phase 26 failed: {name} ran at nfft 16384")
    # times at the headline width
    xn = torch.as_tensor(np.random.default_rng(0).standard_normal(HEADLINE).astype(np.float32),
                         device=dev)
    xrn = torch.as_tensor(np.random.default_rng(0).standard_normal(RES_HEADLINE)
                          .astype(np.float32), device=dev)
    c, n = HEADLINE
    frames = 1 + (n - nfft) // hop
    res_frames = 1 + (RES_OUT - nfft) // hop
    nk = -(-len(resample_filter(UP, DOWN)) // UP)
    l_big = 59 * hop  # one shard of the sharded gate's width at this hop
    ext_n = xn[:, : l_big + d]
    floor_n = noise_floor(frame(ext_n[:, : d + NOISE_FRAMES * hop], nfft, hop)
                          * w.float()).contiguous()
    timed = {  # name: (call, bytes, operations)
        "noise_gate_fused": (lambda: noise_gate_fused(xn, nfft, hop), 8 * c * n,
                             c * fft_flops(nfft, frames)),
        "gate_shard_fused": (lambda: gate_shard_fused(ext_n, floor_n, l_big // hop, nfft, hop),
                             8 * c * (l_big + d), c * fft_flops(nfft, l_big // hop)),
        "fir_noise_gate_fused": (lambda: fir_noise_gate_fused(xn, h, nfft, hop), 8 * c * n,
                                 chain_flops(c, n, frames, nfft)),
        "resample_fir_gate_fused": (
            lambda: resample_fir_gate_fused(xrn, UP, DOWN, h, nfft=nfft, hop=hop),
            4 * c * (RES_HEADLINE[1] + RES_OUT),
            2.0 * nk * c * RES_OUT + chain_flops(c, RES_OUT, res_frames, nfft))}
    peak_bytes_s, peak_flop_s = chip_peaks()
    for name, (fn, nbytes, flops) in timed.items():
        dev_ms = queued_ms(fn, reps=10, cycles=10 ** 8)
        t_b, t_o = nbytes / peak_bytes_s * 1e3, flops / peak_flop_s * 1e3
        shape = f"{c}x{l_big + d} (one shard)" if name == "gate_shard_fused" else f"{c}x{n}"
        print(f"[26 times] {name} nfft={nfft} hop={hop} on {shape} f32 white noise on {smi}: "
              f"device time of queued calls {dev_ms:.4f} ms, bound {max(t_b, t_o):.4f} ms "
              f"({'bytes' if t_b >= t_o else 'operations'})")
    print(f"[26 kernel] at nfft {nfft} (512 threads, one exchange buffer, the span in device "
          f"memory) on {smi}, from the "
          f"CUDA runtime (registers, local bytes a thread, CTAs an SM): noise_gate_fused "
          f"{noise_gate_info(nfft, hop, 0.0, dev)}, release 0.6 "
          f"{noise_gate_info(nfft, hop, 0.6, dev)}; fir_noise_gate_fused "
          f"{fir_noise_gate_info(nfft, hop, TAPS, 0.0, dev)}; resample_fir_gate_fused "
          f"{resample_fir_gate_info(UP, DOWN, h, nfft=nfft, hop=hop, device=dev)}; ptxas "
          f"<R,RS,release,512>: " + "; ".join(
              f"{k} " + "; ".join(p for p in chain_ptxas(log, k).split("; ") if ",512>" in p)
              for k in ("noise_gate_kernel", "fir_noise_gate_kernel",
                        "res_fir_noise_gate_kernel")))



SHARD_HEADLINE = (64, 479232)  # 4 time shards of 119808 = 468 hops
SHARDS = 4
CHAIN_SHARD_N = 437472  # 4 x 109368 = 4 x 744 x 147 raw samples; 4 x 465 hops resampled
C4_RATE, C4_TAPS, C4_NFFT, C4_SECONDS = 96000, 4096, 16384, 4.0  # config 4: 64 x 384000


def gate_shard_inputs(x, t, n_sh, nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES):
    """(x_ext, floor, n_valid) of time shard t of n_sh of the planar x, as
    ``parallel.sharded.gate_shard_body`` forms them: the shard and its
    right neighbour's first nfft-hop samples (zeros past the file), the
    noise floor of the file's first frames (the whole-file gate's
    prologue) and the count of the shard's frames that end in the file."""
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import noise_floor
    from audiosignalprocess_tpu_torch.ops.stft import frame
    from audiosignalprocess_tpu_torch.ops.windows import window

    d, n = nfft - hop, x.shape[-1]
    l = n // n_sh
    xp = torch.nn.functional.pad(x, (0, d))
    w = window("hann", nfft, periodic=True, dtype=x.dtype, device=x.device)
    floor = noise_floor(frame(xp[:, : d + noise_frames * hop], nfft, hop) * w)
    n_valid = min(max((n - nfft - t * l) // hop + 1, 0), l // hop)
    return xp[:, t * l : (t + 1) * l + d].contiguous(), floor, n_valid


def shard_flips(x64, t, n_sh, threshold_db=6.0):
    """Gate decisions of time shard t's frames against the file's floor,
    float32 against float64: the bins float32 rounding flips, among those
    within 60 dB of their channel's peak (``decision_flips`` for a shard)."""
    from audiosignalprocess_tpu_torch.ops.stft import frame
    from audiosignalprocess_tpu_torch.ops.windows import window

    dec, mag64 = [], None
    for dt in (torch.float32, torch.float64):
        ext, floor, nv = gate_shard_inputs(x64.to(dt), t, n_sh)
        w = window("hann", NFFT, periodic=True, dtype=dt, device=x64.device)
        mag = torch.fft.rfft(frame(ext[:, : (nv - 1) * HOP + NFFT], NFFT, HOP) * w).abs()
        dec.append(mag > floor[:, None, :] * 10.0 ** (threshold_db / 20.0))
        mag64 = mag
    loud = mag64 > 1e-3 * mag64.amax(dim=(-2, -1), keepdim=True)
    return int(((dec[0] != dec[1]) & loud).sum())


def gate_partner(k, g, mf, r, nframes):
    """The frame that frame k shares its complex transform with (re/im)
    where the parallel gate launch writes output hop g: the launch's tile
    of mf hops that owns hop g takes its frames from qa = max(0, g // mf *
    mf - (r - 1)) (the r - 1 halo frames before it) to its last, nframes
    at most, and pairs them from qa on; None where k is transformed alone
    (the odd last frame of the tile)."""
    qa = max(0, g // mf * mf - (r - 1))
    qb = min((g // mf + 1) * mf, nframes)
    p = qa + ((k - qa) ^ 1)
    return p if p < qb else None


def unexplained_hops(hops, n, shards, nfft=NFFT, hop=HOP):
    """The output hops among ``hops`` (where the time-sharded gate of a
    file of n samples over ``shards`` time shards and the whole-file gate
    differ beyond rounding) that the launches' geometry does not explain.
    A hop is explained when a frame covering it has another partner in
    its shard's launch (frame k in shard k // (l/hop), from its own
    origin, with that shard's valid frames) than in the whole-file launch,
    or is transformed alone in either: a flipped bin then follows from
    different rounding.  Both launches take gate_geometry's tile."""
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import gate_geometry

    mf, r = gate_geometry(nfft, hop, False)["mf"], nfft // hop
    lh = n // shards // hop  # hops a shard
    frames = 1 + (n - nfft) // hop
    out = []
    for g in map(int, hops):
        for k in range(max(0, g - r + 1), min(g, frames - 1) + 1):
            s = k // lh
            nv = min(max((n - nfft) // hop + 1 - s * lh, 0), lh)
            ps = gate_partner(k - s * lh, g - s * lh, mf, r, nv)
            pw = gate_partner(k, g, mf, r, frames)
            if ps is None or pw is None or ps + s * lh != pw:
                break
        else:
            out.append(g)
    return out


def sharded_rank(rank, world, seed):
    """Phase 22 on one of ``world`` ranks that share the card over gloo
    (CUDA tensors staged through host memory for every transfer): on the
    meshes (1, world) and (2, world/2), the fused time-sharded gate at
    SHARD_HEADLINE, config 4's halo'd overlap-save and the config-5
    composite as a sharded chain, each with its own launch counts; rank 0
    also holds the gathered outputs to the unsharded kernels and the
    float64 plain paths.  Returns {case: record}."""
    from audiosignalprocess_tpu_torch import parallel
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
        gate_shard_fused, noise_gate_fused, noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_fused, overlap_save_ref
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.pipeline import Chain, ResFIRGateStage
    from audiosignalprocess_tpu_torch.tools.common import make_signal
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    dev = torch.device("cuda")
    kernels = (gate_shard_fused, noise_gate_fused, overlap_save_fused, resample_mac)
    rng = np.random.default_rng(seed)
    c = SHARD_HEADLINE[0]
    h4 = design_fir(C4_TAPS, 0.1, window_kind="blackman")
    chain = Chain([ResFIRGateStage(UP, DOWN, h=design_fir(TAPS, 0.3), nfft=NFFT, hop=HOP,
                                   noise_frames=NOISE_FRAMES)])
    chain.build()
    xs = {"gate": torch.as_tensor(tone_burst(rng, *SHARD_HEADLINE), device=dev),
          "config 4": torch.as_tensor(make_signal(c, C4_RATE, C4_SECONDS, seed=seed),
                                      device=dev),
          "config 5": torch.as_tensor(tone_burst(rng, c, CHAIN_SHARD_N), device=dev)}
    refs = {}  # rank 0: (unsharded float32 kernels, float64 plain) per case

    def ref_of(name, x):
        n = x.shape[-1]
        pad = lambda y: torch.nn.functional.pad(y, (0, n - y.shape[-1]))
        if name == "gate":
            return (pad(noise_gate_fused(x.float(), noise_frames=NOISE_FRAMES)),
                    pad(noise_gate_ref(x, noise_frames=NOISE_FRAMES)))
        if name == "config 4":
            return (overlap_save_fused(x.float(), h4, C4_NFFT),
                    overlap_save_ref(x, h4, C4_NFFT))
        return chain.full(x.float()), chain.full(x)

    out = {}
    for shape in ((1, world), (2, world // 2)):
        mesh = parallel.make_mesh(*shape)
        for name, fn in (
                ("gate", parallel.sharded_noise_gate(mesh, NFFT, HOP, noise_frames=NOISE_FRAMES,
                                                     fused=True)),
                ("config 4", parallel.sharded_overlap_save(mesh, h4, C4_NFFT, fused=True)),
                ("config 5", parallel.sharded_chain(mesh, chain))):
            block = parallel.shard_audio(xs[name].float(), mesh)
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            y = fn(block)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {k.__name__: k.launches for k in kernels if k.launches}
            y = parallel.gather_audio(y, mesh)
            rec = dict(launches=counts, shape=tuple(y.shape), secs=secs,
                       finite=bool(torch.isfinite(y).all()))
            if rank == 0:
                if name not in refs:
                    refs[name] = ref_of(name, xs[name])
                rec.update(snr_vs_kernel=snr_db(refs[name][0], y),
                           snr_vs_f64_plain=snr_db(refs[name][1], y),
                           ref_shape=tuple(refs[name][1].shape))
                if name == "gate":
                    # the hops whose output differs from the whole-file
                    # kernel's beyond rounding (a flipped bin): each must be
                    # one where the two launches transform a covering frame
                    # differently (unexplained_hops)
                    err = (y - refs[name][0]).abs().reshape(c, -1, HOP).amax(dim=(0, 2))
                    g = torch.nonzero(err > 1e-5 * refs[name][0].abs().max()).flatten()
                    g = g.cpu().numpy()
                    rec.update(diff_hops=len(g), unexplained_hops=unexplained_hops(
                        g, y.shape[-1], shape[1]))
            out[f"{name} {shape}"] = rec
    return out


def sharded_phases(dev, smi, record, kernels, reset_counts):
    """Phases 20-23: the sharded whole-file program (``parallel``) and its
    kernel gate_shard_fused, then the config-3 and config-4 drivers.  Adds
    gate_shard_fused to ``record``; raises SystemExit on a failure."""
    import torch.distributed as dist

    from audiosignalprocess_tpu_torch import parallel
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
        gate_shard_fused, gate_shard_ref,
    )
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.pipeline import Chain, GateStage, ResFIRGateStage
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    def counted(fn):
        reset_counts()
        y = fn()
        torch.cuda.synchronize()
        return y, {k.__name__: k.launches for k in kernels if k.launches}

    # ---- phase 20: the kernel vs its float64 plain version on the card,
    # on the four shards of SHARD_HEADLINE (real right halos, the file's
    # floor, validity against the file's end: the last shard's frames stop
    # 3 hops short of l/hop), and on shard 1 with fewer valid frames (1,
    # 100, none); each output's memory NaN-filled before the call, every
    # position past the last frame's end 0
    c, n = SHARD_HEADLINE

    def check_shard(name, x64, t, nv=None, flips=None):
        ext, floor, nv_file = gate_shard_inputs(x64, t, SHARDS)
        ext32, floor32, _ = gate_shard_inputs(x64.float(), t, SHARDS)
        nv = nv_file if nv is None else nv
        before = gate_shard_fused.launches
        y, nan_filled = poisoned_call(lambda: gate_shard_fused(ext32, floor32, nv, NFFT, HOP),
                                      ext32.numel(), dev)
        torch.cuda.synchronize()
        end = (nv - 1) * HOP + NFFT if nv else 0
        label = (f"gate_shard_fused {name} shard {t} of {SHARDS} {c}x{ext.shape[-1]} "
                 f"n_valid={nv}")
        tail = (f" zero_past_last_frame={not bool(y[:, end:].any())}"
                f" output_in_nan_filled_block={nan_filled}")
        if y[:, end:].any() or not bool(torch.isfinite(y).all()):
            raise SystemExit(f"phase 20 failed: {label}:{tail} finite="
                             f"{bool(torch.isfinite(y).all())}")
        if nv == 0:  # nothing to hold against a reference but the zeros
            line = (f"[20 kernel] {label}: shape {tuple(y.shape)} launches "
                    f"{gate_shard_fused.launches - before}/1{tail}")
            print(line)
            if gate_shard_fused.launches != before + 1 or y.shape != ext.shape:
                raise SystemExit(f"phase 20 failed: {line}")
            return
        check_kernel(record, 20, label, y, gate_shard_ref(ext, floor, nv, NFFT, HOP),
                     gate_shard_fused, before, 1, SNR_MIN_DB,
                     ("" if flips is None else f" decision_flips_f32_vs_f64={flips}") + tail)

    for name, x in (("tone bursts", tone_burst(np.random.default_rng(20), c, n)),
                    ("white noise seed 1", np.random.default_rng(1).standard_normal((c, n))),
                    ("white noise seed 2", np.random.default_rng(2).standard_normal((c, n)))):
        x64 = torch.as_tensor(x, device=dev)
        for t in range(SHARDS):
            check_shard(name, x64, t, flips=shard_flips(x64, t, SHARDS))
        if name == "tone bursts":
            for nv in (1, 100, 0):
                check_shard(name, x64, 1, nv)
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(SHARD_HEADLINE),
                            dtype=torch.float32, device=dev)
    ext32, floor32, nv = gate_shard_inputs(noise, 1, SHARDS)
    rec = record["gate_shard_fused"]
    rec.update(ms=time_ms(lambda: gate_shard_fused(ext32, floor32, nv, NFFT, HOP)),
               plain_ms=time_ms(lambda: gate_shard_ref(ext32, floor32, nv, NFFT, HOP)),
               device_ms=queued_ms(lambda: gate_shard_fused(ext32, floor32, nv, NFFT, HOP),
                                   cycles=10 ** 8),
               library_ms=None, source="gate_kernel.cu", replaces="gate_kernel.py:338")
    set_bound(rec, 4 * (2 * ext32.numel() + floor32.numel()), c * fft_flops(NFFT, nv))
    print(f"[20 times] gate_shard_fused shard 1 of {SHARDS}, {c}x{ext32.shape[-1]} f32 white "
          f"noise, {nv} frames, on {smi}: kernel {rec['ms']:.4f} ms (device time of queued "
          f"launches {rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    # ---- phase 21: a one-rank NCCL group on a 1x1 mesh: the fused sharded
    # gate and the config-5 composite as a sharded chain at the full width,
    # each driven with every count at 0 just before and read just after
    rng = np.random.default_rng(21)
    h = design_fir(TAPS, 0.3)
    x48 = torch.as_tensor(tone_burst(rng, *HEADLINE), dtype=torch.float32, device=dev)
    x44 = torch.as_tensor(tone_burst(rng, *RES_HEADLINE), dtype=torch.float32, device=dev)
    chain5 = Chain([ResFIRGateStage(UP, DOWN, h=h, nfft=NFFT, hop=HOP,
                                    noise_frames=NOISE_FRAMES)])
    chain5.build()
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize(f"file://{tmp}/store", 1, 0, backend="nccl")
        try:
            mesh = parallel.make_mesh(1, 1)
            gate_fn = parallel.sharded_noise_gate(mesh, NFFT, HOP, noise_frames=NOISE_FRAMES,
                                                  fused=True)
            chain_fn = parallel.sharded_chain(mesh, chain5)
            parallel.warmup(chain_fn, parallel.shard_audio(x44, mesh))  # and an NCCL barrier
            runs = {}
            for name, fn, x, want in (
                    ("sharded_noise_gate(fused=True)", gate_fn, x48, {"noise_gate_fused": 1}),
                    ("sharded_chain(ResFIRGateStage)", chain_fn, x44,
                     {"resample_mac": 1, "overlap_save_fused": 1, "gate_shard_fused": 1})):
                y, counts = counted(lambda: parallel.gather_audio(
                    fn(parallel.shard_audio(x, mesh)), mesh))
                runs[name] = (y, counts)
                line = (f"[21 nccl world 1] {dist.get_backend()} {name} {tuple(x.shape)} -> "
                        f"{tuple(y.shape)} launches={counts}")
                print(line)
                if counts != want or not bool(torch.isfinite(y).all()):
                    raise SystemExit(f"phase 21 failed: {line} (want {want})")
        finally:
            dist.destroy_process_group()
    y, _ = runs["sharded_noise_gate(fused=True)"]
    whole = Chain([GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=True)])
    whole.build()
    ref = whole.full_flush(x48)
    snr64 = snr_db(GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES).full(x48.double()), y)
    line = (f"[21 nccl world 1] gate: bit-equal to the unsharded GateStage(fused=True) "
            f"{bool(torch.equal(ref, y))}, snr_vs_f64_plain={snr64:.2f} dB")
    print(line)
    if not torch.equal(ref, y) or snr64 < SNR_MIN_DB:
        raise SystemExit(f"phase 21 failed: {line}")
    y, counts = runs["sharded_chain(ResFIRGateStage)"]
    snr32, snr64 = snr_db(chain5.full(x44), y), snr_db(chain5.full(x44.double()), y)
    line = (f"[21 nccl world 1] config-5 chain {tuple(y.shape)}: snr_vs_unsharded "
            f"resample_fir_gate_fused={snr32:.2f} dB, snr_vs_f64_plain={snr64:.2f} dB")
    print(line)
    if tuple(y.shape) != (RES_HEADLINE[0], RES_OUT) or min(snr32, snr64) < SNR_MIN_DB:
        raise SystemExit(f"phase 21 failed: {line}")
    record["gate_shard_fused"]["launches"] = counts["gate_shard_fused"]

    # ---- phase 22: four ranks share the card over gloo (not a scaling
    # number: one card); every rank reports its own launches
    t0 = time.perf_counter()
    ranks = parallel.spawn_local(sharded_rank, SHARDS, backend="gloo", device="cuda",
                                 args=(22,), timeout_s=600.0)
    gate_shard = {"gate_shard_fused": 1}
    want = {"gate": gate_shard, "config 4": {"overlap_save_fused": 1},
            "config 5": {"resample_mac": 1, "overlap_save_fused": 1, **gate_shard}}
    # (against the unsharded float32 kernels, against the float64 plain
    # path).  A shard's tiles start where the whole-file launch's do not,
    # so some frames are transformed in other pairs, and a borderline bin
    # of one may flip: the bar is 100 dB, and every hop that differs beyond
    # rounding must be one of those frames' (``unexplained_hops`` empty)
    bars = {"gate": (LINEAR_MIN_DB, SNR_MIN_DB), "config 4": (LINEAR_MIN_DB, LINEAR_MIN_DB),
            "config 5": (SNR_MIN_DB, SNR_MIN_DB)}
    for case, rec0 in ranks[0].items():
        name = case.rsplit(" (", 1)[0]
        counts = [r[case]["launches"] for r in ranks]
        line = (f"[22 gloo x{SHARDS} on one card] {case} {rec0['shape']}: launches per rank "
                f"{counts} snr_vs_unsharded_kernels={rec0['snr_vs_kernel']:.2f} dB "
                f"snr_vs_f64_plain={rec0['snr_vs_f64_plain']:.2f} dB (rank 0 call "
                f"{rec0['secs']:.3f} s, host clock)")
        if name == "gate":
            line += (f"; {rec0['diff_hops']} hops differ beyond rounding, unexplained: "
                     f"{rec0['unexplained_hops']}")
        print(line)
        if (any(cn != want[name] for cn in counts) or rec0["shape"] != rec0["ref_shape"]
                or rec0.get("unexplained_hops")
                or not all(r[case]["finite"] for r in ranks)
                or rec0["snr_vs_kernel"] < bars[name][0]
                or rec0["snr_vs_f64_plain"] < bars[name][1]):
            raise SystemExit(f"phase 22 failed: {line} (want {want[name]} per rank)")
    print(f"[22 gloo x{SHARDS} on one card] {time.perf_counter() - t0:.1f} s with the start "
          f"of the ranks (host clock)")

    # ---- phase 23: the config-3 and config-4 drivers on the card, one
    # process, and config 4 under torchrun with four ranks sharing it
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    module = "audiosignalprocess_tpu_torch.tools.run_config_{}"
    for label, cmd in (
            ("config 3", ["-m", module.format(3)]),
            ("config 4", ["-m", module.format(4)]),
            ("config 4 torchrun x4 gloo 2x2", ["-m", "torch.distributed.run", "--standalone",
                                              f"--nproc-per-node={SHARDS}", "-m",
                                              module.format(4), "--backend", "gloo",
                                              "--mesh", "2x2"])):
        r = subprocess.run([sys.executable, *cmd, "--check", "--json", "--bench"], cwd=root,
                           env=env, capture_output=True, text=True, timeout=600)
        recs = [json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith("{") and "snr_db_vs_f64_plain" in ln]
        line = f"[23 driver] {label}: rc={r.returncode} {recs} on {smi}"
        print(line)
        if r.returncode != 0 or len(recs) != 1 or not recs[0]["parity"] \
                or recs[0]["device"] != "cuda":
            raise SystemExit(f"phase 23 failed: {line}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")


CFG_SECONDS = 4.0  # the drivers' default --seconds: BASELINE.json:7, 8 and 11 at 4 s
SCALING_SHAPE = (16, 147 * 64)  # tools.scaling's default channels and samples a shard


def driver_runs(root, runs, timeout=600):
    """Start every (label, args) driver run at once, each in its own process
    (``python -m`` from the checkout's root); returns {label: (rc, stdout,
    stderr)}.  Every process is waited for, and killed on a failure here."""
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = {label: subprocess.Popen([sys.executable, *args], cwd=root, env=env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for label, args in runs}
    out = {}
    try:
        for label, p in procs.items():
            so, se = p.communicate(timeout=timeout)
            out[label] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def config_driver_phases(dev, smi, kernels, reset_counts):
    """Phase 27: configs 1, 2 and 5 through the port's drivers on the card.

    27a drives each path in this process at its driver's width, every
    launch count at 0 just before and read just after: config 1
    (``overlap_save`` fused, 1 x 64000 at 16 kHz), config 2
    (``run_config_2.chain``, 2 x 176400 at 44.1 kHz -> 48 kHz), config 5's
    stream, composite stream and sharded chain (one NCCL rank, 1x1 mesh)
    at 128 x 169344 (18 blocks of 147 x 64), each on all 128 channels
    against the float64 plain chain on the card (>= 60 dB), and its ring (``run_config_5.run_ring``)
    against ``Chain.stream`` (bit-equal or >= 100 dB, printed which), K =
    3 against K = 1, the restart's tail (bit-equal) and a drained ring
    against ``stream(drain=True)`` (length and samples); the ring's
    consumer wait share and, under the profiler, the device's idle share;
    config 1's and 2's kernels alone on white noise at the drivers' shapes
    against their float64 plain versions (>= 100 dB, launches not
    counted).  In the NCCL group it also holds the sharded chain against
    the unsharded whole-file kernels (>= 60 dB) and runs ``tools.scaling.bench_mesh``
    at one NCCL rank.  27b runs the drivers as processes side by side (rc
    0, parity, device cuda; no times), config 5 sharded also under
    torchrun with four gloo ranks sharing the card, then ``tools.scaling``
    alone at gloo sizes 1, 2 and 4 (a harness check on one card: no
    scaling number).  Raises SystemExit on a failure."""
    import torch.distributed as dist

    from audiosignalprocess_tpu_torch import parallel
    from audiosignalprocess_tpu_torch.io.wav import write_wav
    from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac, fir_mac_ref
    from audiosignalprocess_tpu_torch.kernels.os_kernel import (
        overlap_save_fused, overlap_save_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import (
        resample_mac, resample_mac_ref,
    )
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
    from audiosignalprocess_tpu_torch.tools import (
        run_config_1, run_config_2, run_config_5, scaling,
    )
    from audiosignalprocess_tpu_torch.tools.common import make_signal
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    def counted(fn):
        reset_counts()
        y = fn()
        torch.cuda.synchronize()
        return y, {k.__name__: k.launches for k in kernels if k.launches}

    def fail(line, want):
        raise SystemExit(f"phase 27 failed: {line} (want {want})")

    def held(label, y, ref):
        """A kernel alone against its float64 plain version (not counted)."""
        torch.cuda.synchronize()
        snr = snr_db(ref, y)
        line = (f"[27 kernel] {label}: snr_vs_f64_plain={snr:.2f} dB "
                f"max_abs_err={float((y.double() - ref).abs().max()):.3e}")
        print(line)
        if tuple(y.shape) != tuple(ref.shape) or not bool(torch.isfinite(y).all()) \
                or snr < LINEAR_MIN_DB:
            fail(line, f">= {LINEAR_MIN_DB} dB")

    def drive(label, fn, want, ref64, samples, trim=0):
        """One counted run of fn(), its output (every channel, from ``trim``
        on) against the float64 reference ``ref64`` (>= 60 dB over all
        channels; the worst channel printed), then its time (CUDA events
        around whole calls)."""
        y, counts = counted(fn)
        got = y[:, trim:]
        ref = ref64[..., : got.shape[-1]]
        snr = snr_db(ref, got) if ref.shape == got.shape else -np.inf
        per = [snr_db(r, g) for r, g in zip(ref, got)] if ref.shape == got.shape else [-np.inf]
        ms = stream_ms(fn)
        line = (f"[27 {label}] launches={counts} snr_vs_f64_plain={snr:.2f} dB over "
                f"{got.shape[0]} of {ref64.shape[0]} channels (worst channel "
                f"{int(np.argmin(per))}: {min(per):.2f} dB); {ms:.4f} ms a call "
                f"({samples / ms * 1e3:.4e} input samples/s) on {smi}")
        print(line)
        if counts != want or snr < SNR_MIN_DB or not bool(torch.isfinite(y).all()):
            fail(line, want)
        return y

    t0 = time.perf_counter()
    # ---- 27a: config 1, mono 16 kHz, 64-tap Hann lowpass by overlap-save
    x1 = torch.as_tensor(make_signal(1, run_config_1.RATE, CFG_SECONDS), device=dev)
    h1 = design_fir(64, 0.25, window_kind="hann")
    nfft1 = run_config_1.NFFT
    noise = lambda shape: torch.as_tensor(  # noqa: E731
        np.random.default_rng(27).standard_normal(shape), device=dev)
    w1 = noise(tuple(x1.shape))
    held(f"overlap_save_fused at config 1's {tuple(x1.shape)}, white noise",
         overlap_save_fused(w1.float(), h1, nfft1), overlap_save_ref(w1, h1, nfft1))
    drive(f"config 1 overlap_save(fused=True) {tuple(x1.shape)}",
          lambda: overlap_save(x1.float(), h1, nfft1, fused=True), {"overlap_save_fused": 1},
          overlap_save_ref(x1, h1, nfft1), x1.numel())

    # ---- config 2, stereo 44.1 kHz AM -> 48 kHz (zero phase) -> 256-tap bandpass
    x2 = torch.as_tensor(make_signal(2, run_config_2.RATE_IN, CFG_SECONDS, kind="am"),
                         device=dev)
    h2 = run_config_2.bandpass()
    up, down = run_config_2.UP, run_config_2.DOWN
    w2 = noise(tuple(x2.shape))
    held(f"resample_mac zero-phase {up}/{down} at config 2's {tuple(x2.shape)}, white noise",
         resample_mac(w2.float(), up, down), resample_mac_ref(w2, up, down))
    w2 = noise((2, -(-x2.shape[-1] * up // down)))
    held(f"fir_mac 256 taps at config 2's {tuple(w2.shape)}, white noise",
         fir_mac(w2.float(), h2), fir_mac_ref(w2, h2))
    drive(f"config 2 run_config_2.chain {tuple(x2.shape)}",
          lambda: run_config_2.chain(x2.float(), h2), {"resample_mac": 1, "fir_mac": 1},
          run_config_2.chain(x2, h2, fused=False), x2.numel())

    # ---- config 5, 128 channels at 44.1 kHz: stream, composite stream, sharded
    c5, block = run_config_5.CHANNELS, run_config_5.BLOCK
    x5np = make_signal(c5, run_config_5.RATE_IN, CFG_SECONDS).astype(np.float32)
    nb = x5np.shape[-1] // block
    x5np = x5np[:, : nb * block]
    x5 = torch.as_tensor(x5np, device=dev)
    chain = run_config_5.build_chain()
    lat = chain.build()
    comp = run_config_5.build_chain(composite=True)
    comp.build()
    # the float64 plain chain over all 128 channels (float64 takes the plain
    # path on the card too: no launch)
    full64 = chain.full(x5.double())
    per_block = {"resample_mac": nb, "overlap_save_fused": nb, "gate_step_fused": nb,
                 "fir_mac": nb}
    drive(f"config 5 stream {tuple(x5.shape)} block {block} ({nb} blocks)",
          lambda: chain.stream(x5, block), per_block, full64, x5.numel(), trim=lat)
    drive(f"config 5 stream --composite {tuple(x5.shape)} ({nb} blocks)",
          lambda: comp.stream(x5, block), {"res_fir_gate_step_fused": nb}, full64,
          x5.numel(), trim=lat)
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize(f"file://{tmp}/store", 1, 0, backend="nccl")
        try:
            mesh = parallel.make_mesh(1, 1)
            fn = parallel.sharded_chain(mesh, chain)
            xs = parallel.shard_audio(x5, mesh)
            parallel.warmup(fn, xs)
            y = drive(f"config 5 sharded {dist.get_backend()} world 1 mesh 1x1 "
                      f"{tuple(x5.shape)}", lambda: parallel.gather_audio(fn(xs), mesh),
                      {"resample_mac": 1, "overlap_save_fused": 1, "gate_shard_fused": 1,
                       "fir_mac": 1}, full64, x5.numel())
            # the sharded chain against the unsharded whole-file kernels
            # (chain.full: noise_gate_fused for the gate; >= 60 dB), and
            # where both depart from float64: the hops whose error passes
            # 1e-4 of the peak on any channel
            whole = chain.full(x5)
            s_whole = snr_db(whole, y) if whole.shape == y.shape else -np.inf
            err = (y - full64).abs().reshape(c5, -1, HOP).amax(dim=(0, 2))
            hops = torch.nonzero(err > 1e-4 * full64.abs().max()).flatten().tolist()
            line = (f"[27 config 5 sharded] against the unsharded whole-file kernels "
                    f"(chain.full), all {c5} channels: {s_whole:.2f} dB; the whole-file "
                    f"kernels against float64: {snr_db(full64, whole):.2f} dB; hops past "
                    f"1e-4 of the peak against float64: {len(hops)} {hops[:12]}")
            print(line)
            if s_whole < SNR_MIN_DB:
                fail(line, f">= {SNR_MIN_DB} dB")
            rate = scaling.bench_mesh(1, *SCALING_SHAPE, device="cuda")
            print(f"[27 scaling] tools.scaling.bench_mesh at one NCCL rank in this process, "
                  f"{SCALING_SHAPE[0]} x {SCALING_SHAPE[1]} a shard on {smi}: {rate:.4e} "
                  f"samples/s")
        finally:
            dist.destroy_process_group()

    # ---- config 5's ring: native decode thread -> SPSC ring -> chain.step
    def same(ref, out):
        """(bit-equal, its text): bit-equal, or the SNR in dB."""
        if ref.shape == out.shape and np.array_equal(ref, out):
            return True, np.inf, "bit-equal"
        snr = snr_db(ref, out) if ref.shape == out.shape else -np.inf
        return False, snr, f"{snr:.2f} dB"

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "in.wav")
        write_wav(wav, x5np, run_config_5.RATE_IN, float_fmt=True)

        def ring(path=wav, **kw):
            stats = {}
            out, n_run, secs = run_config_5.run_ring(chain, path, block, c5, device=dev,
                                                     stats=stats, **kw)
            return out, n_run, secs, stats["wait_s"] / secs

        stream = chain.stream(x5, block).cpu().numpy()
        ring(warmup=True)  # the first run pins the host buffers and uploads the tables
        for k in (1, 3):
            (out, n_run, secs, wait), counts = counted(lambda: ring(batch_blocks=k, warmup=True))
            exact, snr, text = same(stream, out)
            line = (f"[27 ring] K={k}: {n_run} blocks launches={counts} against Chain.stream: "
                    f"{text}; {secs:.4f} s ({x5.numel() / secs:.4e} input samples/s, host "
                    f"clock from the decode thread's start), consumer waited for the ring "
                    f"{wait:.4f} of it, on {smi}")
            print(line)
            if counts != per_block or n_run != nb or not (exact or snr >= LINEAR_MIN_DB):
                fail(line, per_block)
            if k == 1:
                out1 = out
            elif not np.array_equal(out, out1):
                fail(f"[27 ring] K=3 differs from K=1: {same(out1, out)[2]}", "bit-equal")
        print("[27 ring] K=3 bit-equal to K=1: True")
        idle = device_idle_share(lambda: ring())
        print(f"[27 ring] K=1 under torch.profiler on {smi}: device idle {idle_text(idle)} "
              f"of its span")
        half = nb // 2
        ck = os.path.join(tmp, "carry.npz")
        out_a = ring(ckpt=(ck, half))[0]
        out_b, n_b = ring(resume=ck)[:2]
        tail = out_a[..., half * chain.out_block(block):]
        ok = np.array_equal(tail, out_b)
        line = (f"[27 ring] restart from the checkpoint at block {half}: {n_b} blocks resumed, "
                f"tail {out_b.shape} bit-equal {ok}")
        print(line)
        if not ok or n_b != nb - half:
            fail(line, "a bit-equal tail")
        n_d = x5np.shape[-1] - 333  # a file that is no whole number of blocks
        wav_d = os.path.join(tmp, "drain.wav")
        write_wav(wav_d, x5np[:, :n_d], run_config_5.RATE_IN, float_fmt=True)
        (out_d, nb_d, _, _), counts = counted(lambda: ring(wav_d, drain=True, batch_blocks=3))
        ref_d = chain.stream(x5[:, :n_d], block, drain=True).cpu().numpy()
        exact, snr, text = same(ref_d, out_d)
        want = {k: nb_d for k in per_block}
        line = (f"[27 ring] --drain K=3 on {c5}x{n_d}: {nb_d} blocks launches={counts}, "
                f"{out_d.shape} against stream(drain=True) {ref_d.shape} "
                f"(out_len {chain.out_len(n_d)}): {text}")
        print(line)
        if counts != want or out_d.shape != (c5, chain.out_len(n_d)) \
                or not (exact or snr >= LINEAR_MIN_DB):
            fail(line, want)
    t_a = time.perf_counter() - t0

    # ---- 27b: the drivers as processes (side by side: no times), then the
    # scaling harness alone
    root = Path(__file__).resolve().parent
    m5 = ["-m", "audiosignalprocess_tpu_torch.tools.run_config_5"]
    runs = [("config 1", ["-m", "audiosignalprocess_tpu_torch.tools.run_config_1"]),
            ("config 2", ["-m", "audiosignalprocess_tpu_torch.tools.run_config_2", "--check"]),
            ("config 5 stream", [*m5, "--check"]),
            ("config 5 stream --composite", [*m5, "--composite", "--check"]),
            ("config 5 ring --demo-restart", [*m5, "--mode", "ring", "--check",
                                              "--demo-restart"]),
            ("config 5 ring --drain --ring-batch 3", [*m5, "--mode", "ring", "--check",
                                                      "--drain", "--ring-batch", "3"]),
            ("config 5 sharded", [*m5, "--mode", "sharded", "--check"]),
            (f"config 5 sharded torchrun x{SHARDS} gloo",
             ["-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={SHARDS}", *m5,
              "--mode", "sharded", "--backend", "gloo", "--check"])]
    t0 = time.perf_counter()
    done = driver_runs(root, [(label, [*args, "--json"]) for label, args in runs])
    for label, (rc, so, se) in done.items():
        recs = [json.loads(ln) for ln in so.splitlines() if ln.startswith('{"config"')]
        line = f"[27 driver] {label}: rc={rc} {recs}"
        print(line)
        ranks = SHARDS if "torchrun" in label else 1
        if rc != 0 or len(recs) != 1 or not recs[0]["parity"] or recs[0]["device"] != "cuda" \
                or recs[0]["ranks"] != ranks \
                or ("restart" in label and not recs[0].get("restart_tail_bit_equal")):
            raise SystemExit(f"phase 27 failed: {line}\n{so[-2000:]}\n{se[-3000:]}")
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    label = "gloo ranks sharing the card"
    rc, so, se = driver_runs(root, [(label, [
        "-m", "audiosignalprocess_tpu_torch.tools.scaling", "--json", "--backend", "gloo",
        "--sizes", "1,2,4", "--channels", str(SCALING_SHAPE[0]), "--per-shard",
        str(SCALING_SHAPE[1])])])[label]
    rows = [json.loads(ln) for ln in so.splitlines() if ln.startswith('{"devices"')]
    line = f"[27 scaling] tools.scaling, {label} ({smi}): rc={rc} {rows}"
    print(line)
    if rc != 0 or {r["devices"] for r in rows} != {1, 2, 4} \
            or any(r["device"] != "cuda" or not r["samples_per_s"] > 0 for r in rows):
        raise SystemExit(f"phase 27 failed: {line}\n{so[-2000:]}\n{se[-3000:]}")
    print(f"[27 time] in-process {t_a:.1f} s, driver processes {t_b:.1f} s, scaling "
          f"{time.perf_counter() - t0:.1f} s (host clock)")


FFT_VARIANTS = {  # kernel: (ops.fft impl, smallest n, the TPU kernel it replaces)
    "fft_fourstep": ("fourstep", 4, "fft_kernel.py:652"),
    "fft_radix2_lanes": ("radix2_lanes", 2, "fft_kernel.py:826"),
    "fft_radix2_stages": ("radix2_stages", 2, "fft_kernel.py:743"),
    "fft_pease_lanes": ("pease", 2, "fft_kernel.py:1383"),
}
# each kernel's smallest n, then these; 16384 is past the shared-memory limit of
# every variant but fft_fourstep and runs on buffers in device memory
VARIANT_SIZES = (8, 512, 1024, 4096, 16384)
VARIANT_BATCHES = (1, 5, 300)
SLICE_LAUNCHES = 4  # per whole-file call: an rfft and an irfft (each a 512-point
# complex transform) in the overlap-save, and another pair in the gate
# the kernels redesigned for the card's tensor cores and registers (the
# variants and fft_stockham_lanes), with their launch geometries: held at
# every n from the smallest to 16384 (a partial last
# CTA), then at the rows the slice (an rfft and an irfft of each block) and the
# timings give them; fft_radix2_stages (fft_radix2_lanes' passes on its stacked
# table) also bit for bit against fft_radix2_lanes there
REDESIGNED = {"fft_fourstep": ("fourstep_geometry", 4),
              "fft_radix2_lanes": ("radix2_lanes_geometry", 2),
              "fft_radix2_stages": ("radix2_lanes_geometry", 2),
              "fft_pease_lanes": ("pease_geometry", 2),
              "fft_stockham_lanes": ("stockham_geometry", 2)}  # (geometry, smallest n)
REDESIGN_PATH = ((32000, 512), (119808, 512), (FFT_TIMED, 1024), (FFT_TIMED, 4096))
TF32_PEAK_FLOP_S = 495e12  # dense TF32 tensor-core peak of the H100 SXM (data sheet)


def fft_variant_phase(dev, smi, record, kernels, reset_counts, h):
    """Phase 24: the FFT variant kernels (fft_fourstep, fft_radix2_lanes,
    fft_radix2_stages, fft_pease_lanes) alone, and with them the register
    passes of fft_stockham_lanes at every n, then the slice: bench.py's
    False mode (FIRStage -> GateStage, unfused) with each variant's impl at
    the full width, then times.  Adds the four kernels to ``record``;
    raises SystemExit on a failure."""
    from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
    from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
    from audiosignalprocess_tpu_torch.pipeline import Chain, FIRStage, GateStage
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    # ---- phase 24a: each kernel (both signs) vs its float64 plain version
    # on the card and vs torch.fft in float64
    rng = np.random.default_rng(24)
    worst = {}
    for name, (_, least, _) in FFT_VARIANTS.items():
        kernel, plain = getattr(fk, name), getattr(fk, f"{name}_ref")
        for n in (least, *VARIANT_SIZES):
            parts = []
            for b in VARIANT_BATCHES:
                xr = torch.as_tensor(rng.standard_normal((b, n)), device=dev)
                xi = torch.as_tensor(rng.standard_normal((b, n)), device=dev)
                z = torch.complex(xr, xi)
                for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
                    before = kernel.launches
                    y = torch.cat(kernel(xr.float(), xi.float(), sign))
                    torch.cuda.synchronize()
                    ref = torch.cat(plain(xr, xi, sign))
                    snr, snr_lib = snr_db(ref, y), snr_db(torch.cat([lib.real, lib.imag]), y)
                    err = float((y.double() - ref).abs().max())
                    rec = record.setdefault(name, dict(max_abs_err=0.0, min_snr_db=np.inf))
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    rec["min_snr_db"] = min(rec["min_snr_db"], snr)
                    worst[name] = min(worst.get(name, np.inf), snr, snr_lib)
                    parts.append(f"b={b} {'fwd' if sign < 0 else 'inv'} {snr:.2f}/{snr_lib:.2f}")
                    if not (tuple(y.shape) == (2 * b, n) and bool(torch.isfinite(y).all())
                            and min(snr, snr_lib) >= LINEAR_MIN_DB
                            and kernel.launches == before + 1):
                        raise SystemExit(f"phase 24 failed: {name} n={n} b={b} sign={sign} "
                                         f"snr={snr:.2f} snr_vs_torch_fft={snr_lib:.2f} "
                                         f"launches={kernel.launches - before}")
            print(f"[24 kernel] {name} n={n} snr_vs_f64_plain/torch.fft_f64 dB: "
                  + ", ".join(parts))
    for name, (geometry, least) in REDESIGNED.items():
        kernel, plain = getattr(fk, name), getattr(fk, f"{name}_ref")
        shapes = [(3 * getattr(fk, geometry)(1 << k)[0] + 1, 1 << k)
                  for k in range(least.bit_length() - 1, 15)] + list(REDESIGN_PATH)
        for b, n in shapes:
            gen = torch.Generator(device=dev).manual_seed(24 * b + n)
            xr = torch.randn((b, n), generator=gen, dtype=torch.float64, device=dev)
            xi = torch.randn((b, n), generator=gen, dtype=torch.float64, device=dev)
            z = torch.complex(xr, xi)
            parts = []
            for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
                before = kernel.launches
                y = kernel(xr.float(), xi.float(), sign)
                torch.cuda.synchronize()
                ref = plain(xr, xi, sign)
                snr, snr_lib = snr_db_planes(ref, y), snr_db_planes((lib.real, lib.imag), y)
                err = max(float((t.double() - r).abs().max()) for t, r in zip(y, ref))
                rec = record.setdefault(name, dict(max_abs_err=0.0, min_snr_db=np.inf))
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["min_snr_db"] = min(rec["min_snr_db"], snr)
                worst[name] = min(worst.get(name, np.inf), snr, snr_lib)
                parts.append(f"{'fwd' if sign < 0 else 'inv'} {snr:.2f}/{snr_lib:.2f}")
                launched = kernel.launches - before
                same = True
                if name == "fft_radix2_stages":  # the lanes kernel's passes, its stacked table
                    lanes = fk.fft_radix2_lanes(xr.float(), xi.float(), sign)
                    same = all(torch.equal(t, u) for t, u in zip(y, lanes))
                    parts[-1] += f" {'==' if same else '!='} fft_radix2_lanes"
                if not (tuple(y[0].shape) == (b, n) and all(bool(torch.isfinite(t).all()) for t in y)
                        and min(snr, snr_lib) >= LINEAR_MIN_DB and launched == 1 and same):
                    raise SystemExit(f"phase 24 failed: redesigned {name} {b}x{n} sign={sign} "
                                     f"snr={snr:.2f} snr_vs_torch_fft={snr_lib:.2f} "
                                     f"launches={launched} bit-equal to fft_radix2_lanes={same}")
            print(f"[24 kernel] redesigned {name} {b}x{n} snr_vs_f64_plain/torch.fft_f64 dB: "
                  + ", ".join(parts))
            del xr, xi, z, y, ref
    print(f"[24 kernel] FFT variants' worst reading over n in each smallest and "
          f"{VARIANT_SIZES}, batch in {VARIANT_BATCHES}, both signs, and for "
          f"{', '.join(REDESIGNED)} every n to 16384 and {REDESIGN_PATH} (against the float64 "
          f"plain version and torch.fft float64): "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in worst.items()))

    # ---- phase 24b: the slice at the full width on tone bursts, each impl
    # driven with every count at 0 just before and read just after
    c, n = HEADLINE

    def chain(impl):
        ch = Chain([FIRStage(h=h, nfft=NFFT, impl=impl),
                    GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, impl=impl)])
        ch.build()
        return ch

    x64 = torch.as_tensor(tone_burst(rng, c, n), device=dev)
    x32 = x64.float()
    ref, os_ref = chain("torch").full_flush(x64), overlap_save(x64, h, NFFT, impl="torch")
    flips = decision_flips(FIRStage(h=h, nfft=NFFT).full(x64))
    for name, (impl, _, _) in FFT_VARIANTS.items():
        slice_chain = chain(impl)
        for label, run, want, want_ref, bar in (
                (f"Chain([FIRStage, GateStage](impl={impl!r})).full_flush",
                 lambda: slice_chain.full_flush(x32), SLICE_LAUNCHES, ref, SNR_MIN_DB),
                (f"ops.overlap_save(impl={impl!r})", lambda: overlap_save(x32, h, NFFT, impl=impl),
                 2, os_ref, LINEAR_MIN_DB)):
            reset_counts()
            y = run()
            torch.cuda.synchronize()
            counts = {k.__name__: k.launches for k in kernels if k.launches}
            snr = snr_db(want_ref, y)
            line = (f"[24 slice] {label} {c}x{n} tone bursts: launches={counts} "
                    f"snr_vs_f64_torch_fft={snr:.2f} dB")
            if want == SLICE_LAUNCHES:
                line += f" decision_flips_f32_vs_f64={flips}"
                record[name]["launches"] = counts.get(name, 0)
            print(line)
            if counts != {name: want} or tuple(y.shape) != (c, n) \
                    or not bool(torch.isfinite(y).all()) or snr < bar:
                raise SystemExit(f"phase 24 failed: {line} (want {{{name!r}: {want}}})")
    del x64, x32, ref, os_ref

    # ---- phase 24c: times at FFT_TIMED rows, bound as fft_stockham_lanes'
    # row (16 B n bytes, 5 n log2 n operations a row); the slice per call
    src = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB
    dst = torch.empty_like(src)
    copy_bw = 2 * src.numel() * 4 / time_ms(lambda: dst.copy_(src)) * 1e3
    del src, dst
    peak_flop_s = chip_peaks()[1]
    b = FFT_TIMED
    for m in (1024, 4096):
        xr = torch.randn(b, m, device=dev)
        xi = torch.randn(b, m, device=dev)
        z = torch.complex(xr, xi)
        lib_ms = time_ms(lambda: torch.fft.fft(z))
        for name in FFT_VARIANTS:
            kernel, plain = getattr(fk, name), getattr(fk, f"{name}_ref")
            ms = time_ms(lambda: kernel(xr, xi, -1.0))
            plain_ms = time_ms(lambda: plain(xr, xi, -1.0), reps=5, warmup=1)
            rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
            set_bound(rec, 16 * b * m, b * fft_flops(m))
            bw = 16 * b * m / ms * 1e3
            own = ""
            if name == "fft_fourstep":
                n1, n2 = fk.fourstep_split(m)
                ops = 8.0 * b * m * (n1 + n2)  # its dense products: 8 m (n1 + n2) a row
                # on the tensor cores, 3 passes each: the row side, and the column side
                # from n1 = 8 (below it the column side is float32 FMAs)
                tc_ops = 3.0 * 8.0 * b * m * (n2 + (n1 if n1 >= 8 else 0))
                own = (f"; its own operation count {ops / 1e9:.4f} GFLOP, "
                       f"{ops / ms / 1e9:.2f} TFLOP/s = "
                       f"{ops / ms * 1e3 / peak_flop_s * 100:.1f} % of "
                       f"{peak_flop_s / 1e12:.0f} TFLOP/s float32; tensor operations "
                       f"(3xTF32) {tc_ops / 1e9:.4f} GFLOP, {tc_ops / ms / 1e9:.2f} TFLOP/s = "
                       f"{tc_ops / ms * 1e3 / TF32_PEAK_FLOP_S * 100:.1f} % of "
                       f"{TF32_PEAK_FLOP_S / 1e12:.0f} TFLOP/s TF32, bound by them "
                       f"{tc_ops / TF32_PEAK_FLOP_S * 1e3:.4f} ms")
            print(f"[24 times] {name} {b}x{m} f32 on {smi}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.fft (library) {lib_ms:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); {bw / 1e9:.1f} GB/s = "
                  f"{bw / copy_bw * 100:.1f} % of the copy probe ({copy_bw / 1e12:.4f} TB/s){own}")
            if m == 1024:
                record[name].update(rec, source="fft_kernel.cu",
                                    replaces=FFT_VARIANTS[name][2])
    xn = torch.as_tensor(np.random.default_rng(0).standard_normal(HEADLINE),
                         dtype=torch.float32, device=dev)
    impl_kernel = {v[0]: k for k, v in FFT_VARIANTS.items()}
    for impl in ("stockham", *impl_kernel):
        slice_chain = chain(impl)
        ms = time_ms(lambda: slice_chain.full_flush(xn), reps=10, warmup=2)
        print(f"[24 times] slice Chain([FIRStage, GateStage](impl={impl!r})).full_flush "
              f"{c}x{n} f32 white noise on {smi}: {ms:.4f} ms per call "
              f"({c * n / ms * 1e3:.4e} samples/s)")
        if impl in impl_kernel:
            record[impl_kernel[impl]]["slice_ms"] = ms


MANUAL_SIZES = tuple(1 << k for k in range(1, 14))  # 8192: the ring's longest row, 2 deep
MANUAL_TIMED = ((4096, 1024), (4096, 4096), (32768, 4096))  # the last: the JAX A/B's point
MANUAL_PATH = ((32000, 512), (119808, 512), *MANUAL_TIMED)  # the slice's rows, then the timed
MANUAL_REPS = 4


def snr_db_planes(ref, test):
    """``snr_db`` of planar (re, im) pairs, reduced in float64 on their
    device (at the largest rows the host would take seconds)."""
    p_sig = sum(float((r.double() ** 2).sum()) for r in ref)
    p_err = sum(float(((r.double() - t.double()) ** 2).sum()) for r, t in zip(ref, test))
    return np.inf if p_err == 0.0 else 10.0 * np.log10(p_sig / p_err)


@contextlib.contextmanager
def sk_pipe(value):
    """ASP_SK_PIPE set to ``value`` (None: unset) inside the block only."""
    old = os.environ.pop("ASP_SK_PIPE", None)
    if value is not None:
        os.environ["ASP_SK_PIPE"] = value
    try:
        yield
    finally:
        os.environ.pop("ASP_SK_PIPE", None)
        if old is not None:
            os.environ["ASP_SK_PIPE"] = old


def fft_manual_phase(dev, smi, record, kernels, reset_counts, h):
    """Phase 25: fft_stockham_manual (the copy-ring Stockham kernel) alone
    at the ring's edges, then the slice on the JAX package's hardware
    route for real transforms (``stockham_split``) under ASP_SK_PIPE=manual
    and without it, then the JAX A/B's timing protocol.  Adds the kernel
    to ``record``; raises SystemExit on a failure."""
    from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
    from audiosignalprocess_tpu_torch.pipeline import Chain, FIRStage, GateStage
    from audiosignalprocess_tpu_torch.utils.metrics import (
        detect_chip, fft_roofline_bytes, roofline_time_s, snr_db,
    )

    kernel = fk.fft_stockham_manual
    rec = record.setdefault(kernel.__name__, dict(max_abs_err=0.0, min_snr_db=np.inf))

    # ---- phase 25a: the kernel (both signs) vs its float64 plain version
    # and torch.fft in float64: one row (fewer tiles than slots; at n = 2
    # a tile too short for a bulk copy), 300 rows (a partial last tile at
    # n = 256), 3 grid + 1 tiles (every CTA fills its ring, one takes a
    # tile more), and 300 rows that start 4 bytes past an aligned address
    # (copied before any bulk copy)
    rng = np.random.default_rng(25)
    worst = np.inf
    for n in MANUAL_SIZES:
        rows, nbuf, smem = fk.manual_ring(n)
        grid = fk.manual_ctas(n, dev)
        parts = []
        for b in (1, 300, (3 * grid + 1) * rows, "view"):
            shape = (300 if b == "view" else b, n)
            xr = torch.as_tensor(rng.standard_normal(shape), device=dev)
            xi = torch.as_tensor(rng.standard_normal(shape), device=dev)
            xr32, xi32 = xr.float(), xi.float()
            if b == "view":
                pad = xr32.new_zeros(1)
                xr32 = torch.cat([pad, xr32.reshape(-1)])[1:].view(shape)
                xi32 = torch.cat([pad, xi32.reshape(-1)])[1:].view(shape)
            z = torch.complex(xr, xi)
            for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
                before = kernel.launches
                y = torch.cat(kernel(xr32, xi32, sign))
                torch.cuda.synchronize()
                ref = torch.cat(fk.fft_stockham_manual_ref(xr, xi, sign))
                snr, snr_lib = snr_db(ref, y), snr_db(torch.cat([lib.real, lib.imag]), y)
                err = float((y.double() - ref).abs().max())
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["min_snr_db"] = min(rec["min_snr_db"], snr)
                worst = min(worst, snr, snr_lib)
                parts.append(f"b={b} {'fwd' if sign < 0 else 'inv'} {snr:.2f}/{snr_lib:.2f}")
                if not (tuple(y.shape) == (2 * shape[0], n) and bool(torch.isfinite(y).all())
                        and min(snr, snr_lib) >= LINEAR_MIN_DB
                        and kernel.launches == before + 1):
                    raise SystemExit(f"phase 25 failed: fft_stockham_manual n={n} b={b} "
                                     f"sign={sign} snr={snr:.2f} snr_vs_torch_fft={snr_lib:.2f} "
                                     f"launches={kernel.launches - before}")
        print(f"[25 kernel] fft_stockham_manual n={n} ({rows} rows a tile, {nbuf} slots, "
              f"{smem} B of shared memory, {grid} resident CTAs) snr_vs_f64_plain/"
              f"torch.fft_f64 dB: " + ", ".join(parts))
    z16 = torch.zeros((2, 16384), dtype=torch.float32, device=dev)
    before = kernel.launches
    try:
        kernel(z16, z16, -1.0)
        raised = ""
    except ValueError as e:
        raised = str(e)
    line = f"[25 kernel] fft_stockham_manual n=16384 (past the ring): raised {raised!r}"
    print(line)
    if "SMEM_LIMIT" not in raised or kernel.launches != before:
        raise SystemExit(f"phase 25 failed: {line}")

    # the rows the main path gives the kernel (the slice's 512-point
    # transforms, 20 and 76 tiles a CTA) and the timed points (up to 248):
    # every slot's barrier parity flips back and forth many times
    gen = torch.Generator(device=dev).manual_seed(25)
    for b, n in MANUAL_PATH:
        rows, nbuf, _ = fk.manual_ring(n)
        grid = fk.manual_ctas(n, dev)
        xr = torch.randn((b, n), generator=gen, dtype=torch.float64, device=dev)
        xi = torch.randn((b, n), generator=gen, dtype=torch.float64, device=dev)
        parts = []
        for sign in (-1.0, 1.0):
            before = kernel.launches
            y = kernel(xr.float(), xi.float(), sign)
            torch.cuda.synchronize()
            launched = kernel.launches - before
            ref = fk.fft_stockham_manual_ref(xr, xi, sign)
            z = torch.complex(xr, xi)
            lib = torch.fft.fft(z) if sign < 0 else torch.fft.ifft(z) * n
            snr = snr_db_planes(ref, y)
            snr_lib = snr_db_planes((lib.real, lib.imag), y)
            del z, lib
            err = max(float((t.double() - r).abs().max()) for r, t in zip(ref, y))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["min_snr_db"] = min(rec["min_snr_db"], snr)
            worst = min(worst, snr, snr_lib)
            parts.append(f"{'fwd' if sign < 0 else 'inv'} {snr:.2f}/{snr_lib:.2f}")
            ok = (all(tuple(t.shape) == (b, n) and bool(torch.isfinite(t).all()) for t in y)
                  and min(snr, snr_lib) >= LINEAR_MIN_DB and launched == 1)
            del y, ref
            if not ok:
                raise SystemExit(f"phase 25 failed: fft_stockham_manual {b}x{n} sign={sign} "
                                 f"snr={snr:.2f} snr_vs_torch_fft={snr_lib:.2f} "
                                 f"launches={launched}")
        del xr, xi
        tiles = -(-b // rows)
        print(f"[25 kernel] fft_stockham_manual {b}x{n} ({tiles} tiles on {grid} CTAs, "
              f"{tiles / grid:.1f} a CTA through {nbuf} slots) snr_vs_f64_plain/"
              f"torch.fft_f64 dB: " + ", ".join(parts))
    print(f"[25 kernel] fft_stockham_manual worst reading over n in {MANUAL_SIZES} at the "
          f"ring-edge batches and {MANUAL_PATH}, both signs (against the float64 plain "
          f"version and torch.fft float64): {worst:.2f} dB")

    # ---- phase 25b: the slice at the full width on tone bursts, with the
    # real transforms on the JAX package's hardware route (pack and
    # untangle around the complex kernel), each pipe driven with every
    # count at 0 just before and read just after
    c, n = HEADLINE

    def chain():
        ch = Chain([FIRStage(h=h, nfft=NFFT, impl="stockham_split"),
                    GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES,
                              impl="stockham_split")])
        ch.build()
        return ch

    x64 = torch.as_tensor(tone_burst(rng, c, n), device=dev)
    x32 = x64.float()
    ref = Chain([FIRStage(h=h, nfft=NFFT, impl="torch"),
                 GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES,
                           impl="torch")]).full_flush(x64)
    flips = decision_flips(FIRStage(h=h, nfft=NFFT).full(x64))
    for pipe, name in (("manual", "fft_stockham_manual"), (None, "fft_stockham_lanes")):
        with sk_pipe(pipe):
            slice_chain = chain()
            reset_counts()
            y = slice_chain.full_flush(x32)
            torch.cuda.synchronize()
            counts = {k.__name__: k.launches for k in kernels if k.launches}
        snr = snr_db(ref, y)
        line = (f"[25 slice] Chain([FIRStage, GateStage](impl='stockham_split')).full_flush "
                f"ASP_SK_PIPE={pipe or 'unset'} {c}x{n} tone bursts: launches={counts} "
                f"snr_vs_f64_torch_fft={snr:.2f} dB decision_flips_f32_vs_f64={flips}")
        print(line)
        if counts != {name: SLICE_LAUNCHES} or tuple(y.shape) != (c, n) \
                or not bool(torch.isfinite(y).all()) or snr < SNR_MIN_DB:
            raise SystemExit(f"phase 25 failed: {line} (want {{{name!r}: {SLICE_LAUNCHES}}})")
        if pipe == "manual":
            rec["launches"] = counts[name]
    del x64, x32, ref, y

    # ---- phase 25c: times in the JAX A/B's protocol: the arms (grid
    # kernel, manual kernel, torch.fft) interleaved round-robin over
    # MANUAL_REPS reps, each timing bracketed by its own copy probe and read
    # as kernel bytes/s over the mean of the two; then the slice per call
    # and its device idle share under each pipe
    chip = detect_chip()
    with sk_pipe(None):  # the grid arm is fft_stockham_lanes' own kernel
        probe = copy_probe(dev)
        for b, m in MANUAL_TIMED:
            xr = torch.randn(b, m, device=dev)
            xi = torch.randn(b, m, device=dev)
            z = torch.complex(xr, xi)
            nbytes = fft_roofline_bytes(b, m, 4, complex_io=True)
            bound_ms = roofline_time_s(nbytes, chip) * 1e3
            arms = {"fft_stockham_lanes (grid)": lambda: fk.fft_stockham_lanes(xr, xi, -1.0),
                    "fft_stockham_manual": lambda: fk.fft_stockham_manual(xr, xi, -1.0),
                    "torch.fft (library)": lambda: torch.fft.fft(z)}
            med, probes = round_robin(arms, nbytes, probe, MANUAL_REPS)
            print(f"[25 times] {b}x{m} f32 complex on {smi}, {MANUAL_REPS} reps round-robin, "
                  f"medians: {round_robin_text(med, probes)}; bound {bound_ms:.4f} ms (bytes, "
                  f"utils.metrics {chip.name})")
            if (b, m) == (4096, 1024):
                plain_ms = time_ms(lambda: fk.fft_stockham_manual_ref(xr, xi, -1.0),
                                   reps=5, warmup=1)
                rec.update(ms=med["fft_stockham_manual"][0], plain_ms=plain_ms,
                           library_ms=med["torch.fft (library)"][0],
                           source="fft_manual_kernel.cu", replaces="fft_kernel.py:1278")
                set_bound(rec, nbytes, b * fft_flops(m))
                print(f"[25 times] fft_stockham_manual {b}x{m}: plain {plain_ms:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            del xr, xi, z
        del probe
    xn = torch.as_tensor(np.random.default_rng(0).standard_normal(HEADLINE),
                         dtype=torch.float32, device=dev)
    for pipe in ("manual", None):
        with sk_pipe(pipe):
            slice_chain = chain()
            ms = time_ms(lambda: slice_chain.full_flush(xn), reps=10, warmup=2)
            idle = device_idle_share(lambda: slice_chain.full_flush(xn))
        print(f"[25 times] slice Chain([FIRStage, GateStage](impl='stockham_split')).full_flush "
              f"ASP_SK_PIPE={pipe or 'unset'} {c}x{n} f32 white noise on {smi}: {ms:.4f} ms per "
              f"call ({c * n / ms * 1e3:.4e} samples/s); device idle {idle_text(idle)}")


UNFUSED_IMPLS = {  # ops.fft impl (ASP_SK_PIPE): launches of one real-transform pair
    "auto": (None, {"rfft_stockham": 1, "irfft_stockham": 1}),
    "stockham_split": (None, {"fft_stockham_lanes": 2}),
    "stockham_split manual": ("manual", {"fft_stockham_manual": 2}),
    **{impl: (None, {name: 2}) for name, (impl, _, _) in FFT_VARIANTS.items()},
}
# phase 28c's step streams: (channels, block, blocks): bench.py's stream width
# and config 5's (128 channels, 10240 resampled samples a block)
UNFUSED_WIDTHS = ((HEADLINE[0], BLOCK, 30), (128, 10240, 12))


@contextlib.contextmanager
def torch_fft_calls():
    """Count the calls of torch.fft's transforms (cuFFT on the card) made
    inside the block: {"n": count}."""
    names = ("fft", "ifft", "rfft", "irfft")
    saved = {name: getattr(torch.fft, name) for name in names}
    calls = {"n": 0}

    def counting(fn):
        def call(*args, **kw):
            calls["n"] += 1
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(torch.fft, name, counting(fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(torch.fft, name, fn)


def unfused_phases(dev, smi, kernels, reset_counts, x_main, h):
    """Phase 28: the unfused float32 routes, each driven with every launch
    count at 0 just before and read just after, block by block (each
    ``Chain.step``'s launches recorded), with torch.fft's calls counted
    (none may run: no cuFFT) and no fused kernel launched, held on all
    channels against the float64 plain chain on the card (>= 60 dB, the
    worst channel and the plain gate's flipped bins printed), and timed
    beside the fused route (``time_ms`` of whole calls, ``stream_ms`` of
    streams, the device idle share under torch.profiler).

    28a: path A as ``FIRGateStage(fused=False)`` at 64 x 480000, whole file
    and drained stream in blocks of 4096 (two ``rfft_stockham`` and two
    ``irfft_stockham`` a call or a block).  28b: config 5 as
    ``run_config_5.build_chain(fused=False, composite=True)`` at 128 x
    169344 (18 blocks of 147 x 64): ``Chain.stream`` and the ring at K = 1
    (``run_ring``, against the stream: bit-equal or >= 100 dB), then the
    driver's ``--composite --no-fused --mode ring`` as a process with
    ``--check``.  28c: ``GateStage(fused=False, impl)`` and
    ``StretchStage(4, 3, fused=False, impl)`` streamed (drained) under
    ``auto`` and each kernel impl (``UNFUSED_IMPLS``; ``stockham_split``
    also under ``ASP_SK_PIPE=manual``) at ``UNFUSED_WIDTHS``, ``auto``
    timed beside the fused step.  Raises SystemExit on a failure."""
    from audiosignalprocess_tpu_torch.io.wav import write_wav
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.pipeline import (
        Chain, FIRGateStage, FIRStage, GateStage, ResampleStage, StretchStage,
    )
    from audiosignalprocess_tpu_torch.tools import run_config_5
    from audiosignalprocess_tpu_torch.tools.common import make_signal
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    t_start = time.perf_counter()

    def fail(line, want):
        raise SystemExit(f"phase 28 failed: {line} (want {want})")

    def counted(fn, chain=None):
        """fn() with every count at 0 just before and read just after:
        (output, launches, torch.fft calls, each step's launches of
        ``chain``)."""
        steps = []
        if chain is not None:
            step = chain.step

            def recorded(states, xb):
                before = [k.launches for k in kernels]
                out = step(states, xb)
                steps.append({k.__name__: k.launches - b for k, b in zip(kernels, before)
                              if k.launches != b})
                return out

            chain.step = recorded
        reset_counts()
        try:
            with torch_fft_calls() as tf:
                y = fn()
                torch.cuda.synchronize()
        finally:
            if chain is not None:
                del chain.step
        return y, {k.__name__: k.launches for k in kernels if k.launches}, tf["n"], steps

    def drive(tag, what, fn, chain, pair, calls, ref64, flips=None, trim=0):
        """One counted run of fn() (``pair`` the launches a call or a step,
        ``calls`` of them) held against ``ref64`` from ``trim`` on (``flips``:
        the plain gate's flipped bins on this input); returns the output."""
        y, counts, n_fft, steps = counted(fn, chain)
        want = {k: v * calls for k, v in pair.items()}
        got = y[:, trim:]
        ref = ref64[..., : got.shape[-1]]
        ok_shape = ref.shape == got.shape
        snr = snr_db(ref, got) if ok_shape else -np.inf
        per = [snr_db(r, g) for r, g in zip(ref, got)] if ok_shape else [-np.inf]
        each = "" if chain is None else (
            f" per block {steps[0] if steps else None} on all {len(steps)} blocks"
            if steps and all(s == pair for s in steps) else f" per block {steps}")
        line = (f"[28 {tag}] {what}: {tuple(y.shape)} launches={counts}{each}, torch.fft "
                f"calls {n_fft}; snr_vs_f64_plain={snr:.2f} dB over {got.shape[0]} channels "
                f"(worst channel {int(np.argmin(per))}: {min(per):.2f} dB)"
                + ("" if flips is None else flips_text(snr, flips)))
        print(line)
        if counts != want or n_fft or snr < SNR_MIN_DB or not bool(torch.isfinite(y).all()) \
                or (chain is not None and (len(steps) != calls
                                           or any(s != pair for s in steps))):
            fail(line, f"{want}, {pair} a block, no torch.fft call, >= {SNR_MIN_DB} dB")
        return y

    pair2 = {"rfft_stockham": 2, "irfft_stockham": 2}  # the FIR's and the gate's
    gate = dict(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES)

    # ---- 28a: path A unfused, whole file and drained stream
    c, n = HEADLINE
    x64 = torch.as_tensor(x_main, device=dev)
    x32 = x64.float()
    unf = Chain([FIRGateStage(h=h, fused=False, **gate)])
    fus = Chain([FIRGateStage(h=h, **gate)])
    unf.build()
    fus.build()
    blocks = unf.drain_blocks(n, BLOCK)
    ref64 = unf.full_flush(x64)
    flips = decision_flips(FIRStage(h=h, nfft=NFFT).full(x64))
    drive("path A unfused", f"FIRGateStage(fused=False).full_flush {c}x{n}",
          lambda: unf.full_flush(x32), None, pair2, 1, ref64, flips)
    drive("path A unfused", f"FIRGateStage(fused=False) Chain.stream(drain=True) block {BLOCK}",
          lambda: unf.stream(x32, BLOCK, drain=True), unf, pair2, blocks, ref64, flips)
    del ref64
    ms = {name: time_ms(lambda: ch.full_flush(x32), reps=10) for name, ch in
          (("unfused", unf), ("fused", fus))}
    st = {name: stream_ms(lambda: ch.stream(x32, BLOCK, drain=True)) for name, ch in
          (("unfused", unf), ("fused", fus))}
    idle = {name: device_idle_share(lambda: ch.stream(x32, BLOCK, drain=True)) for name, ch in
            (("unfused", unf), ("fused", fus))}
    print(f"[28 path A times] {c}x{n} f32 tone burst on {smi}: whole file unfused "
          f"{ms['unfused']:.4f} ms, fused (fir_noise_gate_fused) {ms['fused']:.4f} ms; drained "
          f"stream of {blocks} blocks unfused {st['unfused']:.4f} ms, fused "
          f"(fir_gate_step_fused) {st['fused']:.4f} ms; device idle unfused "
          f"{idle_text(idle['unfused'])}, fused {idle_text(idle['fused'])}")
    del x64, x32

    t_a = time.perf_counter()

    # ---- 28b: config 5 --composite --no-fused through run_config_5
    c5, block5 = run_config_5.CHANNELS, run_config_5.BLOCK
    x5np = make_signal(c5, run_config_5.RATE_IN, CFG_SECONDS).astype(np.float32)
    nb = x5np.shape[-1] // block5
    x5np = x5np[:, : nb * block5]
    x5 = torch.as_tensor(x5np, device=dev)
    comp = run_config_5.build_chain(fused=False, composite=True)
    lat = comp.build()
    comp_f = run_config_5.build_chain(composite=True)
    comp_f.build()
    full64 = comp.full(x5.double())
    flips = decision_flips(FIRStage(h=design_fir(TAPS, 0.3), nfft=NFFT).full(
        ResampleStage(UP, DOWN).full(x5.double())))
    tag = "config 5 --composite --no-fused"
    stream5 = drive(tag, f"Chain.stream {c5}x{nb * block5} block {block5}",
                    lambda: comp.stream(x5, block5), comp, pair2, nb, full64, flips,
                    trim=lat).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "in.wav")
        write_wav(wav, x5np, run_config_5.RATE_IN, float_fmt=True)
        stats = {}

        def ring():
            return run_config_5.run_ring(comp, wav, block5, c5, device=dev, stats=stats,
                                         warmup=True)

        ring()
        out = drive(tag, f"run_ring K=1 {c5}x{nb * block5}", lambda: torch.as_tensor(ring()[0]),
                    comp, pair2, nb, full64.cpu(), flips, trim=lat).numpy()
        secs = ring()[2]
    exact = np.array_equal(stream5, out)
    snr_ring = np.inf if exact else snr_db(stream5, out)
    line = (f"[28 {tag}] ring against Chain.stream: "
            f"{'bit-equal' if exact else f'{snr_ring:.2f} dB'}; {secs:.4f} s ({x5.numel() / secs:.4e} "
            f"input samples/s, host clock), consumer waited {stats['wait_s'] / secs:.4f} of it")
    print(line)
    if snr_ring < LINEAR_MIN_DB:
        fail(line, f"bit-equal or >= {LINEAR_MIN_DB} dB")
    st = {name: stream_ms(lambda: ch.stream(x5, block5)) for name, ch in
          (("unfused", comp), ("fused", comp_f))}
    idle = {name: device_idle_share(lambda: ch.stream(x5, block5)) for name, ch in
            (("unfused", comp), ("fused", comp_f))}
    print(f"[28 config 5 times] {c5}x{nb * block5} stream of {nb} blocks on {smi}: unfused "
          f"{st['unfused']:.4f} ms ({x5.numel() / st['unfused'] * 1e3:.4e} input samples/s), "
          f"fused (res_fir_gate_step_fused) {st['fused']:.4f} ms; device idle unfused "
          f"{idle_text(idle['unfused'])}, fused {idle_text(idle['fused'])}")
    del x5, full64
    m5 = ["-m", "audiosignalprocess_tpu_torch.tools.run_config_5", "--composite",
          "--no-fused", "--check", "--json"]
    done = driver_runs(Path(__file__).resolve().parent, [("ring", [*m5, "--mode", "ring"])])
    for label, (rc, so, se) in done.items():
        recs = [json.loads(ln) for ln in so.splitlines() if ln.startswith('{"config"')]
        line = f"[28 driver] run_config_5 --composite --no-fused --mode {label}: rc={rc} {recs}"
        print(line)
        if rc != 0 or len(recs) != 1 or not recs[0]["parity"] or recs[0]["device"] != "cuda":
            raise SystemExit(f"phase 28 failed: {line}\n{so[-2000:]}\n{se[-3000:]}")

    t_b = time.perf_counter()

    # ---- 28c: the unfused gate and vocoder steps under each impl (``auto``
    # timed beside the fused step, and the device idle share at the first
    # width only)
    rng = np.random.default_rng(28)
    for cw, block, nblk in UNFUSED_WIDTHS:
        n = nblk * block + 777
        xs64 = torch.as_tensor(tone_burst(rng, cw, n), device=dev)
        xs = xs64.float()
        kinds = {"GateStage": lambda impl, fused=False: GateStage(fused=fused, impl=impl, **gate),
                 "StretchStage(4, 3)": lambda impl, fused=False: StretchStage(
                     4, 3, nfft=NFFT, hop=HOP, fused=fused, impl=impl)}
        flips = decision_flips(xs64)
        for kind, make in kinds.items():
            plain = Chain([make("auto")])  # float64: torch.fft
            plain.build()
            ref = plain.stream(xs64, block, drain=True)
            routes = {}
            for impl, (pipe, pair) in UNFUSED_IMPLS.items():
                ch = routes[impl] = Chain([make(impl.split()[0])])
                ch.build()
                calls = ch.drain_blocks(n, block)
                with sk_pipe(pipe):
                    drive(f"{kind} unfused", f"impl={impl} {cw}x{n} block {block}",
                          lambda: ch.stream(xs, block, drain=True), ch, pair, calls, ref,
                          flips if kind == "GateStage" else None)
            auto, fused = routes["auto"], Chain([make("auto", True)])
            fused.build()
            ms = {name: stream_ms(lambda: c.stream(xs, block, drain=True))
                  for name, c in (("auto", auto), ("fused", fused))}
            line = (f"[28 {kind} times] drained stream of {cw}x{n}, block {block}, {calls} "
                    f"blocks, on {smi}: auto {ms['auto']:.4f} ms, fused {ms['fused']:.4f} ms")
            if cw == UNFUSED_WIDTHS[0][0]:
                line += (f"; device idle auto "
                         f"{idle_text(device_idle_share(lambda: auto.stream(xs, block, drain=True)))}"
                         f", fused "
                         f"{idle_text(device_idle_share(lambda: fused.stream(xs, block, drain=True)))}")
            print(line)
        del xs64, xs
    t_c = time.perf_counter()
    print(f"[28 time] 28a {t_a - t_start:.1f} s, 28b {t_b - t_a:.1f} s, 28c {t_c - t_b:.1f} s "
          f"(host clock)")


def main() -> int:
    # ---- phase 1: environment
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from audiosignalprocess_tpu_torch import api
    from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
    from audiosignalprocess_tpu_torch.kernels import _build
    from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
        fir_gate_step_fused, fir_noise_gate_fused, fir_noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac, fir_mac_ref
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
        gate_shard_fused, gate_step_fused, noise_gate_fused,
    )
    from audiosignalprocess_tpu_torch.kernels.os_kernel import (
        overlap_save_fused, overlap_save_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
        res_fir_gate_step_fused, resample_fir_gate_fused,
    )
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac
    from audiosignalprocess_tpu_torch.kernels.stretch_kernel import stretch_step_fused
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.pipeline import (
        Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage, ResFIRGateStage,
    )
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    kernels = (fir_noise_gate_fused, fir_gate_step_fused, gate_step_fused,
               overlap_save_fused, fir_mac, resample_mac, resample_fir_gate_fused,
               res_fir_gate_step_fused, noise_gate_fused, fk.fft_stockham_lanes,
               fk.rfft_stockham, fk.irfft_stockham, stretch_step_fused, gate_shard_fused,
               *(getattr(fk, name) for name in FFT_VARIANTS), fk.fft_stockham_manual)

    def reset_counts():
        for k in kernels:
            k.launches = 0

    # phases 15, 16 and 24 read fft_stockham_lanes' grid kernel and phase 25
    # sets ASP_SK_PIPE itself, so a value inherited from the caller is cleared
    inherited_pipe = os.environ.pop("ASP_SK_PIPE", None)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1 env] device={kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}"
          + ("" if inherited_pipe is None else f" (inherited ASP_SK_PIPE={inherited_pipe!r} "
             "cleared)"))
    print(smi)

    # ---- phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    ptxas = " | ".join(ln.replace("ptxas info    :", "").strip()
                       for ln in log.splitlines() if "registers" in ln or "spill" in ln)
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {lib_path.name}; {ptxas}")

    # ---- phase 3: kernel vs its plain version, float64 on the same card,
    # at the headline's nfft/hop and at others (the batched body's every
    # pass plan and tile shape), flipped gate decisions counted
    from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save

    rng = np.random.default_rng(47)
    cases = [  # (channels, n, taps, release, nfft, hop)
        (2, 48128, TAPS, 0.0, NFFT, HOP),
        (4, 32768, TAPS, 0.6, NFFT, HOP),
        (2, 32768, 384, 0.0, NFFT, HOP),
        (*HEADLINE, TAPS, 0.0, NFFT, HOP),
        (2, 48128, TAPS, 0.0, 256, 64),
        (2, 48128, TAPS, 0.6, 512, 128),
        (2, 48128, 30, 0.0, 512, 256),
        (3, 48128, 1, 0.0, NFFT, 512),
        (5, 48128, TAPS, 0.0, NFFT, 128),
        (2, 60000, TAPS, 0.0, 2048, 512),
        (1, 60000, 384, 0.6, 2048, 256),
    ]
    max_err, min_snr = 0.0, np.inf
    for c, n, taps, release, nfft, hop in cases:
        h = design_fir(taps, 0.2 if taps == 384 else 0.3)
        x64 = torch.as_tensor(tone_burst(rng, c, n), device=dev)
        before = fir_noise_gate_fused.launches
        y = fir_noise_gate_fused(x64.float(), h, nfft=nfft, hop=hop, release=release)
        torch.cuda.synchronize()
        ref = fir_noise_gate_ref(x64, h, nfft=nfft, hop=hop, release=release)
        out_len = nfft + ((n - nfft) // hop) * hop
        snr = snr_db(ref, y)
        err = float((y.double() - ref).abs().max())
        ok = (tuple(y.shape) == (c, out_len) and bool(torch.isfinite(y).all())
              and snr >= SNR_MIN_DB and fir_noise_gate_fused.launches == before + 1)
        flips = decision_flips(overlap_save(x64, h, nfft, impl="torch"), nfft, hop)
        line = (f"[3 kernel] {c}x{n} nfft={nfft} hop={hop} taps={taps} release={release}: "
                f"shape {tuple(y.shape)} snr_vs_f64_plain={snr:.2f} dB max_abs_err={err:.3e}"
                + flips_text(snr, flips))
        if (c, n, nfft) == (2, 48128, NFFT):
            oracle = oracle_chain(x64.cpu().numpy(), h)
            line += f" snr_vs_f64_oracle={snr_db(oracle, y):.2f} dB"
        print(line)
        if not ok:
            raise SystemExit(f"phase 3 failed: {line}")
        max_err, min_snr = max(max_err, err), min(min_snr, snr)

    # ---- phase 4: the main path through the user entry points
    h = design_fir(TAPS, 0.3)
    chain = Chain.from_params([dict(h=h, nfft=NFFT, hop=HOP,
                                    noise_frames=NOISE_FRAMES)])
    chain.build()
    x_main = tone_burst(rng, *HEADLINE)
    x_dev = torch.as_tensor(x_main, dtype=torch.float32, device=dev)
    wav_x = tone_burst(rng, 8, 2 * FS).astype(np.float32) * 0.5
    with tempfile.TemporaryDirectory() as tmp:
        p_in, p_gpu, p_cpu = (str(Path(tmp) / f) for f in ("in.wav", "gpu.wav", "cpu.wav"))
        write_wav(p_in, wav_x, FS, float_fmt=True)
        reset_counts()
        y_main = chain.full_flush(x_dev)
        torch.cuda.synchronize()
        chain_launches = fir_noise_gate_fused.launches
        api.chain_file(p_in, p_gpu, device="cuda", float_fmt=True)
        launches = fir_noise_gate_fused.launches
        if any(k.launches for k in kernels[1:]):
            raise SystemExit("phase 4 failed: the whole-file path launched a step kernel")
        api.chain_file(p_in, p_cpu, device="cpu", float_fmt=True)
        y_gpu, _ = read_wav(p_gpu, dtype=np.float64)
        y_cpu, _ = read_wav(p_cpu, dtype=np.float64)
    ref_main = fir_noise_gate_ref(torch.as_tensor(x_main, device=dev), h)
    snr_main = snr_db(ref_main, y_main[:, : ref_main.shape[-1]])
    snr_file = snr_db(y_cpu, y_gpu)
    line = (f"[4 main path] launches={launches}: Chain.full_flush "
            f"{tuple(y_main.shape)} launches={chain_launches} "
            f"snr_vs_f64_plain={snr_main:.2f} dB; api.chain_file 8x{2 * FS} "
            f"launches={launches - chain_launches} snr_vs_cpu_plain={snr_file:.2f} dB")
    print(line)
    if not (tuple(y_main.shape) == HEADLINE and bool(torch.isfinite(y_main).all())
            and chain_launches >= 1 and launches > chain_launches
            and snr_main >= SNR_MIN_DB and snr_file >= SNR_MIN_DB
            and y_gpu.shape == wav_x.shape):
        raise SystemExit(f"phase 4 failed: {line}")

    # ---- phase 5: times at the headline shape on bench.py's white noise
    noise = np.random.default_rng(0).standard_normal(HEADLINE).astype(np.float32)
    xn = torch.as_tensor(noise, device=dev)
    ms = time_ms(lambda: fir_noise_gate_fused(xn, h))
    plain_ms = time_ms(lambda: fir_noise_gate_ref(xn, h))
    device_ms = queued_ms(lambda: fir_noise_gate_fused(xn, h), reps=10, cycles=10 ** 8)
    samples = HEADLINE[0] * HEADLINE[1]
    snr_noise = snr_db(fir_noise_gate_ref(xn.double(), h), fir_noise_gate_fused(xn, h))
    print(f"[5 times] {HEADLINE[0]}x{HEADLINE[1]} f32 white noise on {smi}: "
          f"kernel {ms:.4f} ms ({samples / ms * 1e3:.4e} samples/s; device time of "
          f"queued calls {device_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms ({samples / plain_ms * 1e3:.4e} samples/s); "
          f"white-noise snr_vs_f64_plain={snr_noise:.2f} dB (record only)")
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import fir_noise_gate_info

    print(f"[5 kernel] fir_noise_gate_fused on {smi}, from the CUDA runtime (registers, "
          f"local bytes a thread, CTAs an SM by the occupancy API): parallel launch "
          f"{fir_noise_gate_info(NFFT, HOP, TAPS, 0.0, dev)}, sequential (release > 0) "
          f"{fir_noise_gate_info(NFFT, HOP, TAPS, 0.6, dev)}; ptxas <R,RS>: "
          f"{chain_ptxas(log, 'fir_noise_gate_kernel')}")

    record = {"fir_noise_gate_fused": dict(
        source="chain_kernel.cu", replaces="chain_kernel.py:151", launches=launches,
        max_abs_err=max_err, min_snr_db=min_snr, ms=ms, plain_ms=plain_ms,
        device_ms=device_ms)}

    # ---- phase 6: the streaming paths' kernels vs their float64 plain
    # versions on the card, at the shapes the paths give them
    c = HEADLINE[0]
    h_env = design_fir(ENV_TAPS, 0.01)

    linear = [  # (kernel, plain, taps, per-call shape, history, extra args)
        (fir_mac, fir_mac_ref, h_env, (c, BLOCK), True, ()),
        (fir_mac, fir_mac_ref, h_env, HEADLINE, False, ()),
        (overlap_save_fused, overlap_save_ref, h, (c, BLOCK), True, (NFFT,)),
    ]
    for kernel, plain, taps, shape, with_hist, extra in linear:
        x64 = torch.as_tensor(rng.standard_normal(shape), device=dev)
        hist = (torch.as_tensor(rng.standard_normal((shape[0], len(taps) - 1)), device=dev)
                if with_hist else None)
        before = kernel.launches
        y = kernel(x64.float(), taps, *extra, history=None if hist is None else hist.float())
        torch.cuda.synchronize()
        check_kernel(record, 6, f"{kernel.__name__} {shape[0]}x{shape[1]} taps={len(taps)} "
                     f"history={with_hist}", y, plain(x64, taps, *extra, history=hist),
                     kernel, before, 1, LINEAR_MIN_DB)

    n_short = 16 * BLOCK
    x_short = torch.as_tensor(tone_burst(rng, c, n_short), device=dev)
    x_drain = x_short[:, : n_short - 1234]
    for release in (0.0, 0.6):
        for drain in (False, True):
            xs = x_drain if drain else x_short
            gate = dict(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, release=release)
            kern = Chain([GateStage(fused=True, **gate)])
            kern.build()
            calls = kern.drain_blocks(xs.shape[-1], BLOCK) if drain else xs.shape[-1] // BLOCK
            before = gate_step_fused.launches
            y = kern.stream(xs.float(), BLOCK, drain=drain)
            torch.cuda.synchronize()
            ref = Chain([GateStage(**gate)]).stream(xs, BLOCK, drain=drain)
            check_kernel(record, 6, f"gate_step_fused release={release} drain={drain}", y, ref,
                         gate_step_fused, before, calls, SNR_MIN_DB,
                         f" decision_flips_f32_vs_f64={decision_flips(xs)}")
            for env_h in (None, h_env):
                chain_s = Chain([FIRGateStage(h=h, env_h=env_h, **gate)])
                chain_s.build()
                before = fir_gate_step_fused.launches
                y = chain_s.stream(xs.float(), BLOCK, drain=drain)
                torch.cuda.synchronize()
                ref = chain_s.stream(xs, BLOCK, drain=drain)  # float64: the plain composition
                flips = decision_flips(FIRStage(h=h, nfft=NFFT).full(xs))
                check_kernel(record, 6, f"fir_gate_step_fused release={release} drain={drain} "
                             f"env={env_h is not None}", y, ref, fir_gate_step_fused,
                             before, calls, SNR_MIN_DB,
                             f" decision_flips_f32_vs_f64={flips}")

    # ---- phase 7: paths A and B at the full width, drained, each driven
    # with every count at 0 just before and read just after
    n = HEADLINE[1]
    path_a = Chain([FIRGateStage(h=h, nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES)])
    path_ae = Chain([FIRGateStage(h=h, nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES,
                                  env_h=h_env)])

    def path_b(fused):
        impl = "auto" if fused else "torch"
        return Chain([FIRStage(h=h, nfft=NFFT, fused=fused, impl=impl),
                      GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=fused,
                                impl=impl),
                      EnvelopeStage(h_env, fused=fused)])

    runs = {}
    for name, chain_p, on_path in (("A", path_a, (fir_gate_step_fused,)),
                                   ("A+env", path_ae, (fir_gate_step_fused,)),
                                   ("B", path_b(True), (overlap_save_fused, gate_step_fused,
                                                        fir_mac))):
        chain_p.build()
        blocks = chain_p.drain_blocks(n, BLOCK)
        reset_counts()
        y = chain_p.stream(x_dev, BLOCK, drain=True)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        runs[name] = (chain_p, y, blocks, counts)
        want = {k.__name__: (blocks if k in on_path else 0) for k in kernels}
        line = (f"[7 path {name}] Chain.stream(drain=True) {tuple(y.shape)} "
                f"blocks={blocks} launches={counts}")
        print(line)
        if counts != want or tuple(y.shape) != (c, chain_p.out_len(n)) \
                or not bool(torch.isfinite(y).all()):
            raise SystemExit(f"phase 7 failed: {line}")
    for name, ref in (("A", path_a.full_flush(x_dev)), ("A+env", path_ae.full_flush(x_dev)),
                      ("B", path_b(False).full_flush(x_dev))):
        snr = snr_db(ref, runs[name][1])
        line = f"[7 path {name}] stream vs full_flush on the card: snr={snr:.2f} dB"
        print(line)
        if snr < SNR_MIN_DB:
            raise SystemExit(f"phase 7 failed: {line}")
    record["fir_gate_step_fused"]["launches"] = runs["A"][3]["fir_gate_step_fused"]
    for k in (overlap_save_fused, gate_step_fused, fir_mac):
        record[k.__name__]["launches"] = runs["B"][3][k.__name__]

    # ---- phase 8: api.chain_file streaming and envelope, cuda vs cpu
    with tempfile.TemporaryDirectory() as tmp:
        p_in = str(Path(tmp) / "in.wav")
        write_wav(p_in, wav_x, FS, float_fmt=True)
        for kw in (dict(block=BLOCK), dict(envelope_hz=50.0),
                   dict(block=BLOCK, envelope_hz=50.0)):
            outs = {}
            reset_counts()
            for d in ("cuda", "cpu"):
                api.chain_file(p_in, str(Path(tmp) / f"{d}.wav"), device=d,
                               float_fmt=True, **kw)
                outs[d] = read_wav(str(Path(tmp) / f"{d}.wav"), dtype=np.float64)[0]
            counts = {k.__name__: k.launches for k in kernels if k.launches}
            snr = snr_db(outs["cpu"], outs["cuda"])
            line = (f"[8 api.chain_file] {kw} 8x{2 * FS}: launches={counts} "
                    f"snr_vs_cpu_plain={snr:.2f} dB")
            print(line)
            if snr < SNR_MIN_DB or outs["cuda"].shape != wav_x.shape or not counts:
                raise SystemExit(f"phase 8 failed: {line}")

    # ---- phase 9: times per stream of 64 x 480000 (bench.py's white
    # noise), each kernel's path against the same stream through the plain
    # versions (float32 on the card)
    def gate_only(fused):
        return Chain([GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=fused,
                                impl="torch")])

    def fir_gate(fused):
        return Chain([FIRStage(h=h, nfft=NFFT, fused=fused, impl="torch"),
                      GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=fused,
                                impl="torch")])

    timed = [  # (name, kernel chain, plain chain)
        ("path A", path_a, fir_gate(False)),
        ("path A+env", path_ae, path_b(False)),
        ("path B", path_b(True), path_b(False)),
        ("gate_step_fused", gate_only(True), gate_only(False)),
        ("overlap_save_fused", Chain([FIRStage(h=h, nfft=NFFT, fused=True)]),
         Chain([FIRStage(h=h, nfft=NFFT, impl="torch")])),
        ("fir_mac", Chain([EnvelopeStage(h_env, fused=True)]), Chain([EnvelopeStage(h_env)])),
    ]
    times = {}
    for name, kern, plain in timed:
        kern.build()
        plain.build()
        times[name] = (stream_ms(lambda: kern.stream(xn, BLOCK, drain=True)),
                       stream_ms(lambda: plain.stream(xn, BLOCK, drain=True)))
        print(f"[9 times] {name} stream of {HEADLINE[0]}x{HEADLINE[1]} f32, block {BLOCK}, "
              f"{kern.drain_blocks(n, BLOCK)} blocks, on {smi}: kernels "
              f"{times[name][0]:.4f} ms ({samples / times[name][0] * 1e3:.4e} samples/s), "
              f"plain {times[name][1]:.4f} ms")
    idle = device_idle_share(lambda: path_a.stream(xn, BLOCK, drain=True))
    idle_plain = device_idle_share(lambda: fir_gate(False).stream(xn, BLOCK, drain=True))
    print(f"[9 idle] path A stream under torch.profiler on {smi}: device idle "
          f"{idle_text(idle)} of its span; plain version {idle_text(idle_plain)}")
    for kname, tname in (("fir_gate_step_fused", "path A"), ("gate_step_fused", "gate_step_fused")):
        record[kname].update(ms=times[tname][0], plain_ms=times[tname][1])
    # the two MAC kernels on the work one conv1d does (earlier_bounds' library_ms):
    # one whole-file launch on the same input; their streams stay under stream_ms
    whole = {"fir_mac": (lambda: fir_mac(xn, h_env), lambda: fir_mac_ref(xn, h_env)),
             "overlap_save_fused": (lambda: overlap_save_fused(xn, h, NFFT),
                                    lambda: overlap_save_ref(xn, h, NFFT))}
    for kname, (kern_fn, plain_fn) in whole.items():
        ms, plain_ms = time_ms(kern_fn), time_ms(plain_fn, reps=5, warmup=1)
        print(f"[9 times] {kname} one whole-file launch on {HEADLINE[0]}x{HEADLINE[1]} f32 "
              f"white noise on {smi}: kernel {ms:.4f} ms ({samples / ms * 1e3:.4e} samples/s), "
              f"plain {plain_ms:.4f} ms; its stream {times[kname][0]:.4f} ms")
        record[kname].update(ms=ms, plain_ms=plain_ms, stream_ms=times[kname][0],
                             stream_plain_ms=times[kname][1])
    record["fir_gate_step_fused"].update(source="fir_gate_step_kernel.cu",
                                         replaces="chain_kernel.py:465")
    record["gate_step_fused"].update(source="gate_step_kernel.cu",
                                     replaces="gate_kernel.py:562")
    record["overlap_save_fused"].update(source="os_kernel.cu", replaces="os_kernel.py:91")
    record["fir_mac"].update(source="fir_kernel.cu", replaces="fir_kernel.py:65")

    marks = [("phases 1-9", time.perf_counter())]
    resampler_phases(dev, smi, rng, record, kernels, reset_counts, wav_x, log)
    marks.append(("phases 10-13", time.perf_counter()))
    gate_fft_phases(dev, smi, rng, record, kernels, reset_counts, x_dev, h, log)
    marks.append(("phases 14-16", time.perf_counter()))
    vocoder_phases(dev, smi, record, kernels, reset_counts)
    marks.append(("phases 17-19", time.perf_counter()))
    sharded_phases(dev, smi, record, kernels, reset_counts)
    marks.append(("phases 20-23", time.perf_counter()))
    fft_variant_phase(dev, smi, record, kernels, reset_counts, h)
    marks.append(("phase 24", time.perf_counter()))
    fft_manual_phase(dev, smi, record, kernels, reset_counts, h)
    marks.append(("phase 25", time.perf_counter()))
    res_c = Chain([ResFIRGateStage(UP, DOWN, h=h, nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES)])
    res_c.build()
    earlier_bounds(record, h, h_env, xn, path_a.drain_blocks(n, BLOCK),
                   res_c.drain_blocks(RES_HEADLINE[1], RES_BLOCK))
    big_nfft_phase(dev, smi, kernels, log)
    marks.append(("phase 26", time.perf_counter()))
    step_device_phase(dev, smi, record, kernels, h, h_env, log)
    marks.append(("phase 9b", time.perf_counter()))
    config_driver_phases(dev, smi, kernels, reset_counts)
    marks.append(("phase 27", time.perf_counter()))
    unfused_phases(dev, smi, kernels, reset_counts, x_main, h)
    marks.append(("phase 28", time.perf_counter()))

    prev = t_start
    for name, t in marks:
        print(f"[time] {name}: {t - prev:.1f} s (host clock)")
        prev = t
    print(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"audiosignalprocess_tpu_torch/csrc/{r['source']}",
        "replaces": f"audiosignalprocess_tpu/kernels/{r['replaces']}",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        "min_snr_db": r["min_snr_db"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "stream_ms": r.get("stream_ms"),
        "device_ms": r.get("device_ms"),
        "block_device_ms": r.get("block_device_ms"),
        "library_device_ms": r.get("library_device_ms"),
        "slice_ms": r.get("slice_ms"),
    } for name, r in record.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
