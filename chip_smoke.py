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
  rates and ``api.resample_file``.

It times each kernel against its plain version and each path per stream.
Every phase prints its lines and raises on failure.  The second-to-last
line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
        mag = stft(g_in.to(dt), nfft, hop).abs()
        floor = mag[..., :noise_frames, :].mean(dim=-2, keepdim=True)
        dec.append(mag > floor * 10.0 ** (threshold_db / 20.0))
        mag64 = mag
    loud = mag64 > 1e-3 * mag64.amax(dim=(-2, -1), keepdim=True)
    return int(((dec[0] != dec[1]) & loud).sum())


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


def resampler_phases(dev, smi, rng, record, kernels, reset_counts, wav_x48):
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

    for ch, n, up, down, taps, release in ((2, 47040, UP, DOWN, TAPS, 0.0),
                                           (2, 16384, 2, 1, 96, 0.7),
                                           (1, 47040, UP, DOWN, 384, 0.0),
                                           (*RES_HEADLINE, UP, DOWN, TAPS, 0.0)):
        hc = design_fir(taps, {TAPS: 0.3, 96: 0.25, 384: 0.2}[taps])
        x64 = torch.as_tensor(tone_burst(rng, ch, n), device=dev)
        before = (resample_fir_gate_fused.launches, resample_mac.launches)
        y = resample_fir_gate_fused(x64.float(), up, down, hc, release=release)
        torch.cuda.synchronize()
        if resample_mac.launches != before[1]:
            raise SystemExit("phase 10 failed: the whole-file kernel's floor launched resample_mac")
        extra = ""
        if (ch, n) == (2, 47040) and taps == TAPS:
            u = upfirdn_oracle(x64.cpu().numpy(), resample_filter(up, down), up, down)
            extra = f" snr_vs_f64_oracle={snr_db(oracle_chain(u, hc), y):.2f} dB"
        check_kernel(record, 10, f"resample_fir_gate_fused {up}/{down} {ch}x{n} "
                     f"taps={taps} release={release}", y,
                     resample_fir_gate_ref(x64, up, down, hc, release=release),
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
    record["resample_mac"]["launches"] = runs["D"][1]["resample_mac"]

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
    print(f"[13 times] whole file {RES_HEADLINE[0]}x{RES_HEADLINE[1]} -> {RES_OUT} f32 white "
          f"noise on {smi}: resample_fir_gate_fused {ms:.4f} ms "
          f"({samples / ms * 1e3:.4e} out samples/s), plain {plain_ms:.4f} ms, "
          f"res_two (resample_mac + fir_noise_gate_fused) {two_ms:.4f} ms")
    record["resample_fir_gate_fused"].update(ms=ms, plain_ms=plain_ms)
    mac_ms = time_ms(lambda: resample_mac(xn, UP, DOWN, zero_phase=False))
    mac_plain_ms = time_ms(lambda: resample_mac_ref(xn, UP, DOWN, zero_phase=False))
    print(f"[13 times] resample_mac whole file {RES_HEADLINE[0]}x{RES_HEADLINE[1]} -> "
          f"{RES_OUT} f32 (res_two's first launch) on {smi}: kernel {mac_ms:.4f} ms "
          f"({samples / mac_ms * 1e3:.4e} out samples/s), plain {mac_plain_ms:.4f} ms")
    record["resample_mac"].update(ms=mac_ms, plain_ms=mac_plain_ms)

    def plain_c(env_h=None):
        return Chain([ResampleStage(UP, DOWN), FIRStage(h=h, nfft=NFFT), GateStage(**gate)]
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


def main() -> int:
    # ---- phase 1: environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from audiosignalprocess_tpu_torch import api
    from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
    from audiosignalprocess_tpu_torch.kernels import _build
    from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
        fir_gate_step_fused, fir_noise_gate_fused, fir_noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac, fir_mac_ref
    from audiosignalprocess_tpu_torch.kernels.gate_kernel import gate_step_fused
    from audiosignalprocess_tpu_torch.kernels.os_kernel import (
        overlap_save_fused, overlap_save_ref,
    )
    from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
        res_fir_gate_step_fused, resample_fir_gate_fused,
    )
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.pipeline import (
        Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage,
    )
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

    kernels = (fir_noise_gate_fused, fir_gate_step_fused, gate_step_fused,
               overlap_save_fused, fir_mac, resample_mac, resample_fir_gate_fused,
               res_fir_gate_step_fused)

    def reset_counts():
        for k in kernels:
            k.launches = 0

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1 env] device={kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)

    # ---- phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    ptxas = " | ".join(ln.replace("ptxas info    :", "").strip()
                       for ln in log.splitlines() if "registers" in ln or "spill" in ln)
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {lib_path.name}; {ptxas}")

    # ---- phase 3: kernel vs its plain version, float64 on the same card
    rng = np.random.default_rng(47)
    cases = [  # (channels, n, taps, release)
        (2, 48128, TAPS, 0.0),
        (4, 32768, TAPS, 0.6),
        (2, 32768, 384, 0.0),
        (*HEADLINE, TAPS, 0.0),
    ]
    max_err, min_snr = 0.0, np.inf
    for c, n, taps, release in cases:
        h = design_fir(taps, 0.2 if taps == 384 else 0.3)
        x64 = torch.as_tensor(tone_burst(rng, c, n), device=dev)
        before = fir_noise_gate_fused.launches
        y = fir_noise_gate_fused(x64.float(), h, release=release)
        torch.cuda.synchronize()
        ref = fir_noise_gate_ref(x64, h, release=release)
        out_len = NFFT + ((n - NFFT) // HOP) * HOP
        snr = snr_db(ref, y)
        err = float((y.double() - ref).abs().max())
        ok = (tuple(y.shape) == (c, out_len) and bool(torch.isfinite(y).all())
              and snr >= SNR_MIN_DB and fir_noise_gate_fused.launches == before + 1)
        line = (f"[3 kernel] {c}x{n} taps={taps} release={release}: shape "
                f"{tuple(y.shape)} snr_vs_f64_plain={snr:.2f} dB max_abs_err={err:.3e}")
        if (c, n) == (2, 48128):
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
    samples = HEADLINE[0] * HEADLINE[1]
    snr_noise = snr_db(fir_noise_gate_ref(xn.double(), h), fir_noise_gate_fused(xn, h))
    print(f"[5 times] {HEADLINE[0]}x{HEADLINE[1]} f32 white noise on {smi}: "
          f"kernel {ms:.4f} ms ({samples / ms * 1e3:.4e} samples/s), plain "
          f"{plain_ms:.4f} ms ({samples / plain_ms * 1e3:.4e} samples/s); "
          f"white-noise snr_vs_f64_plain={snr_noise:.2f} dB (record only)")

    record = {"fir_noise_gate_fused": dict(
        source="chain_kernel.cu", replaces="chain_kernel.py:151", launches=launches,
        max_abs_err=max_err, min_snr_db=min_snr, ms=ms, plain_ms=plain_ms)}

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
        return Chain([FIRStage(h=h, nfft=NFFT, fused=fused),
                      GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=fused),
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
        return Chain([GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=fused)])

    def fir_gate(fused):
        return Chain([FIRStage(h=h, nfft=NFFT, fused=fused),
                      GateStage(nfft=NFFT, hop=HOP, noise_frames=NOISE_FRAMES, fused=fused)])

    timed = [  # (name, kernel chain, plain chain)
        ("path A", path_a, fir_gate(False)),
        ("path A+env", path_ae, path_b(False)),
        ("path B", path_b(True), path_b(False)),
        ("gate_step_fused", gate_only(True), gate_only(False)),
        ("overlap_save_fused", Chain([FIRStage(h=h, nfft=NFFT, fused=True)]),
         Chain([FIRStage(h=h, nfft=NFFT)])),
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
    for kname, tname in (("fir_gate_step_fused", "path A"), ("gate_step_fused", "gate_step_fused"),
                         ("overlap_save_fused", "overlap_save_fused"), ("fir_mac", "fir_mac")):
        record[kname].update(ms=times[tname][0], plain_ms=times[tname][1])
    record["fir_gate_step_fused"].update(source="fir_gate_step_kernel.cu",
                                         replaces="chain_kernel.py:465")
    record["gate_step_fused"].update(source="gate_step_kernel.cu",
                                     replaces="gate_kernel.py:562")
    record["overlap_save_fused"].update(source="os_kernel.cu", replaces="os_kernel.py:91")
    record["fir_mac"].update(source="fir_kernel.cu", replaces="fir_kernel.py:65")

    resampler_phases(dev, smi, rng, record, kernels, reset_counts, wav_x)

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
    } for name, r in record.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
