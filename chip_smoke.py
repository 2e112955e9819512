"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audiosignalprocess_tpu_torch/csrc``
with nvcc, checks each kernel against its plain PyTorch version on the
card, drives the main path (the 48 kHz FIR -> noise-gate chain at
64 channels x 10 s) through ``pipeline.Chain`` and ``api.chain_file``,
counts the kernel launches of that run, and times the kernel against the
plain version.  Every phase prints one line and raises on failure.  The
second-to-last line is the kernels' JSON record; the last line is
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


def time_ms(fn, reps=20):
    """Mean device time of fn() over reps calls, after a warm-up."""
    for _ in range(3):
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
        fir_noise_gate_fused, fir_noise_gate_ref,
    )
    from audiosignalprocess_tpu_torch.ops.fir import design_fir
    from audiosignalprocess_tpu_torch.pipeline import Chain
    from audiosignalprocess_tpu_torch.utils.metrics import snr_db

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
        fir_noise_gate_fused.launches = 0
        y_main = chain.full_flush(x_dev)
        torch.cuda.synchronize()
        chain_launches = fir_noise_gate_fused.launches
        api.chain_file(p_in, p_gpu, device="cuda", float_fmt=True)
        launches = fir_noise_gate_fused.launches
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

    print(json.dumps({"kernels": [{
        "name": "fir_noise_gate_fused",
        "route": "cuda",
        "source": "audiosignalprocess_tpu_torch/csrc/chain_kernel.cu",
        "replaces": "audiosignalprocess_tpu/kernels/chain_kernel.py:151",
        "launches": launches,
        "max_abs_err": max_err,
        "min_snr_db": min_snr,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
