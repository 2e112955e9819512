"""Fused FIR + spectral-noise-gate chain: the hand-written Hopper
kernels and their plain PyTorch versions.

- ``fir_noise_gate_fused`` (``csrc/chain_kernel.cu``): the whole-file
  headline 48 kHz chain (overlap-save FIR -> STFT noise gate) in one
  kernel: raw audio is read from device memory once, filtered, framed,
  gated, resynthesized and written once.  Same conventions as
  ``oracle.noise_gate(oracle.fir_direct(x, h), ...)``; the output length
  is nfft + (F-1)*hop.  Its body (``csrc/chain_regs_device.cuh``, shared
  with ``resample_fir_gate_fused`` and the gate alone) runs batches of
  register Stockham transforms; ``gate_kernel.regs_geometry`` sizes its
  tiles and shared memory.
- ``fir_gate_step_fused`` (``csrc/fir_gate_step_kernel.cu``): one
  streaming block of the same chain, with an optional envelope tail
  (|y| -> FIR ``env_h`` -> * ``env_scale``) folded into the same launch.
  Its carry is the plain composition's: ``[FIR history (..., T-1), gate
  carry (kernels/gate_kernel), envelope history (..., Te-1)]``.  Its body
  (``csrc/fir_gate_step_regs.cuh``, shared with
  ``res_fir_gate_step_fused``) runs batches of register Stockham
  transforms; ``gate_kernel.step_regs_geometry`` sizes its shared memory.

Routing: a CPU tensor runs the plain version (``fir_noise_gate_ref``,
``fir_gate_step_ref``); a CUDA float32 tensor launches the kernel;
anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels._build import (  # noqa: F401
    SMEM_LIMIT, check_cuda_f32, kernel_fn, launch, rows_view,
)
from audiosignalprocess_tpu_torch.kernels.fir_kernel import reversed_taps
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (  # noqa: F401
    STEP_OFFSETS, FirEnvArgs, _inv_norm_table, check_gate_guards, data_ptr, file_tables,
    gate_step_args, gate_step_ref, noise_floor, regs_batch, regs_geometry, regs_info,
    regs_one_buffer, regs_points, regs_span_rows, regs_threads, step_cluster, step_regs_geometry,
    step_span, step_split,
)
from audiosignalprocess_tpu_torch.kernels.os_kernel import check_os_geometry, tap_spectrum
from audiosignalprocess_tpu_torch.ops.fir import fir_direct
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.stft import frame
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check

def _check_guards(h: np.ndarray, n: int, nfft: int, hop: int,
                  noise_frames: int) -> int:
    """Validate the geometry; returns the frame count F."""
    check(nfft > len(h) - 1, f"nfft={nfft} must exceed taps-1 ({len(h) - 1})")
    return check_gate_guards(n, nfft, hop, noise_frames)


@functools.lru_cache(maxsize=32)
def gate_tables(h_bytes: bytes, nfft: int, hop: int, window_kind: str,
                device: torch.device) -> tuple:
    """The whole-file FIR -> gate kernels' constant tables on ``device``:
    ``gate_kernel.file_tables`` (the window, the forward and inverse
    per-stage tables, the 1/WOLA norm) with the tap spectrum
    (``os_kernel.tap_spectrum``) after the window."""
    win, twf, twi, inv_tab = file_tables(nfft, hop, window_kind, device)
    return win, tap_spectrum(h_bytes, nfft, device), twf, twi, inv_tab


def filtered_floor(head: torch.Tensor, h: np.ndarray, nfft: int, hop: int,
                   noise_frames: int, win: torch.Tensor) -> torch.Tensor:
    """The gate's noise floor (channels, nfft/2+1) from the first frames of
    the filtered signal, given the head of the FIR's input: plain torch on
    the device, as the JAX package computes it in XLA outside Pallas."""
    pro = overlap_save(head, h, nfft, impl="torch")
    frames = frame(pro[:, : nfft - hop + noise_frames * hop], nfft, hop)
    return noise_floor(frames * win).contiguous()


@functools.cache
def _lib():
    fn = _build.load().asp_fir_noise_gate
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fir_noise_gate_ref(x: torch.Tensor, h, nfft: int = 1024, hop: int = 256,
                       threshold_db: float = 6.0, reduction_db: float = 60.0,
                       noise_frames: int = 8, release: float = 0.0,
                       window_kind: str = "hann") -> torch.Tensor:
    """Plain PyTorch version: ``noise_gate(overlap_save(x, h, nfft), ...)``
    with torch.fft (``impl="torch"``), on any device and dtype."""
    y = overlap_save(x, h, nfft, impl="torch")
    return noise_gate(y, nfft, hop, threshold_db, reduction_db, noise_frames,
                      release, window_kind, impl="torch")


@kernel_wrapper
def fir_noise_gate_fused(x: torch.Tensor, h, nfft: int = 1024,
                         hop: int = 256, threshold_db: float = 6.0,
                         reduction_db: float = 60.0, noise_frames: int = 8,
                         release: float = 0.0,
                         window_kind: str = "hann") -> torch.Tensor:
    """Overlap-save FIR (taps ``h``, FFT size ``nfft``) -> spectral noise
    gate, fused.  x (..., n) -> (..., nfft + (F-1)*hop).

    A CPU tensor runs ``fir_noise_gate_ref``.  A CUDA float32 tensor
    launches the kernel: one CTA per (channel, tile) when ``release`` is
    0, one CTA per channel walking its frames in order when it is not
    (the release is a scan over all frames); ``regs_geometry`` gives the
    tile.  Any other tensor raises.
    """
    h = np.asarray(h, dtype=np.float64)
    n = x.shape[-1]
    nframes = _check_guards(h, n, nfft, hop, noise_frames)
    if x.device.type == "cpu":
        return fir_noise_gate_ref(x, h, nfft, hop, threshold_db, reduction_db,
                                  noise_frames, release, window_kind)
    check(x.is_cuda, f"fir_noise_gate_fused runs on CPU or CUDA, not {x.device}")
    check(x.dtype == torch.float32,
          f"the CUDA kernel computes in float32, got {x.dtype} "
          f"(FIRGateStage routes float64 through FIRStage -> GateStage)")
    batch = x.shape[:-1]
    xf = x.reshape(-1, n).contiguous()
    channels = xf.shape[0]
    check(0 < channels <= 65535, f"{channels} channels: 1..65535 per launch")
    geo = regs_geometry(nfft, hop, len(h), release > 0.0)
    dev = xf.device
    out_len = nfft + (nframes - 1) * hop
    win, hf, twf, twi, inv_tab = gate_tables(h.tobytes(), nfft, hop, window_kind, dev)
    head = xf[:, : min(n, nfft - hop + noise_frames * hop + nfft)]
    floor = filtered_floor(head, h, nfft, hop, noise_frames, win)
    out = torch.empty((channels, out_len), dtype=torch.float32, device=dev)
    spans = regs_span_rows(nfft, hop, geo, channels, out_len, release > 0.0, dev)
    launch("fir_noise_gate", _lib(), xf.data_ptr(), out.data_ptr(), floor.data_ptr(),
           win.data_ptr(), hf.data_ptr(), twf.data_ptr(), twi.data_ptr(), inv_tab.data_ptr(),
           data_ptr(spans), channels, n, nfft, nfft.bit_length() - 1, hop, len(h), nframes,
           geo["mf"], int(release > 0.0), float(10.0 ** (threshold_db / 20.0)),
           float(10.0 ** (-reduction_db / 20.0)), float(release), geo["smem"], dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    fir_noise_gate_fused.launches += 1
    return out.reshape(batch + (out_len,))


fir_noise_gate_fused.launches = 0


def fir_noise_gate_info(nfft: int = 1024, hop: int = 256, taps: int = 64,
                        release: float = 0.0, device=None) -> dict:
    """``fir_noise_gate_fused``'s kernel at this geometry on a CUDA device:
    ``regs_info`` (registers, local bytes, CTAs an SM) with the frames per
    tile and shared memory of its launch."""
    geo = regs_geometry(nfft, hop, taps, release > 0.0)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_fir_noise_gate_info", nfft, release > 0.0, geo["smem"], dev),
                mf=geo["mf"], smem=geo["smem"])


# ---------------------------------------------------------------------------
# the streaming FIR -> gate (-> envelope) step
# ---------------------------------------------------------------------------

def history_tail(hist: torch.Tensor, x: torch.Tensor, taps: int) -> torch.Tensor:
    """The last taps-1 samples of [hist | x]: a FIR's carry after a block."""
    if taps == 1:
        return hist
    return torch.cat([hist, x], dim=-1)[..., -(taps - 1):]


def fir_gate_step_ref(x: torch.Tensor, state: list, h, *, nfft: int, hop: int,
                      threshold_db: float, reduction_db: float,
                      noise_frames: int, release: float, window_kind: str,
                      input_latency: int, latency: int, env_h=None,
                      env_scale: float = math.pi / 2.0,
                      eof_in: int | None = None):
    """Plain PyTorch streaming step, any device and dtype: overlap-save
    FIR with history -> ``gate_step_ref`` -> (envelope: |y| ->
    ``fir_direct`` with history -> * env_scale), the JAX package's
    ``FIRStage -> GateStage [-> EnvelopeStage]`` steps."""
    h = np.asarray(h, dtype=np.float64)
    y = overlap_save(x, h, nfft, history=state[0], impl="torch")
    new = [history_tail(state[0], x, len(h))]
    sg, y = gate_step_ref(y, state[1], nfft=nfft, hop=hop,
                          threshold_db=threshold_db, reduction_db=reduction_db,
                          noise_frames=noise_frames, release=release,
                          window_kind=window_kind, input_latency=input_latency,
                          latency=latency, eof_in=eof_in)
    new.append(sg)
    if env_h is not None:
        a = y.abs()
        new.append(history_tail(state[2], a, len(env_h)))
        y = fir_direct(a, env_h, history=state[2])
        if env_scale != 1.0:
            y = y * env_scale
    return new, y


def fir_gate_step_args(x2d: torch.Tensor, x_ld: int, state: list, h: np.ndarray, *,
                       env_h, env_scale: float, res: tuple | None = None, **kw):
    """Check a FIR -> gate (-> envelope) step's geometry, allocate its
    output and new carry and fill the kernel's argument structs
    (``asp::fir_gate_step_regs``) for the rows ``x2d`` (for the resampling
    kernel, whose input is its own, rows of the resampled block's shape;
    ``res`` = (up, down, nk) sizes its tail).  Returns (args, fargs,
    new_state, out, smem, keep): ``keep`` holds the tensors the structs
    point to until the launch is queued."""
    t = len(h)
    nfft = kw["nfft"]
    dev = x2d.device
    channels, b = x2d.shape
    hist = state[0].contiguous()
    out = torch.empty((channels, b), dtype=torch.float32, device=dev)
    env = env_h is not None
    te = 0
    ehist = ehist_out = taps_rev = rect = None
    if env:
        he = np.ascontiguousarray(env_h, dtype=np.float64)
        te = len(he)
        check(te >= 1, "the envelope FIR needs at least one tap")
        ehist = state[2].contiguous()
        ehist_out = torch.empty_like(ehist)
        taps_rev = reversed_taps(he.tobytes(), dev)
    geo = step_regs_geometry(nfft, kw["hop"], t, te, b, kw["noise_frames"], res,
                             step_cluster(nfft))
    args, gate_state, keep = gate_step_args(x2d, x_ld, state[1], out,
                                            scratch=not geo["pop_smem"], **kw)
    hist_out = torch.empty_like(hist)
    if env and not geo["rect_smem"]:
        rect = torch.empty((channels, te - 1 + b), dtype=torch.float32, device=dev)
    for name, carry in (("FIR history", hist), ("envelope history", ehist)):
        check(carry is None or (carry.dtype == torch.float32 and carry.device == dev),
              f"the {name} must be float32 on the input's device")
    _, twf, twi, _ = file_tables(nfft, kw["hop"], kw["window_kind"], dev)
    fargs = FirEnvArgs(*map(data_ptr, (hist, hist_out, tap_spectrum(h.tobytes(), nfft, dev),
                                        twf, twi, ehist, ehist_out, taps_rev, rect)),
                       t, te, float(env_scale), geo["fs"], geo["pop_smem"],
                       *(geo[k] for k in STEP_OFFSETS))
    new = [hist_out, gate_state] + ([ehist_out] if env else [])
    return args, fargs, new, out, geo["smem"], (keep, hist, ehist, rect)


@kernel_wrapper
def fir_gate_step_fused(x: torch.Tensor, state: list, h, *, nfft: int, hop: int,
                        threshold_db: float, reduction_db: float,
                        noise_frames: int, release: float, window_kind: str,
                        input_latency: int, latency: int, env_h=None,
                        env_scale: float = math.pi / 2.0,
                        eof_in: int | None = None):
    """Streaming FIR -> gate (-> envelope) step, fused:
    (state, x) -> (new_state, y), x (..., b) with b a multiple of hop.

    A CPU tensor runs ``fir_gate_step_ref``.  A CUDA float32 tensor
    launches the kernel: one CTA per channel filters the block, gates it
    and, with ``env_h``, runs the envelope tail, on batches of register
    Stockham transforms (``step_regs_geometry`` sizes its shared memory).
    Any other tensor raises.
    """
    h = np.ascontiguousarray(h, dtype=np.float64)
    check_os_geometry(nfft, len(h))
    kw = dict(nfft=nfft, hop=hop, threshold_db=threshold_db,
              reduction_db=reduction_db, noise_frames=noise_frames,
              release=release, window_kind=window_kind,
              input_latency=input_latency, latency=latency, eof_in=eof_in)
    if x.device.type == "cpu":
        return fir_gate_step_ref(x, state, h, env_h=env_h, env_scale=env_scale, **kw)
    check_cuda_f32(x, "fir_gate_step_fused",
                   "FIRGateStage routes float64 to the plain composition")
    dev = x.device
    x2d, x_ld = rows_view(x)
    args, fargs, new, out, smem, _keep = fir_gate_step_args(
        x2d, x_ld, state, h, env_h=env_h, env_scale=env_scale, **kw)
    launch("fir_gate_step", kernel_fn("asp_fir_gate_step", 2), ctypes.byref(args),
           ctypes.byref(fargs), smem, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    fir_gate_step_fused.launches += 1
    return new, out.reshape(x.shape)


fir_gate_step_fused.launches = 0


def fir_gate_step_info(nfft: int = 1024, hop: int = 256, taps: int = 64, env_taps: int = 0,
                       block: int = 4096, noise_frames: int = 8, release: float = 0.0,
                       device=None) -> dict:
    """``fir_gate_step_fused``'s kernel at this geometry on a CUDA device:
    ``regs_info`` (registers, local bytes, CTAs an SM) with the frames a
    segment and shared memory of its launch."""
    cluster = step_cluster(nfft)
    geo = step_regs_geometry(nfft, hop, taps, env_taps, block, noise_frames, None, cluster)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_fir_gate_step_info", nfft, release > 0.0, geo["smem"], dev),
                cluster=cluster, fs=geo["fs"], smem=geo["smem"])

