"""Fused resample -> FIR -> spectral-noise-gate chain (the config-5 front
half, 44.1 -> 48 kHz): the hand-written Hopper kernels and their plain
PyTorch versions.

- ``resample_fir_gate_fused`` (``csrc/res_chain_kernel.cu``): the whole
  file in one kernel.  Same conventions as
  ``oracle.noise_gate(oracle.fir_direct(oracle.resample_poly(x, up, down,
  zero_phase=False), h), ...)``; the output length is nfft + (F-1)*hop
  with F the frames of the resampled length ceil(n*up/down).  Its body is
  ``fir_noise_gate_fused``'s (``csrc/chain_regs_device.cuh``).
- ``res_fir_gate_step_fused`` (``csrc/res_fir_gate_step_kernel.cu``): one
  streaming block of the same chain, raw block in, b_in*up/down samples
  out, with an optional envelope tail folded into the same launch.  Its
  carry is the plain composition's: ``[res_hist (..., hn), [FIR history
  (..., T-1), gate carry (kernels/gate_kernel), envelope history
  (..., Te-1)]]``, the JAX package's ``ResampleStage -> FIRGateStage``
  plain-path carry.

Routing: a CPU tensor runs the plain version (``resample_fir_gate_ref``,
``res_fir_gate_step_ref``); a CUDA float32 tensor launches the kernel;
anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from math import gcd

import numpy as np
import torch

from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels._build import (
    check_cuda_f32, kernel_fn, launch, rows_view,
)
from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
    _check_guards, filtered_floor, fir_gate_step_args, fir_gate_step_ref,
    fir_noise_gate_ref, gate_tables,
)
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    data_ptr, regs_geometry, regs_info, regs_span_rows, step_cluster, step_regs_geometry,
)
from audiosignalprocess_tpu_torch.kernels.os_kernel import check_os_geometry
from audiosignalprocess_tpu_torch.kernels.resample_kernel import bank_table, res_window
from audiosignalprocess_tpu_torch.ops.resample import (
    reduce_ratio, resample_poly, stream_geometry, taps_per_phase,
)
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check

def _ratio(up: int, down: int, h_res) -> tuple[int, int, np.ndarray]:
    up, down, h_res = reduce_ratio(up, down, h_res)
    check(h_res is not None,
          "up/down reduces to 1/1: there is no resampler (use the FIR -> gate chain)")
    return up, down, h_res


def resample_fir_gate_ref(x: torch.Tensor, up: int, down: int, h_fir, h_res=None,
                          nfft: int = 1024, hop: int = 256,
                          threshold_db: float = 6.0, reduction_db: float = 60.0,
                          noise_frames: int = 8, release: float = 0.0,
                          window_kind: str = "hann") -> torch.Tensor:
    """Plain PyTorch version: ``fir_noise_gate_ref`` of the causal
    ``resample_poly``, on any device and dtype."""
    y = resample_poly(x, up, down, h=h_res, zero_phase=False)
    return fir_noise_gate_ref(y, h_fir, nfft, hop, threshold_db, reduction_db,
                              noise_frames, release, window_kind)


@functools.cache
def _lib():
    fn = _build.load().asp_res_fir_noise_gate
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@kernel_wrapper
def resample_fir_gate_fused(x: torch.Tensor, up: int, down: int, h_fir, h_res=None,
                            nfft: int = 1024, hop: int = 256,
                            threshold_db: float = 6.0, reduction_db: float = 60.0,
                            noise_frames: int = 8, release: float = 0.0,
                            window_kind: str = "hann") -> torch.Tensor:
    """Causal resample (up/down, prototype ``h_res``) -> overlap-save FIR
    (taps ``h_fir``) -> spectral noise gate, fused.
    x (..., n) -> (..., nfft + (F-1)*hop), F from ceil(n*up/down).

    A CPU tensor runs ``resample_fir_gate_ref``.  A CUDA float32 tensor
    launches the kernel: one CTA per (channel, tile) when ``release`` is
    0, one CTA per channel walking its tiles when it is not; each CTA
    resamples the span its tile filters (``res_geometry``).  Any other
    tensor raises.
    """
    up, down, h_res = _ratio(up, down, h_res)
    h = np.asarray(h_fir, dtype=np.float64)
    n = x.shape[-1]
    n_res = -(-n * up // down)
    nframes = _check_guards(h, n_res, nfft, hop, noise_frames)
    if x.device.type == "cpu":
        return resample_fir_gate_ref(x, up, down, h, h_res, nfft, hop, threshold_db,
                                     reduction_db, noise_frames, release, window_kind)
    check_cuda_f32(x, "resample_fir_gate_fused",
                   "ResFIRGateStage routes float64 through ResampleStage -> FIRGateStage")
    batch = x.shape[:-1]
    xf = x.reshape(-1, n).contiguous()
    channels = xf.shape[0]
    check(0 < channels <= 65535, f"{channels} channels: 1..65535 per launch")
    nk = taps_per_phase(len(h_res), up)
    geo = res_geometry(up, down, nk, nfft, hop, len(h), release > 0.0)
    dev = xf.device
    out_len = nfft + (nframes - 1) * hop
    win, hf, twf, twi, inv_tab = gate_tables(h.tobytes(), nfft, hop, window_kind, dev)
    # the floor's head: the raw samples the first d + noise_frames*hop
    # resampled samples read (the plain resampler, so no kernel launch)
    need = nfft - hop + noise_frames * hop
    head = resample_poly(xf[:, : min(n, -(-need * down // up) + 1)], up, down,
                         h=h_res, zero_phase=False)
    floor = filtered_floor(head, h, nfft, hop, noise_frames, win)
    out = torch.empty((channels, out_len), dtype=torch.float32, device=dev)
    spans = regs_span_rows(nfft, hop, geo, channels, out_len, release > 0.0, dev)
    launch("res_fir_noise_gate", _lib(), xf.data_ptr(), out.data_ptr(), floor.data_ptr(),
           win.data_ptr(), hf.data_ptr(), twf.data_ptr(), twi.data_ptr(), inv_tab.data_ptr(),
           bank_table(h_res.tobytes(), up, dev).data_ptr(), data_ptr(spans), channels, n,
           n_res, up, down, nk, nfft, nfft.bit_length() - 1, hop, len(h), nframes, geo["mf"],
           int(release > 0.0), float(10.0 ** (threshold_db / 20.0)),
           float(10.0 ** (-reduction_db / 20.0)), float(release), geo["smem"], dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    resample_fir_gate_fused.launches += 1
    return out.reshape(batch + (out_len,))


resample_fir_gate_fused.launches = 0


def res_geometry(up: int, down: int, nk: int, nfft: int, hop: int, taps: int,
                 sequential: bool = False) -> dict:
    """``regs_geometry`` of the resampling kernel: its fill stages the
    (up, nk) phase bank and the raw window of a span in the tail of its
    shared memory (``up`` and ``down`` reduced)."""
    return regs_geometry(nfft, hop, taps, sequential,
                         tail=lambda span: up * nk + res_window(span, up, down, nk))


def resample_fir_gate_info(up: int, down: int, h_fir, h_res=None, nfft: int = 1024,
                           hop: int = 256, release: float = 0.0, device=None) -> dict:
    """``resample_fir_gate_fused``'s kernel at this geometry on a CUDA
    device: ``regs_info`` (registers, local bytes, CTAs an SM) with the
    frames per tile and shared memory of its launch."""
    up, down, h_res = _ratio(up, down, h_res)
    geo = res_geometry(up, down, taps_per_phase(len(h_res), up), nfft, hop, len(h_fir),
                       release > 0.0)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_res_fir_noise_gate_info", nfft, release > 0.0, geo["smem"],
                          dev),
                mf=geo["mf"], smem=geo["smem"])


# ---------------------------------------------------------------------------
# the streaming resample -> FIR -> gate (-> envelope) step
# ---------------------------------------------------------------------------

def res_step_geometry(up: int, down: int, nfft: int, hop: int) -> tuple[int, int]:
    """(b_in, b_out): the block quantum of the streaming chain, the least
    raw block whose b_in*up/down resampled samples are whole hops
    (down*hop/gcd(up, hop) raw samples); any multiple works.  It divides
    the JAX package's quantum of the same name, so every block the JAX
    step takes, this one takes."""
    g = gcd(up, down)
    up, down = up // g, down // g
    check(nfft % hop == 0, f"hop={hop} must divide nfft={nfft}")
    b_in = down * (hop // gcd(up, hop))
    return b_in, b_in * up // down


class ResStepArgs(ctypes.Structure):
    """The resampler front of the step kernel's arguments: ``struct
    ResStepArgs`` of ``csrc/res_fir_gate_step_kernel.cu``."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "x", "res_hist", "res_hist_out", "bank")]
        + [(name, ctypes.c_int) for name in ("x_ld", "b_in", "hn", "up", "down", "nk")])


def res_fir_gate_step_ref(x: torch.Tensor, state: list, up: int, down: int, h_fir,
                          h_res=None, *, env_h=None, env_scale: float = math.pi / 2.0,
                          **kw):
    """Plain PyTorch streaming step, any device and dtype: the causal
    ``resample_poly`` with the carried history -> ``fir_gate_step_ref``,
    the JAX package's ``ResampleStage.step -> FIRGateStage.step``.  ``kw``:
    the gate's step arguments (``GateStage._step_kw``), positions in the
    resampled domain."""
    up, down, h_res = _ratio(up, down, h_res)
    res_hist = state[0]
    y = resample_poly(x, up, down, h=h_res, zero_phase=False, history=res_hist)
    hn = res_hist.shape[-1]
    new_hist = torch.cat([res_hist, x], dim=-1)[..., -hn:] if hn else res_hist
    fg, y = fir_gate_step_ref(y, state[1], h_fir, env_h=env_h, env_scale=env_scale, **kw)
    return [new_hist, fg], y


@kernel_wrapper
def res_fir_gate_step_fused(x: torch.Tensor, state: list, up: int, down: int, h_fir,
                            h_res=None, *, nfft: int, hop: int, threshold_db: float,
                            reduction_db: float, noise_frames: int, release: float,
                            window_kind: str, input_latency: int, latency: int,
                            env_h=None, env_scale: float = math.pi / 2.0,
                            eof_in: int | None = None):
    """Streaming resample -> FIR -> gate (-> envelope) step, fused:
    (state, x) -> (new_state, y), x (..., b_in) raw, y (..., b_in*up/down);
    b_in and the carried history are multiples of ``down`` and b_in*up/down
    of ``hop`` (``res_step_geometry``).  ``input_latency``, ``latency`` and
    ``eof_in`` are in resampled samples, the gate's domain.

    A CPU tensor runs ``res_fir_gate_step_ref``.  A CUDA float32 tensor
    launches the kernel: one CTA per channel resamples the block straight
    into the FIR's span in shared memory, filters it, gates it and, with
    ``env_h``, runs the envelope tail, on ``fir_gate_step_fused``'s body
    (``gate_kernel.step_regs_geometry`` sizes it).  Any other tensor
    raises.
    """
    up, down, h_res = _ratio(up, down, h_res)
    h = np.ascontiguousarray(h_fir, dtype=np.float64)
    check_os_geometry(nfft, len(h))
    kw = dict(nfft=nfft, hop=hop, threshold_db=threshold_db,
              reduction_db=reduction_db, noise_frames=noise_frames,
              release=release, window_kind=window_kind,
              input_latency=input_latency, latency=latency, eof_in=eof_in)
    if x.device.type == "cpu":
        return res_fir_gate_step_ref(x, state, up, down, h, h_res, env_h=env_h,
                                     env_scale=env_scale, **kw)
    check_cuda_f32(x, "res_fir_gate_step_fused",
                   "ResFIRGateStage routes float64 to the plain composition")
    dev = x.device
    x2d, x_ld = rows_view(x)
    channels, b_in = x2d.shape
    res_hist = state[0].reshape(channels, state[0].shape[-1]).contiguous()
    check(res_hist.dtype == torch.float32 and res_hist.device == dev,
          "the resampler history must be float32 on the input's device")
    hn, b_out = stream_geometry(b_in, up, down, len(h_res), res_hist, False)
    nk = taps_per_phase(len(h_res), up)
    # the resampled block never leaves the CTA: its shape stands in for the
    # FIR -> gate body's input rows (GateStepArgs.x, unread by this kernel)
    shape = torch.empty((1, 1), dtype=torch.float32, device=dev).expand(channels, b_out)
    args, fargs, fg, out, smem, _keep = fir_gate_step_args(
        shape, b_out, state[1], h, env_h=env_h, env_scale=env_scale, res=(up, down, nk), **kw)
    hist_out = torch.empty_like(res_hist)
    rargs = ResStepArgs(x2d.data_ptr(), res_hist.data_ptr(), hist_out.data_ptr(),
                        bank_table(h_res.tobytes(), up, dev).data_ptr(),
                        x_ld, b_in, hn, up, down, nk)
    launch("res_fir_gate_step", kernel_fn("asp_res_fir_gate_step", 3), ctypes.byref(args),
           ctypes.byref(fargs), ctypes.byref(rargs), smem, dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    res_fir_gate_step_fused.launches += 1
    return ([hist_out.reshape(state[0].shape), fg],
            out.reshape(x.shape[:-1] + (b_out,)))


res_fir_gate_step_fused.launches = 0


def res_fir_gate_step_info(up: int = 160, down: int = 147, h_res=None, nfft: int = 1024,
                           hop: int = 256, taps: int = 64, env_taps: int = 0,
                           block: int = 4704, noise_frames: int = 8, release: float = 0.0,
                           device=None) -> dict:
    """``res_fir_gate_step_fused``'s kernel at this geometry (``block`` raw
    samples) on a CUDA device: ``regs_info`` (registers, local bytes, CTAs
    an SM) with the frames a segment and shared memory of its launch."""
    up, down, h_res = _ratio(up, down, h_res)
    nk = taps_per_phase(len(h_res), up)
    cluster = step_cluster(nfft)
    geo = step_regs_geometry(nfft, hop, taps, env_taps, block * up // down, noise_frames,
                             (up, down, nk), cluster)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_res_fir_gate_step_info", nfft, release > 0.0, geo["smem"], dev),
                cluster=cluster, fs=geo["fs"], smem=geo["smem"])

