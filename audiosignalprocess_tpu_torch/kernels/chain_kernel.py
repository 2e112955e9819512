"""Fused FIR + spectral-noise-gate chain: the hand-written Hopper kernel
(``csrc/chain_kernel.cu``) and its plain PyTorch version.

The headline 48 kHz chain (overlap-save FIR -> STFT noise gate) in one
kernel: raw audio is read from device memory once, filtered, framed,
gated, resynthesized and written once.  Same conventions as
``oracle.noise_gate(oracle.fir_direct(x, h), ...)``; the output length is
nfft + (F-1)*hop.

Routing: a CPU tensor runs ``fir_noise_gate_ref``; a CUDA float32 tensor
launches the kernel; anything else raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    inv_norm_rows, noise_floor,
)
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.stft import frame, num_frames
from audiosignalprocess_tpu_torch.ops.windows import window_np
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check

FRAMES_PER_TILE = 16
"""Output hops per CTA in the parallel launch; each CTA also recomputes
the nfft/hop-1 frames of halo before its tile, so larger tiles waste
less and take more shared memory."""

SMEM_LIMIT = 232448
"""Dynamic shared memory one block may use on Hopper (227 KB)."""


def _check_guards(h: np.ndarray, n: int, nfft: int, hop: int,
                  noise_frames: int) -> int:
    """Validate the geometry; returns the frame count F."""
    t = len(h)
    check(nfft >= 2 and nfft & (nfft - 1) == 0,
          f"nfft={nfft} must be a power of two >= 2")
    check(hop >= 1 and nfft % hop == 0, f"hop={hop} must divide nfft={nfft}")
    check(nfft > t - 1, f"nfft={nfft} must exceed taps-1 ({t - 1})")
    nframes = num_frames(n, nfft, hop)
    check(nframes * hop >= 2 * (nfft - hop), "signal too short")
    check(nframes >= noise_frames,
          f"signal has {nframes} frames < noise_frames={noise_frames}")
    return nframes


def _geometry(nfft: int, hop: int, taps: int) -> dict:
    """Tile size and dynamic shared memory of one CTA, in the order the
    kernel carves it: twiddles (nfft/2 complex), FFT buffer (nfft
    complex), threshold and release state (nfft/2+1 each), OLA tile
    (tile + nfft-hop), raw/filtered span."""
    d = nfft - hop
    # at least nfft/hop frames per tile, so the spill (d) is shorter than
    # the tile and the sequential launch can move it without overlap
    mf = max(FRAMES_PER_TILE, nfft // hop)
    tile = mf * hop
    blk = nfft - (taps - 1)
    # the longest filtered span a tile needs is tile + 2d (its frames plus
    # the halo frames), in whole overlap-save blocks, plus the FIR history
    span = -(-(tile + 2 * d) // blk) * blk + taps - 1
    nb = nfft // 2 + 1
    smem = 8 * (nfft // 2) + 8 * nfft + 4 * (2 * nb + tile + d + span)
    return {"mf": mf, "tile": tile, "smem": smem}


def _inv_norm_table(wv: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """[head ramp (d) | one interior period (hop) | tail ramp (d)] of the
    1/WOLA norm.  Taken from a 2*nfft/hop-frame output, whose head, tail
    and interior sums run over the same frames in the same order as in
    any longer output, so each entry is bit-equal to ``inv_norm_rows``
    at the positions the kernel maps onto it."""
    d = nfft - hop
    nf = 2 * (nfft // hop)
    out_len = nfft + (nf - 1) * hop
    inv = inv_norm_rows(wv, nfft, hop, nf, out_len)
    return np.concatenate([inv[:d], inv[d : d + hop], inv[out_len - d :]])


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    fn = lib.asp_fir_noise_gate
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.asp_error_string.argtypes = [ctypes.c_int]
    lib.asp_error_string.restype = ctypes.c_char_p
    return lib


def fir_noise_gate_ref(x: torch.Tensor, h, nfft: int = 1024, hop: int = 256,
                       threshold_db: float = 6.0, reduction_db: float = 60.0,
                       noise_frames: int = 8, release: float = 0.0,
                       window_kind: str = "hann") -> torch.Tensor:
    """Plain PyTorch version: ``noise_gate(overlap_save(x, h, nfft), ...)``
    on any device and dtype."""
    y = overlap_save(x, h, nfft)
    return noise_gate(y, nfft, hop, threshold_db, reduction_db, noise_frames,
                      release, window_kind)


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
    (the release is a scan over all frames).  Any other tensor raises.
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
    geo = _geometry(nfft, hop, len(h))
    check(geo["smem"] <= SMEM_LIMIT,
          f"nfft={nfft}, hop={hop}, taps={len(h)} need {geo['smem']} bytes "
          f"of shared memory per block, more than {SMEM_LIMIT}")
    dev = xf.device
    d = nfft - hop
    out_len = nfft + (nframes - 1) * hop

    # noise floor of the filtered signal's first frames (plain torch on
    # the device, as the JAX package computes it in XLA outside Pallas)
    wv = window_np(window_kind, nfft, periodic=True)
    wv_t = upload(wv, torch.float32, dev)
    pro = overlap_save(xf[:, : min(n, d + noise_frames * hop + nfft)], h, nfft)
    floor = noise_floor(frame(pro[:, : d + noise_frames * hop], nfft, hop) * wv_t)
    floor = floor.contiguous()

    hp = np.concatenate([h, np.zeros(nfft - len(h))])
    hf = upload(np.fft.fft(hp).astype(np.complex64).view(np.float32),
                torch.float32, dev)
    tw = np.exp(-2j * np.pi * np.arange(nfft // 2) / nfft)
    tw = upload(tw.astype(np.complex64).view(np.float32), torch.float32, dev)
    inv_tab = upload(_inv_norm_table(wv, nfft, hop), torch.float32, dev)
    out = torch.empty((channels, out_len), dtype=torch.float32, device=dev)

    lib = _lib()
    rc = lib.asp_fir_noise_gate(
        xf.data_ptr(), out.data_ptr(), floor.data_ptr(), wv_t.data_ptr(),
        hf.data_ptr(), tw.data_ptr(), inv_tab.data_ptr(),
        channels, n, nfft, nfft.bit_length() - 1, hop, len(h), nframes,
        geo["mf"], int(release > 0.0),
        float(10.0 ** (threshold_db / 20.0)),
        float(10.0 ** (-reduction_db / 20.0)), float(release),
        geo["smem"], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fir_noise_gate kernel launch failed: "
                           f"{lib.asp_error_string(rc).decode()} ({rc})")
    fir_noise_gate_fused.launches += 1
    return out.reshape(batch + (out_len,))


fir_noise_gate_fused.launches = 0
