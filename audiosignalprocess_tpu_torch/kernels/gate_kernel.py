"""The spectral noise gate kernels: the whole-file gate and one time
shard of it (``csrc/gate_kernel.cu``) and the streaming gate step
(``csrc/gate_step_kernel.cu``), their plain PyTorch versions, and the
helpers the fused gate kernels share.

The streaming step kernels (the gate alone here; the FIR -> gate steps in
``chain_kernel`` and ``res_chain_kernel``) run one body,
``csrc/fir_gate_step_regs.cuh``, the gate alone with its FIR switched off;
``step_regs_geometry`` sizes its segments and shared memory.

The whole-file gate, its time shard and the whole-file FIR -> gate
chains (``chain_kernel``, ``res_chain_kernel``) run one body,
``csrc/chain_regs_device.cuh``; ``regs_geometry`` sizes its tiles and
shared memory (``gate_geometry``: the gate alone), up to nfft 8192
(``regs_threads``: one transform of 512 threads a batch there, with one
exchange buffer), past which it raises a ValueError naming SMEM_LIMIT.

Mirrors the JAX package's ``kernels/gate_kernel.py``: the 1/WOLA-norm
vectors (whole-file and streaming), the noise-floor prologue, the
whole-file gate (``noise_gate_fused``), the time shard of the sharded
gate (``gate_shard_fused``: floor in, un-normalized overlap-add and its
spill out), the position logic of a step
(``gate_step_masks``), the streaming carry (``gate_step_init_state``) and
the step itself (``gate_step_fused``).  The plain versions and the
prologue run their FFTs through torch.fft (``impl="torch"``) on any
device, so they never launch a kernel.

One carry layout serves the kernel and the plain step, and it is the
JAX package's plain-path carry (``pipeline.GateStage.init_state``):
``in_tail`` (..., d), ``fifo_r``/``fifo_i`` (..., noise_frames, nfft/2+1),
``floor_sum`` (..., 1, nfft/2+1), ``ola_tail`` (..., d), ``rel``
(..., 1, nfft/2+1) when release > 0, and ``pos`` / ``floor_n`` as Python
ints (pure functions of the block count, so a step never reads the
device).  A stream may switch between the kernel and the plain step at
any block.

Routing of ``noise_gate_fused``, ``gate_shard_fused`` and
``gate_step_fused``: a CPU tensor runs the plain version
(``noise_gate_ref``, ``gate_shard_ref``, ``gate_step_ref``); a CUDA
float32 tensor launches the kernel; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import gate_mask, noise_gate
from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels._build import (
    SMEM_LIMIT, check_cuda_f32, kernel_fn, launch, raise_on_error, rows_view,
)
from audiosignalprocess_tpu_torch.kernels.fft_kernel import real_stockham_passes, stockham_table
from audiosignalprocess_tpu_torch.kernels.resample_kernel import res_window
from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.stft import (
    WOLA_EDGE_REL, frame, num_frames, overlap_add, wola_clamp,
)
from audiosignalprocess_tpu_torch.ops.windows import window, window_np
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check

def inv_norm_rows(wv_np: np.ndarray, nfft: int, hop: int, nframes: int,
                  total_len: int) -> np.ndarray:
    """Full-length 1/WOLA-norm vector over a padded output (float64): head
    ramp, interior, tail ramp, then 1.0 in the padding past the output."""
    out_len = nfft + (nframes - 1) * hop
    w2 = wv_np ** 2
    norm_np = np.zeros(total_len)
    for k in range(nframes):
        norm_np[k * hop : k * hop + nfft] += w2
    inv = 1.0 / wola_clamp(norm_np[:out_len])
    return np.concatenate([inv, np.ones(total_len - out_len)])


def noise_floor(frames_windowed: torch.Tensor) -> torch.Tensor:
    """Per-bin noise floor, mean |rfft| over the frames axis:
    (..., frames, nfft) windowed frames -> (..., nfft/2+1)."""
    return fft_ops.rfft(frames_windowed, impl="torch").abs().mean(dim=-2)


# ---------------------------------------------------------------------------
# the batched register body's geometry (csrc/chain_regs_device.cuh)
# ---------------------------------------------------------------------------

REGS_THREADS = 256
"""Threads of a whole-file CTA (``asp::kRegsThreads``): the FIR -> gate
chains and the gate alone, up to nfft 4096 (``regs_threads``)."""

REGS_MAX_NFFT = 2 * REGS_THREADS * 16
"""The largest nfft of the batched body: one transform of 512 threads of 16
points, with one exchange buffer (8192)."""

SM_SMEM = 233472
"""Shared memory of one Hopper SM (228 KB); each resident CTA also takes 1 KB."""

REGS_CTAS = 2
"""CTAs an SM the parallel launch aims at: ``__launch_bounds__(256, 2)``
caps a thread at 128 registers, so no more than two fit."""

REGS_MAX_TILE_BATCHES = 16
"""How many tile sizes ``regs_geometry`` weighs (whole gate batches a tile,
from the fewest that leave it an own frame)."""


def regs_points(nfft: int) -> int:
    """Points a thread holds in a full pass (``asp::regs_points``)."""
    return min(16, nfft)


def regs_threads(nfft: int) -> int:
    """Threads of a CTA of the body (``asp::regs_threads``): 256, or 512 at
    nfft 8192, whose one transform is 512 threads of 16 points and whose CTA
    has one exchange buffer (two would leave no room for the span).  Past
    8192 one transform would need more shared memory than SMEM_LIMIT."""
    check(nfft <= REGS_MAX_NFFT,
          f"nfft={nfft}: one transform of the whole-file body is {nfft // 16} threads of 16 "
          f"points and its exchange buffer {8 * nfft} bytes, with the threshold, carries "
          f"and span more shared memory per block than SMEM_LIMIT ({SMEM_LIMIT} bytes); "
          f"nfft <= {REGS_MAX_NFFT}")
    return 2 * REGS_THREADS if nfft > 16 * REGS_THREADS else REGS_THREADS


def regs_one_buffer(nfft: int) -> bool:
    """Whether the body's CTA has one exchange buffer (nfft 8192: every pass
    that reads and writes it holds its points across a barrier)."""
    return regs_threads(nfft) > REGS_THREADS


def regs_batch(nfft: int) -> int:
    """Transforms a CTA runs at once (a batch): ``regs_threads`` threads of
    ``regs_points`` points, 4 at nfft 1024, 1 at 4096 and 8192; a gate batch
    is twice as many frames and a FIR batch twice as many overlap-save
    blocks."""
    return regs_threads(nfft) * regs_points(nfft) // nfft


def regs_pass_plan(nfft: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(forward, inverse) passes, (first stage, stages) each, of the body's
    nfft-point transforms: ``rfft_stockham``'s plan for its nfft-point
    half-size transform, so the forward's last pass and the inverse's
    first have the same points a group (log2 nfft mod 4 stages, 1 where
    that is 0), which the body merges into one pass with the per-bin work."""
    return real_stockham_passes(2 * nfft), real_stockham_passes(2 * nfft, inverse=True)


def regs_span(nfft: int, hop: int, taps: int, mf: int, sequential: bool,
              fir: bool = True) -> int:
    """Floats of the span a tile's frames read (``asp::regs_span``): its mf
    frames and, in the parallel launch, the nfft/hop - 1 halo frames; with
    the FIR (``fir``) in whole overlap-save blocks, plus the FIR history."""
    halo = 0 if sequential else nfft // hop - 1
    length = (mf + halo - 1) * hop + nfft
    if not fir:
        return length
    blk = nfft - (taps - 1)
    return -(-length // blk) * blk + taps - 1


def regs_smem(nfft: int, hop: int, taps: int, mf: int, sequential: bool,
              tail: int = 0, fir: bool = True) -> int:
    """Dynamic shared memory of one CTA, in the order
    ``asp::fir_gate_regs`` carves it: threshold and release state (nfft/2+1
    each), two OLA carries (nfft-hop each), the span and the batch's masks
    (release > 0) with two exchange buffers only (at nfft 8192 the span is
    in device memory, ``regs_span_rows``), then the exchange buffers (two,
    or one at nfft 8192), or ``tail`` floats if the kernel's fill needs
    more there."""
    nb = nfft // 2 + 1
    one = regs_one_buffer(nfft)
    head = 2 * nb + 2 * (nfft - hop)
    if not one:
        head += (regs_span(nfft, hop, taps, mf, sequential, fir)
                 + (2 * regs_batch(nfft) * nb if sequential else 0))
    exchange = (1 if one else 2) * 2 * regs_threads(nfft) * regs_points(nfft)
    return 4 * (head + max(exchange, tail))


def regs_geometry(nfft: int, hop: int, taps: int, sequential: bool = False,
                  tail=None, fir: bool = True) -> dict:
    """Frames per tile (mf), span and shared memory of the batched body;
    ``fir`` False sizes the gate alone (``noise_gate_fused``,
    ``gate_shard_fused``: ``taps`` 1, no FIR batches, a span of the tile's
    frames only).

    A tile's frames (its mf and, in the parallel launch, the nfft/hop - 1
    halo frames) fill whole gate batches: mf = k * 2B - halo, k from the
    fewest batches that leave the tile an own frame, REGS_MAX_TILE_BATCHES
    values.  Among those whose shared memory fits SMEM_LIMIT, the parallel
    launch takes the most CTAs an SM (up to REGS_CTAS), then the fewest
    batches (gate and FIR) per own frame; the sequential launch (one CTA a
    channel) only the fewest batches.  Ties go to the smaller tile with the
    FIR, to the larger (fewer tiles, each with a fill) without it.
    ``tail(span)`` gives the floats the kernel's fill needs in the tail
    (``resample_fir_gate_fused``: its phase bank and raw window).  At
    nfft 1024, hop 256, 64 taps: mf = 21 (24 frames, three gate batches,
    one FIR batch of 8 blocks), 2 CTAs an SM; the gate alone: mf = 29 (32
    frames, four gate batches), 2 CTAs an SM, and mf = 128 in the
    sequential launch.  At nfft 8192 (one transform a batch, 512 threads,
    one exchange buffer, the span in device memory) one CTA an SM and
    mf = 31 (hop 2048: 34 frames, 17 gate batches), 32 for the sequential
    launch; past it a ValueError names SMEM_LIMIT."""
    halo = 0 if sequential else nfft // hop - 1
    nfb = 2 * regs_batch(nfft)
    blk = nfft - (taps - 1)
    best = None
    k0 = halo // nfb + 1  # the fewest batches that leave an own frame
    for k in range(k0, k0 + REGS_MAX_TILE_BATCHES):
        mf = k * nfb - halo
        span = regs_span(nfft, hop, taps, mf, sequential, fir)
        smem = regs_smem(nfft, hop, taps, mf, sequential, tail(span) if tail else 0, fir)
        if smem > SMEM_LIMIT:
            break
        nblk = -(-((mf + halo - 1) * hop + nfft) // blk)
        fir_batches = -(-nblk // nfb) if fir else 0
        ctas = 1 if sequential else min(REGS_CTAS, SM_SMEM // (smem + 1024))
        key = (-ctas, (k + fir_batches) / mf, mf if fir else -mf)
        if best is None or key < best[0]:
            best = (key, dict(mf=mf, span=span, smem=smem))
    check(best is not None,
          f"nfft={nfft}, hop={hop}, taps={taps} need more shared memory per block "
          f"than SMEM_LIMIT ({SMEM_LIMIT} bytes) for one batch of frames")
    return best[1]


def regs_span_rows(nfft: int, hop: int, geo: dict, channels: int, out_len: int,
                   sequential: bool, device: torch.device):
    """The CTAs' spans of a launch of the batched body in device memory
    (``span_rows`` of ``asp::fir_gate_regs``): at nfft 8192 a row of
    ``geo["span"]`` floats for each CTA, (channel, tile) or one CTA a
    channel in the sequential launch; else None (a null pointer: the span
    is in shared memory)."""
    if not regs_one_buffer(nfft):
        return None
    ctas = channels * (1 if sequential else -(-out_len // (geo["mf"] * hop)))
    return torch.empty((ctas, geo["span"]), dtype=torch.float32, device=device)


def data_ptr(t: torch.Tensor | None):
    """A tensor's device address for ctypes, None (NULL) for None."""
    return None if t is None else t.data_ptr()


def regs_info(symbol: str, nfft: int, sequential: bool | None, smem: int,
              device: torch.device) -> dict:
    """The built kernel's instantiation for nfft and the launch, from the
    CUDA runtime: registers a thread, local memory a thread (spills) and
    resident CTAs an SM at ``smem`` bytes of shared memory (the occupancy
    API).  ``sequential`` None: the symbol takes no release argument."""
    fn = getattr(_build.load(), symbol)
    args = (nfft,) + (() if sequential is None else (int(sequential),))
    fn.argtypes = [ctypes.c_int] * (len(args) + 2) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 3)()
    raise_on_error(fn(*args, smem, device.index or 0, info), symbol)
    return dict(registers=info[0], local_bytes=info[1], ctas=info[2])


# ---------------------------------------------------------------------------
# the whole-file gate (and the tables the whole-file chains share)
# ---------------------------------------------------------------------------

def check_gate_guards(n: int, nfft: int, hop: int, noise_frames: int) -> int:
    """Validate a whole-file gate's geometry; returns the frame count F."""
    check(nfft >= 2 and nfft & (nfft - 1) == 0,
          f"nfft={nfft} must be a power of two >= 2")
    check(hop >= 1 and nfft % hop == 0, f"hop={hop} must divide nfft={nfft}")
    nframes = num_frames(n, nfft, hop)
    check(nframes * hop >= 2 * (nfft - hop), "signal too short")
    check(nframes >= noise_frames,
          f"signal has {nframes} frames < noise_frames={noise_frames}")
    return nframes


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


@functools.lru_cache(maxsize=32)
def file_tables(nfft: int, hop: int, window_kind: str, device: torch.device) -> tuple:
    """The whole-file kernels' constant tables on ``device``, float32,
    uploaded once per geometry: the periodic window, the forward and
    inverse per-stage tables of the batched body's transforms
    (``fft_kernel.stockham_table(nfft, -1)``, ``(nfft, +1)``) and the
    [head | period | tail] 1/WOLA-norm table."""
    wv = window_np(window_kind, nfft, periodic=True)
    f32 = lambda a: upload(np.ascontiguousarray(a), torch.float32, device)
    return (f32(wv), stockham_table(nfft, -1, device), stockham_table(nfft, 1, device),
            f32(_inv_norm_table(wv, nfft, hop)))


def gate_geometry(nfft: int, hop: int, sequential: bool) -> dict:
    """``regs_geometry`` of the gate alone: one tap, no FIR batches."""
    return regs_geometry(nfft, hop, 1, sequential, fir=False)


@functools.cache
def _lib():
    fn = _build.load().asp_noise_gate
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def noise_gate_ref(x: torch.Tensor, nfft: int = 1024, hop: int = 256,
                   threshold_db: float = 6.0, reduction_db: float = 60.0,
                   noise_frames: int = 8, release: float = 0.0,
                   window_kind: str = "hann") -> torch.Tensor:
    """Plain PyTorch version: ``effects.noise_gate`` with ``impl="torch"``,
    any device and dtype."""
    return noise_gate(x, nfft, hop, threshold_db, reduction_db, noise_frames,
                      release, window_kind, impl="torch")


@kernel_wrapper
def noise_gate_fused(x: torch.Tensor, nfft: int = 1024, hop: int = 256,
                     threshold_db: float = 6.0, reduction_db: float = 60.0,
                     noise_frames: int = 8, release: float = 0.0,
                     window_kind: str = "hann") -> torch.Tensor:
    """Spectral noise gate, fused: x (..., n) -> (..., nfft + (F-1)*hop).

    A CPU tensor runs ``noise_gate_ref``.  A CUDA float32 tensor launches
    the kernel: one CTA per (channel, tile) when ``release`` is 0, one CTA
    per channel walking its frames in order when it is not (the release is
    a scan over all frames); ``gate_geometry`` gives the tile.  Any other
    tensor raises.
    """
    n = x.shape[-1]
    nframes = check_gate_guards(n, nfft, hop, noise_frames)
    if x.device.type == "cpu":
        return noise_gate_ref(x, nfft, hop, threshold_db, reduction_db, noise_frames,
                              release, window_kind)
    check_cuda_f32(x, "noise_gate_fused", "GateStage routes float64 to the plain gate")
    batch = x.shape[:-1]
    xf = x.reshape(-1, n).contiguous()
    channels = xf.shape[0]
    check(0 < channels <= 65535, f"{channels} channels: 1..65535 per launch")
    geo = gate_geometry(nfft, hop, release > 0.0)
    dev = xf.device
    out_len = nfft + (nframes - 1) * hop
    win, twf, twi, inv_tab = file_tables(nfft, hop, window_kind, dev)
    head = xf[:, : nfft - hop + noise_frames * hop]
    floor = noise_floor(frame(head, nfft, hop) * win).contiguous()
    out = torch.empty((channels, out_len), dtype=torch.float32, device=dev)
    spans = regs_span_rows(nfft, hop, geo, channels, out_len, release > 0.0, dev)
    launch("noise_gate", _lib(), xf.data_ptr(), out.data_ptr(), floor.data_ptr(),
           win.data_ptr(), twf.data_ptr(), twi.data_ptr(), inv_tab.data_ptr(),
           data_ptr(spans), channels, n, nfft, nfft.bit_length() - 1, hop, nframes, geo["mf"],
           int(release > 0.0), float(10.0 ** (threshold_db / 20.0)),
           float(10.0 ** (-reduction_db / 20.0)), float(release), geo["smem"], dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    noise_gate_fused.launches += 1
    return out.reshape(batch + (out_len,))


noise_gate_fused.launches = 0


def noise_gate_info(nfft: int = 1024, hop: int = 256, release: float = 0.0,
                    device=None) -> dict:
    """``noise_gate_fused``'s kernel at this geometry on a CUDA device (the
    same as ``gate_shard_fused``'s where release is 0): ``regs_info``
    (registers, local bytes, CTAs an SM) with the frames per tile and
    shared memory of its launch."""
    geo = gate_geometry(nfft, hop, release > 0.0)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_noise_gate_info", nfft, release > 0.0, geo["smem"], dev),
                mf=geo["mf"], smem=geo["smem"])


# ---------------------------------------------------------------------------
# one time shard of the gate (parallel/sharded.gate_shard_body)
# ---------------------------------------------------------------------------

def check_shard_geometry(n_ext: int, nfft: int, hop: int, n_valid: int) -> int:
    """Validate one shard's geometry: x_ext holds l + nfft-hop samples, l a
    multiple of hop, and the first ``n_valid`` of its l/hop frames are
    analysed.  Returns l."""
    check(nfft >= 2 and nfft & (nfft - 1) == 0, f"nfft={nfft} must be a power of two >= 2")
    check(hop >= 1 and nfft % hop == 0, f"hop={hop} must divide nfft={nfft}")
    l = n_ext - (nfft - hop)
    check(l >= hop and l % hop == 0, f"shard length {l} not a multiple of hop")
    check(isinstance(n_valid, int) and 0 <= n_valid <= l // hop,
          f"n_valid={n_valid!r} must be an int in [0, {l // hop}]")
    return l


def gate_shard_ref(x_ext: torch.Tensor, floor_half: torch.Tensor, n_valid: int,
                   nfft: int, hop: int, threshold_db: float = 6.0,
                   reduction_db: float = 60.0, window_kind: str = "hann") -> torch.Tensor:
    """Plain PyTorch version of ``gate_shard_fused``, any device and dtype
    (torch.fft): frames, window, rfft, hard mask against ``floor_half``,
    irfft, window and overlap-add of the first ``n_valid`` frames, zero
    past them; (..., l + nfft-hop) un-normalized."""
    n_ext = x_ext.shape[-1]
    check_shard_geometry(n_ext, nfft, hop, n_valid)
    if n_valid == 0:
        return torch.zeros_like(x_ext)
    w = window(window_kind, nfft, periodic=True, dtype=x_ext.dtype, device=x_ext.device)
    spec = fft_ops.rfft(frame(x_ext[..., : (n_valid - 1) * hop + nfft], nfft, hop) * w,
                        impl="torch")
    mask = gate_mask(spec.abs(), floor_half.unsqueeze(-2), threshold_db, reduction_db)
    acc = overlap_add(fft_ops.irfft(spec * mask, nfft, impl="torch") * w, hop)
    return torch.nn.functional.pad(acc, (0, n_ext - acc.shape[-1]))


@functools.cache
def _shard_lib():
    fn = _build.load().asp_gate_shard
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@kernel_wrapper
def gate_shard_fused(x_ext: torch.Tensor, floor_half: torch.Tensor, n_valid: int,
                     nfft: int, hop: int, threshold_db: float = 6.0,
                     reduction_db: float = 60.0, window_kind: str = "hann") -> torch.Tensor:
    """One time shard of the gate, fused: x_ext (..., l + d), d = nfft-hop,
    the shard's samples and its right neighbour's first d -> the
    un-normalized overlap-add (..., l + d), the d-sample spill included.

    ``floor_half`` (..., nfft/2+1) is the global noise floor (time shard
    0's, broadcast by the caller); ``n_valid`` counts the shard's frames
    that end inside the file (a prefix of its l/hop frames), a Python int,
    so the wrapper never reads the device.  No release.  A CPU tensor runs
    ``gate_shard_ref``.  A CUDA float32 tensor launches the kernel: one CTA
    per (channel, tile), as ``noise_gate_fused``.  Any other tensor raises.
    """
    n_ext = x_ext.shape[-1]
    check_shard_geometry(n_ext, nfft, hop, n_valid)
    if x_ext.device.type == "cpu":
        return gate_shard_ref(x_ext, floor_half, n_valid, nfft, hop, threshold_db,
                              reduction_db, window_kind)
    check_cuda_f32(x_ext, "gate_shard_fused", "the sharded gate routes float64 to its plain body")
    xf = x_ext.reshape(-1, n_ext).contiguous()
    channels = xf.shape[0]
    check(0 < channels <= 65535, f"{channels} channels: 1..65535 per launch")
    nb = nfft // 2 + 1
    dev = xf.device
    check(floor_half.dtype == torch.float32 and floor_half.device == dev,
          "the floor must be float32 on the input's device")
    floor = torch.broadcast_to(floor_half.reshape(-1, nb), (channels, nb)).contiguous()
    geo = gate_geometry(nfft, hop, False)
    win, twf, twi, _ = file_tables(nfft, hop, window_kind, dev)
    out = torch.empty((channels, n_ext), dtype=torch.float32, device=dev)
    spans = regs_span_rows(nfft, hop, geo, channels, n_ext, False, dev)
    launch("gate_shard", _shard_lib(), xf.data_ptr(), out.data_ptr(), floor.data_ptr(),
           win.data_ptr(), twf.data_ptr(), twi.data_ptr(), data_ptr(spans), channels, n_ext,
           nfft, nfft.bit_length() - 1, hop, n_valid, geo["mf"],
           float(10.0 ** (threshold_db / 20.0)), float(10.0 ** (-reduction_db / 20.0)),
           geo["smem"], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    gate_shard_fused.launches += 1
    return out.reshape(x_ext.shape)


gate_shard_fused.launches = 0


# ---------------------------------------------------------------------------
# streaming WOLA norms (the JAX package's pipeline._wola_*_norm)
# ---------------------------------------------------------------------------

def wola_const_norm(nfft: int, hop: int, window_kind: str) -> float:
    """Interior WOLA norm (COLA constant: sum_k w^2[n-k*hop])."""
    w2 = window_np(window_kind, nfft) ** 2
    cols = np.sum(w2.reshape(nfft // hop, hop), axis=0)
    check(np.allclose(cols, cols[0]), "window/hop is not COLA for w^2")
    return float(cols[0])


def _edge_clamp(norm: np.ndarray, nfft: int, hop: int, window_kind: str) -> np.ndarray:
    # clamp relative to the INTERIOR peak, as the whole-file norm does: the
    # edge's own max is itself a ramp value and would under-clamp
    const = wola_const_norm(nfft, hop, window_kind)
    return np.maximum(norm, max(WOLA_EDGE_REL * const, 1e-12))


def wola_head_norm(nfft: int, hop: int, window_kind: str) -> np.ndarray:
    """Per-sample WOLA norm over the first nfft-hop output samples (the
    ramp-in of the whole-file istft)."""
    w2 = window_np(window_kind, nfft) ** 2
    d = nfft - hop
    norm = np.zeros(d)
    for lo in range(0, d, hop):
        seg = min(nfft, d - lo)
        norm[lo : lo + seg] += w2[:seg]
    return _edge_clamp(norm, nfft, hop, window_kind)


def wola_tail_norm(nfft: int, hop: int, window_kind: str) -> np.ndarray:
    """Per-sample WOLA norm over the LAST nfft-hop output samples of a
    whole-file istft (the ramp-out): position nout-d+i is covered by the
    final frames at window offsets hop+i, 2*hop+i, ...  Used by drained
    streams to reproduce the finite-file edge normalization."""
    w2 = window_np(window_kind, nfft) ** 2
    d = nfft - hop
    norm = np.array([w2[hop + i :: hop].sum() for i in range(d)])
    return _edge_clamp(norm, nfft, hop, window_kind)


def wola_norm_at(p: torch.Tensor, head: torch.Tensor, const: float, d: int,
                 eof_out: int | None = None,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """Streaming WOLA norm at output positions ``p``: 1.0 before the
    signal, the head ramp over [0, d), the constant after.  With
    ``eof_out`` (a drained stream): the finite-file ramp-out over
    [eof_out - d, eof_out) and 1.0 past ``eof_out``, where only zeros are
    emitted."""
    norm = torch.where(p < 0, torch.ones_like(head[:1]),
                       torch.where(p < d, head[p.clamp(0, d - 1)],
                                   torch.full_like(head[:1], const)))
    if eof_out is not None:
        ti = (p - (eof_out - d)).clamp(0, d - 1)
        norm = torch.where(p >= eof_out, torch.ones_like(norm),
                           torch.where(p >= eof_out - d, tail[ti], norm))
    return norm


def wola_ola_emit(out_frames: torch.Tensor, ola_tail: torch.Tensor, hop: int,
                  norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise WOLA synthesis: overlap-add the m synthesized frames
    (..., m, nfft) with the d-sample tail carry, divide the first m*hop
    samples by ``norm``.  Returns (y, new_tail)."""
    m, nfft = out_frames.shape[-2], out_frames.shape[-1]
    d = nfft - hop
    b = m * hop
    acc = out_frames.new_zeros(out_frames.shape[:-2] + (b + d,))
    for j in range(m):
        acc[..., j * hop : j * hop + nfft] += out_frames[..., j, :]
    acc[..., :d] += ola_tail
    return acc[..., :b] / norm, acc[..., b:]


# ---------------------------------------------------------------------------
# the streaming step
# ---------------------------------------------------------------------------

def gate_step_masks(pos: int, floor_n: int, m: int, d: int, hop: int,
                    noise_frames: int, input_latency: int,
                    eof_in: int | None = None):
    """Position logic of one step, all host integers: per new frame its
    validity (frames over the latency padding carry no signal; in a
    drained stream frames straddling end-of-file are never analyzed) and
    whether it feeds the noise floor (the first ``noise_frames`` valid
    frames of the stream).  Also the whole-file synthesis length
    ``eof_out`` of a drained stream (None otherwise).  Returns
    (valid, take, eof_out)."""
    nfft = d + hop
    starts = [pos - d + hop * j for j in range(m)]
    valid = [s >= input_latency for s in starts]
    eof_out = None
    if eof_in is not None:
        valid = [v and s + nfft <= eof_in for v, s in zip(valid, starts)]
        n_real = eof_in - input_latency
        eof_out = nfft + ((n_real - nfft) // hop) * hop if n_real >= nfft else 0
    take, seen = [], floor_n
    for v in valid:
        seen += v
        take.append(v and seen <= noise_frames)
    return valid, take, eof_out


def gate_step_init_state(batch: tuple, nfft: int, hop: int, noise_frames: int,
                         release: float, dtype=torch.float32,
                         device=None) -> dict:
    """The streaming gate carry (see the module docstring)."""
    d = nfft - hop
    nb = nfft // 2 + 1
    z = lambda *shape: torch.zeros(batch + shape, dtype=dtype, device=device)
    st = dict(in_tail=z(d), fifo_r=z(noise_frames, nb), fifo_i=z(noise_frames, nb),
              floor_sum=z(1, nb), floor_n=0, ola_tail=z(d), pos=0)
    if release > 0.0:
        # release state s after the last emitted frame; zero init is exact
        # (pad frames contribute at most att, absorbed by the max)
        st["rel"] = z(1, nb)
    return st


@functools.lru_cache(maxsize=32)
def _step_tables_np(nfft: int, hop: int, window_kind: str):
    """Float64 design-time tables of a step: the periodic window and the
    head, constant and tail WOLA norms."""
    return (window_np(window_kind, nfft, periodic=True),
            wola_head_norm(nfft, hop, window_kind),
            wola_const_norm(nfft, hop, window_kind),
            wola_tail_norm(nfft, hop, window_kind))


@functools.lru_cache(maxsize=32)
def step_device_tables(nfft: int, hop: int, window_kind: str,
                       device: torch.device) -> dict:
    """The step kernels' constant tables on ``device``, uploaded once per
    geometry (pinned, non-blocking): the window, the forward and inverse
    per-stage tables of the body's transforms (``stockham_table(nfft, -1)``,
    ``(nfft, +1)``), the 1/norm head and tail ramps; ``inv_const`` stays a
    host float."""
    wv, head, const, tail = _step_tables_np(nfft, hop, window_kind)
    f32 = lambda a: upload(np.ascontiguousarray(a), torch.float32, device)
    return dict(win=f32(wv), twf=stockham_table(nfft, -1, device),
                twi=stockham_table(nfft, 1, device), inv_head=f32(1.0 / head),
                inv_tail=f32(1.0 / tail), inv_const=1.0 / const)


def gate_step_ref(x: torch.Tensor, state: dict, *, nfft: int, hop: int,
                  threshold_db: float, reduction_db: float, noise_frames: int,
                  release: float, window_kind: str, input_latency: int,
                  latency: int, eof_in: int | None = None, impl: str = "torch"):
    """Plain PyTorch streaming gate step: (state, x) -> (new_state, y),
    any device and dtype (the JAX package's ``GateStage.step``).  ``impl``
    is the FFT implementation of its two transforms (``ops.fft``); the
    default pins torch.fft, as every plain version does."""
    b = x.shape[-1]
    check(b % hop == 0 and b >= hop, f"block {b} not a multiple of hop={hop}")
    m, d = b // hop, nfft - hop
    dtype, dev = x.dtype, x.device
    pos, floor_n = state["pos"], state["floor_n"]
    valid, take, eof_out = gate_step_masks(pos, floor_n, m, d, hop,
                                           noise_frames, input_latency, eof_in)
    wv, head, const, tail = _step_tables_np(nfft, hop, window_kind)
    w = upload(wv, dtype, dev)
    ext = torch.cat([state["in_tail"], x], dim=-1)                  # (..., b+d)
    spec = fft_ops.rfft(frame(ext, nfft, hop) * w, impl=impl)       # (..., m, nb)
    spec = spec * upload(np.array(valid, np.float64), dtype, dev)[:, None]
    tmask = upload(np.array(take, np.float64), dtype, dev)
    floor_sum = state["floor_sum"] + (spec.abs() * tmask[:, None]).sum(
        dim=-2, keepdim=True)
    buf_r = torch.cat([state["fifo_r"], spec.real], dim=-2)
    buf_i = torch.cat([state["fifo_i"], spec.imag], dim=-2)
    popped = torch.complex(buf_r[..., :m, :], buf_i[..., :m, :])
    mask = gate_mask(popped.abs(), floor_sum / noise_frames, threshold_db,
                     reduction_db)
    new_state = dict(in_tail=ext[..., b:], fifo_r=buf_r[..., m:, :],
                     fifo_i=buf_i[..., m:, :], floor_sum=floor_sum,
                     floor_n=floor_n + sum(take), pos=pos + b)
    if release > 0.0:
        # s_q = max(mask_q, release * s_{q-1}) over the popped frames,
        # carried across blocks: the whole-file scan exactly
        s = state["rel"]
        rows = []
        for q in range(m):
            s = torch.maximum(mask[..., q : q + 1, :], release * s)
            rows.append(s)
        mask = torch.cat(rows, dim=-2)
        new_state["rel"] = s
    out_frames = fft_ops.irfft(popped * mask, nfft, impl=impl) * w
    p = torch.arange(b, device=dev) + (pos - latency - input_latency)
    norm = wola_norm_at(p, upload(head, dtype, dev), const, d, eof_out,
                        upload(tail, dtype, dev))
    y, new_state["ola_tail"] = wola_ola_emit(out_frames, state["ola_tail"], hop, norm)
    return new_state, y


class GateStepArgs(ctypes.Structure):
    """The step kernels' gate arguments: ``struct GateStepArgs`` of
    ``csrc/fir_gate_step_regs.cuh``, field for field (``tw`` and ``ring``
    unused: null and 0)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "x", "out", "in_tail", "fifo_r", "fifo_i", "floor_sum", "ola_tail",
            "rel", "in_tail_out", "fifo_r_out", "fifo_i_out", "floor_sum_out",
            "ola_tail_out", "rel_out", "scratch_r", "scratch_i", "win", "tw",
            "inv_head", "inv_tail")]
        + [(name, ctypes.c_int) for name in (
            "channels", "x_ld", "b", "nfft", "log2n", "hop", "nf", "pos",
            "floor_n", "input_latency", "latency", "eof_in", "eof_out",
            "ring", "has_release")]
        + [(name, ctypes.c_float) for name in (
            "thresh_gain", "att", "release", "inv_const")])


class FirEnvArgs(ctypes.Structure):
    """The FIR front, envelope tail and shared-memory layout of the step
    body's arguments: ``struct FirEnvArgs`` of
    ``csrc/fir_gate_step_regs.cuh`` (the gate step fills only the tables
    and the layout)."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "hist", "hist_out", "hf", "twf", "twi", "env_hist", "env_hist_out",
        "env_taps_rev", "rect")]
        + [("taps", ctypes.c_int), ("env_taps", ctypes.c_int),
           ("env_scale", ctypes.c_float)]
        + [(name, ctypes.c_int) for name in (
            "fs", "pop_smem", "o_masks", "o_carry", "o_span", "o_pop", "o_rect", "o_ex",
            "o_part")])


STEP_OFFSETS = ("o_masks", "o_carry", "o_span", "o_pop", "o_rect", "o_ex", "o_part")
"""The shared-memory offsets of ``step_regs_geometry``, in FirEnvArgs' order."""


def step_cluster(nfft: int) -> int:
    """CTAs per channel of a step launch at nfft (``asp::step_ctas``): a
    cluster of two, each taking half of a block's batches, or one CTA of
    512 threads at nfft 8192, whose one exchange buffer leaves no room for
    the peer's floor part."""
    return 1 if regs_one_buffer(nfft) else 2


def step_split(m: int, nfft: int, cluster: int) -> int:
    """The frames of a block's first CTA (``split`` of
    ``asp::fir_gate_step_regs``, ``asp::cta_split``): all of them, or with a
    cluster of two the larger half in whole batches."""
    nfb = 2 * regs_batch(nfft)
    return m if cluster == 1 else min(m, -(-m // (2 * nfb)) * nfb)


def step_span(nfft: int, hop: int, taps: int, m: int, fs: int,
              ranges=None) -> tuple[int, int]:
    """(span, fill part) in floats of the largest analysis segment of a
    step block of m new frames, fs a segment from the start of each CTA's
    frames [lo, hi) of ``ranges`` (all m where None)
    (``asp::fir_gate_step_regs``): the segment's frames read [in_tail |
    gate input] from ext position j0 hop on, the part before ext position
    nfft-hop copied from in_tail, the rest the fill's: the FIR's input in
    whole overlap-save blocks plus the FIR history, or with ``taps`` 0 (no
    FIR, the gate step) the block's own samples."""
    d = nfft - hop
    span = part = 0
    for lo, hi in ranges or [(0, m)]:  # each CTA's frames
        for j0 in range(lo, hi, fs):
            tl = max(0, d - j0 * hop)
            fill = (min(hi, j0 + fs) - j0 - 1) * hop + nfft - tl
            if taps:
                blk = nfft - (taps - 1)
                fill = -(-fill // blk) * blk + taps - 1
            span, part = max(span, tl + fill), max(part, fill)
    return span, part


@functools.lru_cache(maxsize=256)
def step_regs_geometry(nfft: int, hop: int, taps: int, env_taps: int, b: int,
                       noise_frames: int, res: tuple | None = None,
                       cluster: int = 1) -> dict:
    """Frames a segment, where the popped spectra and the envelope's input
    live, and the shared-memory offsets (floats) and bytes of the step body
    (``asp::fir_gate_step_regs``) for a block of b samples: floor sum and
    release state (nfft/2+1 each), the masks buffer (2B (nfft/2+1), none at
    nfft 8192), two OLA carries (nfft-hop each), the span (``step_span``;
    ``taps`` 0: the gate step, no FIR), the pop buffer (the m - noise_frames
    frames the block pops itself, 2 (nfft/2+1) floats each), the rectified
    row (env_taps - 1 + b), then the exchange buffers (``regs_smem``'s), or
    the resampler's phase bank and raw window if larger (``res`` = (up,
    down, nk), reduced).

    The whole block in one segment with both buffers in shared memory
    where that fits SMEM_LIMIT (the headline: 16 frames, 5 or 6 FIR blocks,
    one CTA an SM); else the pop buffer, then the rectified row, then both
    go to device memory (the kernel's scratch rows), each with the largest
    segment that fits (powers of two of 2B frames).  With a cluster of two
    CTAs (``cluster`` 2) each CTA's segments cover its own frames
    (``step_split``) and the second CTA's floor part (nfft/2+1) follows
    the tail.  A ValueError names SMEM_LIMIT where nothing fits (nfft >
    8192)."""
    nb, d = nfft // 2 + 1, nfft - hop
    m = b // hop
    ns = max(m - noise_frames, 0)
    one = regs_one_buffer(nfft)
    nfb = 2 * regs_batch(nfft)
    exchange = (1 if one else 2) * 2 * regs_threads(nfft) * regs_points(nfft)
    ehl = env_taps - 1 if env_taps else 0
    o_masks = 2 * nb
    o_carry = o_masks + (0 if one else nfb * nb)
    o_span = o_carry + 2 * d
    split = step_split(m, nfft, cluster)
    ranges = [(0, split), (split, m)]
    fs_all = -(-split // nfb) * nfb
    sizes = [fs_all] + [nfb << k for k in range(fs_all.bit_length()) if nfb << k < fs_all][::-1]
    for pop_smem, rect_smem in ((1, 1), (1, 0), (0, 1), (0, 0)):
        if not env_taps and not rect_smem:
            continue
        for fs in sizes:
            span, part = step_span(nfft, hop, taps, m, fs, ranges=ranges)
            o_pop = o_span + span
            o_rect = o_pop + (2 * ns * nb if pop_smem else 0)
            o_ex = o_rect + (ehl + b if env_taps and rect_smem else 0)
            tail = exchange
            if res is not None:
                up, down, nk = res
                tail = max(tail, up * nk + res_window(part, up, down, nk))
            o_part = o_ex + tail
            smem = 4 * (o_part + (nb if cluster > 1 else 0))
            if smem <= SMEM_LIMIT:
                return dict(fs=fs, pop_smem=pop_smem, rect_smem=bool(env_taps and rect_smem),
                            o_masks=o_masks, o_carry=o_carry, o_span=o_span, o_pop=o_pop,
                            o_rect=o_rect, o_ex=o_ex, o_part=o_part, cluster=cluster,
                            smem=smem)
    raise ValueError(f"nfft={nfft}, hop={hop}, taps={taps}: the step body needs more shared "
                     f"memory per block than SMEM_LIMIT ({SMEM_LIMIT} bytes) for one batch")


def gate_step_args(x2d: torch.Tensor, x_ld: int, state: dict, out: torch.Tensor,
                   *, nfft, hop, threshold_db, reduction_db, noise_frames,
                   release, window_kind, input_latency, latency, eof_in,
                   scratch: bool = True):
    """Check a step's geometry, allocate the new gate carry and fill the
    kernel's argument struct (``scratch`` False: no scratch rows for the
    spectra the block pops itself, which the FIR -> gate step body keeps
    in shared memory where they fit).  Returns (args, new_state, keep):
    ``keep`` holds the tensors the struct points to until the launch is
    queued."""
    dev = x2d.device
    channels, b = x2d.shape
    check(0 < channels <= 65535, f"{channels} channels: 1..65535 per launch")
    check(b % hop == 0 and b >= hop, f"block {b} not a multiple of hop={hop}")
    check(nfft >= 2 and nfft & (nfft - 1) == 0, f"nfft={nfft} must be a power of two")
    check(nfft % hop == 0, f"hop={hop} must divide nfft={nfft}")
    m, d, nb, nf = b // hop, nfft - hop, nfft // 2 + 1, noise_frames
    pos, floor_n = state["pos"], state["floor_n"]
    check(pos + b + nfft < 2 ** 31,
          f"stream position {pos + b} past the kernel's 32-bit positions")
    _, take, eof_out = gate_step_masks(pos, floor_n, m, d, hop, nf,
                                       input_latency, eof_in)
    tabs = step_device_tables(nfft, hop, window_kind, dev)
    keys = ["in_tail", "fifo_r", "fifo_i", "floor_sum", "ola_tail"]
    if release > 0.0:
        keys.append("rel")
    cur = {k: state[k].contiguous() for k in keys}
    check(all(v.dtype == torch.float32 and v.device == dev for v in cur.values()),
          "the gate carry must be float32 on the input's device")
    new = {k: torch.empty_like(v) for k, v in cur.items()}
    rows = torch.empty((2, channels, max(m - nf, 0), nb) if scratch else (2, 0),
                       dtype=torch.float32, device=dev)
    ptr = lambda d_, k: d_[k].data_ptr() if k in d_ else None
    args = GateStepArgs(
        x2d.data_ptr(), out.data_ptr(), *(ptr(cur, k) for k in (
            "in_tail", "fifo_r", "fifo_i", "floor_sum", "ola_tail", "rel")),
        *(ptr(new, k) for k in (
            "in_tail", "fifo_r", "fifo_i", "floor_sum", "ola_tail", "rel")),
        *((rows[0].data_ptr(), rows[1].data_ptr()) if scratch else (None, None)),
        tabs["win"].data_ptr(), None, tabs["inv_head"].data_ptr(),
        tabs["inv_tail"].data_ptr(),
        channels, x_ld, b, nfft, nfft.bit_length() - 1, hop, nf, pos, floor_n,
        input_latency, latency, -1 if eof_in is None else eof_in,
        -1 if eof_out is None else eof_out, 0, int(release > 0.0),
        float(10.0 ** (threshold_db / 20.0)), float(10.0 ** (-reduction_db / 20.0)),
        float(release), tabs["inv_const"])
    new_state = dict(new, floor_n=floor_n + sum(take), pos=pos + b)
    return args, new_state, (cur, rows)


@kernel_wrapper
def gate_step_fused(x: torch.Tensor, state: dict, *, nfft: int, hop: int,
                    threshold_db: float, reduction_db: float,
                    noise_frames: int, release: float, window_kind: str,
                    input_latency: int, latency: int,
                    eof_in: int | None = None):
    """Streaming gate step, fused: (state, x) -> (new_state, y).

    A CPU tensor runs ``gate_step_ref``.  A CUDA float32 tensor launches
    the kernel: the FIR -> gate step's body without its FIR, a cluster of
    two CTAs per channel (one at nfft 8192) on batches of register
    Stockham transforms (analysis, noise floor, FIFO, mask and release,
    synthesis, OLA, emission), the positions passed as scalars;
    ``step_regs_geometry`` (``taps`` 0) sizes its segments and shared
    memory, and past nfft 8192 raises a ValueError naming SMEM_LIMIT.  Any
    other tensor raises.
    """
    kw = dict(nfft=nfft, hop=hop, threshold_db=threshold_db,
              reduction_db=reduction_db, noise_frames=noise_frames,
              release=release, window_kind=window_kind,
              input_latency=input_latency, latency=latency, eof_in=eof_in)
    if x.device.type == "cpu":
        return gate_step_ref(x, state, **kw)
    check_cuda_f32(x, "gate_step_fused", "GateStage routes float64 to its plain step")
    dev = x.device
    x2d, x_ld = rows_view(x)
    geo = step_regs_geometry(nfft, hop, 0, 0, x2d.shape[1], noise_frames, None,
                             step_cluster(nfft))
    out = torch.empty(x2d.shape, dtype=torch.float32, device=dev)
    args, new_state, _keep = gate_step_args(x2d, x_ld, state, out,
                                            scratch=not geo["pop_smem"], **kw)
    tabs = step_device_tables(nfft, hop, window_kind, dev)
    fargs = FirEnvArgs(None, None, None, tabs["twf"].data_ptr(), tabs["twi"].data_ptr(),
                       None, None, None, None, 0, 0, 0.0, geo["fs"], geo["pop_smem"],
                       *(geo[k] for k in STEP_OFFSETS))
    launch("gate step", kernel_fn("asp_gate_step", 2), ctypes.byref(args),
           ctypes.byref(fargs), geo["smem"], dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    gate_step_fused.launches += 1
    return new_state, out.reshape(x.shape)


gate_step_fused.launches = 0


def gate_step_info(nfft: int = 1024, hop: int = 256, block: int = 4096,
                   noise_frames: int = 8, release: float = 0.0, device=None) -> dict:
    """``gate_step_fused``'s kernel at this geometry on a CUDA device:
    ``regs_info`` (registers, local bytes, CTAs an SM) with the CTAs a
    channel, the frames a segment and shared memory of its launch."""
    cluster = step_cluster(nfft)
    geo = step_regs_geometry(nfft, hop, 0, 0, block, noise_frames, None, cluster)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_gate_step_info", nfft, release > 0.0, geo["smem"], dev),
                cluster=cluster, fs=geo["fs"], smem=geo["smem"])
