"""Polyphase rational resampler: the hand-written Hopper kernel
(``csrc/resample_kernel.cu``) and its plain PyTorch version.

Semantics of ``ops.resample.resample_poly`` (the oracle-pinned polyphase
convention, output ceil(n*up/down), or n*up/down with a streaming
``history``) and of the JAX package's ``kernels/resample_kernel.resample_mac``.

Routing: a CPU tensor runs ``resample_mac_ref``; a CUDA float32 tensor
launches the kernel; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels._build import (
    SMEM_LIMIT, check_cuda_f32, raise_on_error, rows_view,
)
from audiosignalprocess_tpu_torch.ops.resample import (
    phase_bank, reduce_ratio, resample_poly, stream_geometry, taps_per_phase,
)
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check

OUTPUTS = 8
"""Consecutive outputs a thread computes (``kQ`` of ``csrc/resample_kernel.cu``);
1 where the tap table and window of 8 do not fit in shared memory."""

PER_LANE = 2
"""Super-cycles a lane takes in a tile (``kP``): a tap broadcast feeds
PER_LANE * OUTPUTS outputs a lane; 1 where the channels have too few tiles
of PER_LANE * LANES super-cycles to fill the card."""

MIN_GROUPS = 8
"""Groups of OUTPUTS outputs a super-cycle at least: where one period of
the ratio has fewer (up < 8 * OUTPUTS), a super-cycle is k periods, so
that a CTA has warps enough to hide its window copies and a row's copy
overlaps the next row's less (1/2 of 64 x 480000 on an H100: 0.6045 ms at
1 group, 0.2205 at 4, 0.1381 at 8; PERF.md)."""

LANES = 32
"""Lanes of a warp (``kLanes``): a tile is LANES * p super-cycles."""

MAX_WARPS = 10
"""Warps a CTA at most (``kMaxThreads`` / 32); warp w takes groups w, w +
warps, ... of the CTA's range."""

SM_SMEM = 233472
"""Shared memory of an H100's SM (228 KB), 1 KB of it reserved a CTA."""

SM_WARPS = 64
"""Resident warps an H100's SM holds at most (2048 threads)."""

SM_CTAS = 32
"""Resident CTAs an H100's SM holds at most."""

SM_REGS = 65536
"""Registers of an H100's SM, in 4 sub-partitions."""

H100_SMS = 132
"""SMs of an H100 SXM: the geometry's default card."""

INSTANCES = ((OUTPUTS, PER_LANE), (OUTPUTS, 1), (1, 1))
"""The kernel's (q, p) instances, in the order the geometry tries them."""

REGISTERS = (64, 60, 48)
"""Registers a thread of each of INSTANCES as ptxas built them for sm_90a
(CUDA 12.8; chip_smoke's phase 13 prints them): the geometry's default.  On
the card the wrapper reads the built kernels' own (``_registers``)."""

GEO_FIELDS = ("x_ld", "hn", "n", "nout", "up", "down", "nk", "delay", "cyc", "raw",
              "groups", "range", "splits", "cols", "rs", "wl", "rows", "os", "strip", "tiles")
"""``ResMacGeo`` of ``csrc/resample_kernel.cu``, field by field."""


def res_window(count: int, up: int, down: int, nk: int) -> int:
    """Raw samples that ``count`` consecutive outputs read at most (the
    window ``asp::res_span`` stages)."""
    return -(-(count - 1) * down // up) + nk


def _newest(q, up: int, down: int, delay: int) -> np.ndarray:
    """floor((q*down + delay) / up): the newest raw sample output q reads."""
    return (np.asarray(q, dtype=np.int64) * down + delay) // up


def _layouts(raw: int, lsub: int, rows_n: int) -> list[tuple[int, int, int]]:
    """The window's layouts for a tile of ``rows_n`` super-cycles as (rows,
    rs, wl): a copied row a super-cycle padded to an odd stride, and the raw
    samples themselves at stride raw (3 floats of slack for the 16-byte
    alignment; a warp's reads hit 32 banks only where raw is odd)."""
    rs = lsub | 1
    return [(1, rs, rows_n * rs), (0, raw, -(-((rows_n - 1) * raw + lsub + 3) // 4) * 4)]


def _out_stride(width: int) -> int:
    """The tile's output rows' stride for ``width`` outputs a row: a multiple
    of 4 floats with an odd count of 16-byte words (a quarter warp's 16-byte
    writes at that stride touch 32 banks), or odd for 1 output a thread."""
    if width % 4:
        return width | 1
    return width + 4 if (width // 4) % 2 == 0 else width


def _strip(tiles: int, lines: int, slots: int) -> int:
    """Tiles a CTA walks: the fewest that put the ``lines`` (channels x
    group ranges) of ``tiles`` tiles each in one wave of ``slots`` CTAs,
    then evened out over the strips of a line (every tile a strip where the
    lines alone fill the wave)."""
    per_line = max(1, min(tiles, slots // lines))  # strips a line
    return -(-tiles // per_line)


def ctas_per_sm(threads: int, smem: int, regs: int) -> int:
    """Resident CTAs an H100's SM holds of ``threads`` threads, ``smem``
    bytes of dynamic shared memory and ``regs`` registers a thread, by the
    CUDA occupancy calculator's rules (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at the default carveout): at most SM_CTAS CTAs and SM_WARPS warps;
    shared memory in 128-byte units plus 1 KB a CTA out of SM_SMEM;
    registers in 256-register units a warp, each of the 4 sub-partitions
    holding the warps its quarter of SM_REGS takes."""
    warps = -(-threads // 32)
    by_smem = SM_SMEM // (-(-smem // 128) * 128 + 1024)
    by_regs = SM_REGS // 4 // (-(-regs * 32 // 256) * 256) * 4 // warps
    return max(1, min(SM_CTAS, SM_WARPS // warps, by_smem, by_regs))


def _warps(rng: int) -> int:
    """Warps for a range of ``rng`` groups: the most, up to MAX_WARPS, of the
    best balanced (4 to MAX_WARPS where rng allows, groups spread evenly)."""
    if rng <= 4:
        return rng
    return max(range(4, MAX_WARPS + 1), key=lambda w: (rng / (w * -(-rng // w)), w))


@functools.lru_cache(maxsize=256)
def resample_geometry(channels: int, nout: int, up: int, down: int, nk: int, delay: int,
                      sms: int = H100_SMS, regs: tuple[int, ...] = REGISTERS) -> dict:
    """The launch of ``resample_mac_kernel`` for ``channels`` rows of ``nout``
    outputs at the reduced ratio up/down with nk taps a phase.

    A super-cycle is ``cyc`` = k*up outputs (k the least multiple of 1,
    or of lcm(up, q)/up below q, that gives 8 outputs a thread MIN_GROUPS
    groups) reading ``raw`` = k*down raw samples; a tile is LANES * p of them,
    lane l taking l + LANES*i (i < p); a group is q consecutive outputs of a
    super-cycle, walking ``cols`` columns of the window.  A CTA takes
    ``range`` groups and a strip of ``strip`` tiles of one channel: where
    the channels have 2 tiles an SM or more the groups stay whole and the
    strips make one wave of the CTAs the SMs hold, else the groups are
    split over CTAs until 2 CTAs an SM.  Then the largest range that fits
    SMEM_LIMIT with the tile's outputs (a row of ``os`` floats a
    super-cycle; none where a channel is one tile, stored from registers),
    and in it the window layout that keeps the reads bank-conflict free and
    lets the most CTAs share an SM (``ctas_per_sm`` with the instance's
    ``regs``, one of each of INSTANCES: ``per_sm``), then the least shared
    memory; (q, p) = (OUTPUTS, PER_LANE) where the channels have 2 * sms
    tiles of it, else (OUTPUTS, 1), else (1, 1); a ValueError names
    SMEM_LIMIT where none fits.  Each of the ``ctas`` CTAs reads its
    range's taps of the bank once."""
    check(nout >= 1 and 0 < channels <= 65535 and up >= 1 and down >= 1 and nk >= 1,
          f"resample_geometry takes 1..65535 channels of >= 1 output, got "
          f"({channels}, {nout}) at {up}/{down}, nk {nk}")
    for (q, p), reg in zip(INSTANCES, regs):
        k = k0 = 1 if up >= q else math.lcm(up, q) // up
        while q == OUTPUTS and -(-k * up // q) < MIN_GROUPS:
            k += k0
        cyc, raw = k * up, k * down
        tiles = -(-(-(-nout // cyc)) // (LANES * p))
        lines = channels * tiles
        if p > 1 and lines < 2 * sms:
            continue
        groups = -(-cyc // q)
        first = np.arange(groups) * q
        m_first = _newest(first, up, down, delay)
        m_last = _newest(np.minimum(first + q, cyc) - 1, up, down, delay)
        cols = -(-(int((m_last - m_first).max()) + nk) // 4) * 4
        rng = groups if lines >= 2 * sms else -(-groups // min(groups, -(-2 * sms // lines)))
        while True:
            splits = -(-groups // rng)
            starts = np.arange(splits) * rng
            ends = np.minimum(starts + rng, groups) - 1
            lsub = int((m_first[ends] - m_first[starts]).max()) + cols
            os_ = _out_stride(rng * q) if tiles > 1 else 0  # one tile: no row buffer
            warps = _warps(rng)
            need = -(-lines * splits // sms)  # CTAs an SM the work can fill at all
            fits = []  # (bank conflict free, CTAs an SM, -smem): the best last
            for rows, rs, wl in _layouts(raw, lsub, LANES * p):
                smem = 4 * (rng * q * cols + -(-rng // 4) * 4 + wl + LANES * p * os_)
                if smem <= SMEM_LIMIT:
                    per_sm = ctas_per_sm(32 * warps, smem, reg)
                    fits.append(((bool(rows or raw % 2), min(per_sm, need), -smem),
                                 (rows, rs, wl, smem, per_sm)))
            if fits:
                rows, rs, wl, smem, per_sm = max(fits)[1]
                strip = _strip(tiles, channels * splits, per_sm * sms)
                ctas = channels * -(-tiles // strip) * splits
                return dict(q=q, p=p, threads=32 * warps, smem=smem, ctas=ctas, per_sm=per_sm,
                            nout=nout, up=up, down=down, nk=nk, delay=delay, cyc=cyc, raw=raw,
                            groups=groups, range=rng, splits=splits, cols=cols, rs=rs, wl=wl,
                            rows=rows, os=os_, strip=strip, tiles=tiles)
            if rng == 1:
                break
            rng = -(-rng // 2)
    smem = 4 * (nk + min(wl for _, _, wl in _layouts(down, -(-nk // 4) * 4, LANES)))
    raise ValueError(f"{up}/{down} with {nk} taps a phase needs {smem} bytes of shared "
                     f"memory per block, more than SMEM_LIMIT ({SMEM_LIMIT})")


@functools.lru_cache(maxsize=32)
def bank_table(h_bytes: bytes, up: int, device: torch.device) -> torch.Tensor:
    """The (up, nk) phase bank with each phase's taps reversed, float32 on
    ``device``, uploaded once per filter (a copy: with one tap a phase the
    reversed view has a negative stride that numpy still calls contiguous)."""
    h = np.frombuffer(h_bytes, dtype=np.float64)
    return upload(phase_bank(h, up)[:, ::-1].copy(), torch.float32, device)


def resample_mac_ref(x: torch.Tensor, up: int, down: int, h=None,
                     zero_phase: bool = True,
                     history: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``ops.resample.resample_poly``, any device
    and dtype."""
    return resample_poly(x, up, down, h=h, zero_phase=zero_phase, history=history)


@functools.cache
def _lib():
    fn = _build.load().asp_resample_mac
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _info(q: int, p: int, threads: int, smem: int, index: int) -> tuple[int, int, int]:
    """(registers a thread, local bytes a thread, resident CTAs an SM by the
    occupancy API) of the built (q, p) instance at that launch."""
    fn = _build.load().asp_resample_mac_info
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 3)()
    raise_on_error(fn(q, p, threads, smem, index, info), "asp_resample_mac_info")
    return info[0], info[1], info[2]


@functools.cache
def _registers(index: int) -> tuple[int, ...]:
    """Registers a thread of each of INSTANCES as built: ``resample_geometry``'s
    ``regs`` on the card."""
    return tuple(_info(q, p, 32, 0, index)[0] for q, p in INSTANCES)


def resample_mac(x: torch.Tensor, up: int, down: int, h=None,
                 zero_phase: bool = True,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Rational resample on the last axis via the polyphase MAC kernel.

    A CPU tensor runs ``resample_mac_ref``.  A CUDA float32 tensor
    launches the kernel (``resample_geometry``): a CTA builds the tap table
    of its groups once and walks a strip of tiles, 8 consecutive outputs a
    thread in registers, the next tile's raw window copied in while this
    one's MAC runs, the outputs stored from shared memory in bulk copies.
    Any other tensor raises.
    """
    if x.device.type == "cpu":
        return resample_mac_ref(x, up, down, h, zero_phase, history)
    check_cuda_f32(x, "resample_mac", "ResampleStage routes float64 to the plain resample_poly")
    up, down, h = reduce_ratio(up, down, h)
    if h is None:
        return x
    x2d, x_ld = rows_view(x)
    channels, n = x2d.shape
    hn, nout = stream_geometry(n, up, down, len(h), history, zero_phase)
    check(nout >= 1 and 0 < channels <= 65535,
          f"resample_mac takes 1..65535 channels of >= 1 output, got {tuple(x2d.shape)}")
    hist = None
    if history is not None and hn:
        hist = history.reshape(channels, hn).contiguous()
        check(hist.dtype == torch.float32 and hist.device == x.device,
              "history must be float32 on the input's device")
    dev = x.device
    geo = resample_geometry(channels, nout, up, down, taps_per_phase(len(h), up),
                            (len(h) - 1) // 2 if zero_phase else 0, _sms(dev.index),
                            _registers(dev.index))
    args = dict(geo, x_ld=x_ld, hn=hn, n=n)
    y = torch.empty((channels, nout), dtype=torch.float32, device=dev)
    rc = _lib()(x2d.data_ptr(), None if hist is None else hist.data_ptr(), y.data_ptr(),
                bank_table(h.tobytes(), up, dev).data_ptr(),
                (ctypes.c_int * len(GEO_FIELDS))(*(args[f] for f in GEO_FIELDS)),
                geo["q"], geo["p"], channels, geo["threads"], geo["smem"], dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "resample_mac")
    resample_mac.launches += 1
    return y.reshape(x.shape[:-1] + (nout,))


resample_mac.launches = 0


def resample_mac_info(up: int = 160, down: int = 147, taps: int | None = None,
                      channels: int = 64, nout: int = 480000, zero_phase: bool = False,
                      device: torch.device | None = None) -> dict:
    """The built kernel at that launch (the headline's by default), from the
    CUDA runtime: registers a thread, local memory bytes a thread (spills)
    and resident CTAs an SM by the occupancy API (``ctas``), beside the
    geometry's own count (``per_sm``, which sizes the strips), the launch's
    outputs and super-cycles a thread, threads, shared memory and CTAs."""
    dev = torch.device("cuda") if device is None else device
    index = dev.index or 0
    up, down, h = reduce_ratio(up, down, None if taps is None else np.ones(taps))
    geo = resample_geometry(channels, nout, up, down, taps_per_phase(len(h), up),
                            (len(h) - 1) // 2 if zero_phase else 0, _sms(index),
                            _registers(index))
    regs, local, ctas = _info(geo["q"], geo["p"], geo["threads"], geo["smem"], index)
    return dict(registers=regs, local_bytes=local, ctas=ctas, per_sm=geo["per_sm"], q=geo["q"],
                p=geo["p"], threads=geo["threads"], smem=geo["smem"], grid=geo["ctas"])
