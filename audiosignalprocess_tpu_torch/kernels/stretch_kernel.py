"""The streaming phase-vocoder step (``pipeline.StretchStage``): the
hand-written kernel (``csrc/stretch_step_kernel.cu``, its body
``csrc/stretch_step_regs.cuh`` on batched register Stockham transforms),
its plain PyTorch version and the geometry both share.

Mirrors the JAX package's ``kernels/stretch_kernel.py`` and the plain
``StretchStage.step``.  One step takes a block of m = b/hop analysis
hops and emits mo = m*q/p synthesis hops: frame + window + rfft of the m
new frames, push into the analysis FIFO, capture of the first true
frame's unit rotor (z0), per synthesis frame u the FIFO slots (s0, s1) =
(slot_u, slot_u + 1) with the advance rotor unit(s1 conj s0) (neutral for
frames not emitted), the phase z0 * acc, the magnitude
(1 - frac_u)|s0| + frac_u|s1| and acc <- acc * rotor, then irfft,
window and WOLA overlap-add with the streaming norm (and the finite-file
ramp-out in a drained stream).

One carry layout serves the kernel and the plain step, and it is the JAX
package's plain-path carry (``pipeline.StretchStage.init_state``):
``in_tail`` (..., d), ``fifo_r``/``fifo_i`` (..., depth, nfft/2+1),
``z0r``/``z0i``/``accr``/``acci`` (..., 1, nfft/2+1) with ``accr`` = 1,
``ola_tail`` (..., d) and ``blk``, the block count, as a Python int, so
a step never reads the device.  A stream may switch between the kernel
and the plain step at any block.  The JAX fused step's grid-layout carry
(``gfifo_*``, ``gz0*``, ``gacc*`` over the four-step (n1, n2) spectrum)
has no counterpart.

Routing of ``stretch_step_fused``: a CPU tensor runs the plain version
(``stretch_step_ref``); a CUDA float32 tensor launches the kernel;
anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.phase_vocoder import _cmul, cumrotor, unit_rotor
from audiosignalprocess_tpu_torch.kernels._build import (
    SMEM_LIMIT, check_cuda_f32, kernel_fn, launch, rows_view,
)
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    _step_tables_np, regs_batch, regs_info, regs_one_buffer, regs_points, regs_threads,
    step_cluster, step_device_tables, wola_norm_at, wola_ola_emit,
)
from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.stft import frame
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check


@functools.lru_cache(maxsize=64)
def stretch_slots(m: int, p: int, q: int, n_skip: int, off: int):
    """Static FIFO geometry of a block of m analysis frames at rate p/q:
    (depth, slot[u], frac[u]) for its mo = m*q/p synthesis frames, the
    JAX package's ``StretchStage._slots``.  Python's floor division and
    modulo take (u - off)*p < 0 for the first ``off`` frames; ``frac`` is
    float64 (each caller rounds it to its dtype once)."""
    mo = m * q // p
    co = -(-(off * p) // q)  # ceil(off*p/q)
    depth = max(m + co - n_skip, 2)
    slots = [depth - m + n_skip + ((u - off) * p) // q for u in range(mo)]
    fracs = [(((u - off) * p) % q) / q for u in range(mo)]
    check(all(0 <= s and s + 1 < depth for s in slots),
          f"internal: FIFO slot out of range (m={m})")
    return depth, np.asarray(slots), np.asarray(fracs)


def stretch_step_init_state(batch: tuple, nfft: int, hop: int, depth: int,
                            dtype=torch.float32, device=None) -> dict:
    """The streaming stretch carry (see the module docstring): z0 = the
    first true frame's unit rotor, captured once; acc = the running
    product of advance rotors, neutral at the start."""
    d, nb = nfft - hop, nfft // 2 + 1
    z = lambda *shape: torch.zeros(batch + shape, dtype=dtype, device=device)
    return dict(in_tail=z(d), fifo_r=z(depth, nb), fifo_i=z(depth, nb),
                z0r=z(1, nb), z0i=z(1, nb),
                accr=torch.ones(batch + (1, nb), dtype=dtype, device=device),
                acci=z(1, nb), ola_tail=z(d), blk=0)


def stretch_step_masks(blk: int, m: int, mo: int, n_skip: int, off: int, nfft: int,
                       hop: int, eof_frames_out: int | None = None):
    """Position logic of one step, all host integers: the new frame that
    is the first true analysis frame (physical frame n_skip; -1 when it
    is not in this block), the synthesis frames [lo, hi) that are emitted
    (global index blk*mo + u - off >= 0 and, in a drained stream, below
    the oracle's frame count), the global index of the block's first
    synthesis frame and the whole-file synthesis length ``eof_out`` of a
    drained stream (None otherwise).  Returns (hit, lo, hi, i0, eof_out)."""
    hit = n_skip - blk * m
    i0 = blk * mo - off
    lo, hi, eof_out = min(max(-i0, 0), mo), mo, None
    if eof_frames_out is not None:
        hi = min(max(eof_frames_out - i0, lo), mo)
        eof_out = nfft + (eof_frames_out - 1) * hop
    return (hit if 0 <= hit < m else -1), lo, hi, i0, eof_out


def stretch_block_frames(b: int, hop: int, p: int, q: int) -> tuple[int, int]:
    """(m, mo): the analysis and synthesis frames of a block of b
    samples at rate p/q; raises unless b is on the hop grid and m*q/p
    is whole."""
    check(b % hop == 0 and b >= hop, f"block {b} not a multiple of hop={hop}")
    m = b // hop
    check((m * q) % p == 0, f"block frames {m} * q must be a multiple of p={p}")
    return m, m * q // p


def stretch_step_ref(x: torch.Tensor, state: dict, *, nfft: int, hop: int, p: int,
                     q: int, n_skip: int, off: int, window_kind: str,
                     eof_frames_out: int | None = None, impl: str = "torch"):
    """Plain PyTorch streaming stretch step: (state, x) -> (new_state, y),
    any device and dtype (the JAX package's plain ``StretchStage.step``).
    ``impl`` is the FFT implementation of its two transforms (``ops.fft``;
    the default pins torch.fft).  x (..., m*hop) -> y (..., mo*hop)."""
    m, mo = stretch_block_frames(x.shape[-1], hop, p, q)
    d = nfft - hop
    dtype, dev = x.dtype, x.device
    depth, slots, fracs = stretch_slots(m, p, q, n_skip, off)
    blk = int(state["blk"])
    hit, lo, hi, i0, eof_out = stretch_step_masks(blk, m, mo, n_skip, off, nfft, hop,
                                                  eof_frames_out)
    wv, head, const, tail = _step_tables_np(nfft, hop, window_kind)
    w = upload(wv, dtype, dev)
    ext = torch.cat([state["in_tail"], x], dim=-1)                  # (..., b+d)
    spec = fft_ops.rfft(frame(ext, nfft, hop) * w, impl=impl)       # (..., m, nb)
    spec_r, spec_i = spec.real, spec.imag
    z0r, z0i = state["z0r"], state["z0i"]
    if hit >= 0:  # capture z0 when the first true frame arrives
        fur, fui = unit_rotor(spec_r[..., hit : hit + 1, :], spec_i[..., hit : hit + 1, :])
        z0r, z0i = z0r + fur, z0i + fui
    fifo_r = torch.cat([state["fifo_r"], spec_r], dim=-2)[..., -depth:, :]
    fifo_i = torch.cat([state["fifo_i"], spec_i], dim=-2)[..., -depth:, :]
    sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    s0r, s0i = fifo_r.index_select(-2, sl), fifo_i.index_select(-2, sl)
    s1r, s1i = fifo_r.index_select(-2, sl + 1), fifo_i.index_select(-2, sl + 1)
    u = torch.arange(mo, device=dev)[:, None]
    emit = (u >= lo) & (u < hi)
    # advance rotors u = unit(s1 conj s0); frames not emitted are neutral
    ur, ui = unit_rotor(s1r * s0r + s1i * s0i, s1i * s0r - s1r * s0i)
    ur, ui = torch.where(emit, ur, 1.0), torch.where(emit, ui, 0.0)
    cr, ci = cumrotor(ur, ui)
    # exclusive prefix within the block, seeded by the carried rotor
    er = torch.cat([torch.ones_like(cr[..., :1, :]), cr[..., :-1, :]], dim=-2)
    ei = torch.cat([torch.zeros_like(ci[..., :1, :]), ci[..., :-1, :]], dim=-2)
    ar, ai = state["accr"], state["acci"]
    phr, phi = _cmul(z0r, z0i, *_cmul(ar, ai, er, ei))
    accr, acci = _cmul(ar, ai, cr[..., -1:, :], ci[..., -1:, :])
    f = upload(fracs, dtype, dev)[:, None]
    # hypot, not sqrt(r^2+i^2): the accuracy of |z| (the JAX package
    # measured ~4 dB of stream==full parity for the naive form)
    mag = ((1.0 - f) * torch.hypot(s0r, s0i) + f * torch.hypot(s1r, s1i)) * emit.to(dtype)
    out_frames = fft_ops.irfft(torch.complex(mag * phr, mag * phi), nfft, impl=impl) * w
    pvec = torch.arange(mo * hop, device=dev) + i0 * hop
    norm = wola_norm_at(pvec, upload(head, dtype, dev), const, d, eof_out,
                        upload(tail, dtype, dev))
    y, ola_tail = wola_ola_emit(out_frames, state["ola_tail"], hop, norm)
    return dict(in_tail=ext[..., -d:], fifo_r=fifo_r, fifo_i=fifo_i, z0r=z0r, z0i=z0i,
                accr=accr, acci=acci, ola_tail=ola_tail, blk=blk + 1), y


class StretchStepArgs(ctypes.Structure):
    """The stretch step's kernel arguments: ``struct StretchStepArgs`` of
    ``csrc/stretch_step_regs.cuh``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "x", "out", "in_tail", "fifo_r", "fifo_i", "z0r", "z0i", "accr", "acci",
            "ola_tail", "in_tail_out", "fifo_r_out", "fifo_i_out", "z0r_out", "z0i_out",
            "accr_out", "acci_out", "ola_tail_out", "slots", "fracs", "win", "twf", "twi",
            "inv_head", "inv_tail")]
        + [(name, ctypes.c_int) for name in (
            "channels", "x_ld", "nfft", "log2n", "hop", "m", "mo", "depth", "hit", "i0",
            "lo", "hi", "eof_out", "o_carry", "o_syn", "o_ex")]
        + [("inv_const", ctypes.c_float)])


_CARRY = ("in_tail", "fifo_r", "fifo_i", "z0r", "z0i", "accr", "acci", "ola_tail")


@functools.lru_cache(maxsize=32)
def slot_tables(m: int, p: int, q: int, n_skip: int, off: int, device: torch.device):
    """The kernel's per-geometry tables on ``device``, uploaded once:
    slot[u] (int32) and frac[u] (float64 rounded to float32 once, as the
    plain step rounds it)."""
    _, slots, fracs = stretch_slots(m, p, q, n_skip, off)
    return upload(slots, torch.int32, device), upload(fracs, torch.float32, device)


@functools.lru_cache(maxsize=64)
def stretch_regs_geometry(nfft: int, hop: int) -> dict:
    """Shared-memory offsets (floats) and bytes of the stretch step's body
    (``asp::stretch_step_regs``), in the order it carves them: z0 and acc
    (re and im, nfft/2+1 each), two OLA carries (nfft-hop each), the
    synthesis bins of a batch (2 planes of 2B (nfft/2+1); none at nfft
    8192, where the merged pass's thread of a bin runs the batch's two
    frames in registers), then the exchange buffers (two of 2 T R floats,
    one at 8192).  The analysis reads its frames from the block in device
    memory, so nothing depends on the block.  ``cluster``: CTAs a channel
    (``step_cluster``).  Past nfft 8192 a ValueError names SMEM_LIMIT."""
    nb, d = nfft // 2 + 1, nfft - hop
    one = regs_one_buffer(nfft)
    o_carry = 4 * nb
    o_syn = o_carry + 2 * d
    o_ex = o_syn + (0 if one else 2 * 2 * regs_batch(nfft) * nb)
    exchange = (1 if one else 2) * 2 * regs_threads(nfft) * regs_points(nfft)
    smem = 4 * (o_ex + exchange)
    check(smem <= SMEM_LIMIT, f"nfft={nfft}, hop={hop}: the stretch step needs {smem} bytes "
          f"of shared memory per block, more than SMEM_LIMIT ({SMEM_LIMIT} bytes)")
    return dict(o_carry=o_carry, o_syn=o_syn, o_ex=o_ex, cluster=step_cluster(nfft), smem=smem)


@kernel_wrapper
def stretch_step_fused(x: torch.Tensor, state: dict, *, nfft: int, hop: int, p: int,
                       q: int, n_skip: int, off: int, window_kind: str,
                       eof_frames_out: int | None = None):
    """Streaming stretch step, fused: (state, x) -> (new_state, y).

    A CPU tensor runs ``stretch_step_ref``.  A CUDA float32 tensor
    launches the kernel: a cluster of two CTAs per channel (one at nfft
    8192) runs the block's analysis (batches of register Stockham
    transforms, two frames a transform, the FIFO push, z0 capture), then
    its synthesis batches (the rotor recursion per bin in frame order, the
    inverse transforms, OLA, emission), with the positions passed as
    scalars and the slot/frac tables uploaded once per geometry
    (``stretch_regs_geometry`` sizes its shared memory; past nfft 8192 a
    ValueError names SMEM_LIMIT).  Any other tensor raises.
    """
    kw = dict(nfft=nfft, hop=hop, p=p, q=q, n_skip=n_skip, off=off,
              window_kind=window_kind, eof_frames_out=eof_frames_out)
    if x.device.type == "cpu":
        return stretch_step_ref(x, state, **kw)
    check_cuda_f32(x, "stretch_step_fused", "StretchStage routes float64 to its plain step")
    m, mo = stretch_block_frames(x.shape[-1], hop, p, q)
    check(nfft >= 4 and nfft & (nfft - 1) == 0, f"nfft={nfft} must be a power of two >= 4")
    check(nfft % hop == 0, f"hop={hop} must divide nfft={nfft}")
    geo = stretch_regs_geometry(nfft, hop)
    dev = x.device
    x2d, x_ld = rows_view(x)
    channels = x2d.shape[0]
    check(0 < channels <= 65535, f"{channels} channels: 1..65535 per launch")
    depth, _, _ = stretch_slots(m, p, q, n_skip, off)
    blk = int(state["blk"])
    hit, lo, hi, i0, eof_out = stretch_step_masks(blk, m, mo, n_skip, off, nfft, hop,
                                                  eof_frames_out)
    check((i0 + mo) * hop + nfft < 2 ** 31,
          f"stream position {(i0 + mo) * hop} past the kernel's 32-bit positions")
    cur = {k: state[k].contiguous() for k in _CARRY}
    check(all(v.dtype == torch.float32 and v.device == dev for v in cur.values()),
          "the stretch carry must be float32 on the input's device")
    check(cur["fifo_r"].shape[-2] == depth,
          f"carry FIFO depth {cur['fifo_r'].shape[-2]} != {depth} for blocks of {m} frames")
    new = {k: torch.empty_like(v) for k, v in cur.items()}
    out = torch.empty((channels, mo * hop), dtype=torch.float32, device=dev)
    tabs = step_device_tables(nfft, hop, window_kind, dev)
    slots, fracs = slot_tables(m, p, q, n_skip, off, dev)
    args = StretchStepArgs(
        x2d.data_ptr(), out.data_ptr(), *(cur[k].data_ptr() for k in _CARRY),
        *(new[k].data_ptr() for k in _CARRY), slots.data_ptr(), fracs.data_ptr(),
        *(tabs[k].data_ptr() for k in ("win", "twf", "twi", "inv_head", "inv_tail")),
        channels, x_ld, nfft, nfft.bit_length() - 1, hop, m, mo, depth, hit, i0, lo, hi,
        -1 if eof_out is None else eof_out, geo["o_carry"], geo["o_syn"], geo["o_ex"],
        tabs["inv_const"])
    launch("stretch step", kernel_fn("asp_stretch_step", 1), ctypes.byref(args), geo["smem"],
           dev.index, torch.cuda.current_stream(dev).cuda_stream)
    stretch_step_fused.launches += 1
    return dict(new, blk=blk + 1), out.reshape(x.shape[:-1] + (mo * hop,))


stretch_step_fused.launches = 0


def stretch_step_info(nfft: int = 1024, hop: int = 256, device=None) -> dict:
    """``stretch_step_fused``'s kernel at this geometry on a CUDA device:
    ``regs_info`` (registers, local bytes, CTAs an SM) with the CTAs a
    channel and shared memory of its launch."""
    geo = stretch_regs_geometry(nfft, hop)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(regs_info("asp_stretch_step_info", nfft, None, geo["smem"], dev),
                cluster=geo["cluster"], smem=geo["smem"])
