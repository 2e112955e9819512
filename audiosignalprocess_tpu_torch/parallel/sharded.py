"""Sharded whole-file operators over a (channel, time) mesh of processes,
whose outputs equal the unsharded ops.

The JAX package's ``parallel/sharded.py`` builds shard_map programs; here
each ``sharded_*`` returns a callable on this rank's block
(``mesh.shard_audio``) that returns this rank's block of the output
(``mesh.gather_audio`` reassembles it).  Every rank calls it together.

- Causal filters (FIR, overlap-save, resampler, envelope): a left halo of
  the filter history, the streaming carry spatialized, fed to the ops'
  ``history=``.
- STFT effects: a right halo of nfft-hop samples for frame assembly, then
  an overlap-add fix-up that adds each shard's spill into its right
  neighbour; the noise floor (a statistic of the file's first frames) is
  time shard 0's, broadcast over the row.  The vocoder's phase prefix
  crosses shards through an all_gather of per-shard rotor totals.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import gate_mask
from audiosignalprocess_tpu_torch.effects.phase_vocoder import cumrotor, unit_rotor
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    gate_shard_fused, noise_floor, noise_gate_fused,
)
from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.fir import fir_direct
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.resample import history_len, resample_filter, resample_poly
from audiosignalprocess_tpu_torch.ops.stft import _wola_norm, frame, overlap_add
from audiosignalprocess_tpu_torch.ops.windows import window
from audiosignalprocess_tpu_torch.parallel.halo import (
    all_gather, broadcast_first, halo_left, halo_right, send_right_add,
)
from audiosignalprocess_tpu_torch.parallel.mesh import Mesh
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.profiling import span
from audiosignalprocess_tpu_torch.utils.validate import check


def _check_halo(halo: int, local_len: int) -> None:
    """The halo exchange is single-hop: the history must fit in ONE
    neighbour shard, else a slice would silently fabricate history."""
    check(halo <= local_len, f"halo {halo} exceeds local shard length {local_len}: use fewer "
          f"time shards or a shorter filter (single-hop halo exchange)")


def _f32_kernel(fused: bool, x: torch.Tensor) -> bool:
    """The kernels compute in float32: float64 takes the plain path, as the
    stages route it."""
    return fused and x.dtype != torch.float64


# ---------------------------------------------------------------------------
# causal filters: left halo == spatialized streaming carry
# ---------------------------------------------------------------------------

def sharded_fir(mesh: Mesh, h, fused: bool = False):
    """(C, N) -> (C, N) causal FIR == ``ops.fir.fir_direct``, sharded."""
    h = np.asarray(h, np.float64)
    t = len(h)

    def local(x):
        _check_halo(t - 1, x.shape[-1])
        ext = halo_left(x, t - 1, mesh)
        return fir_direct(x, h, history=ext[..., : t - 1], fused=_f32_kernel(fused, x))

    return local


def sharded_overlap_save(mesh: Mesh, h, nfft: int, impl: str = fft_ops.DEFAULT_IMPL,
                         fused: bool = False):
    """(C, N) -> (C, N) causal FIR by overlap-save with halo exchange
    (config 4).  ``fused=True`` runs ``overlap_save_fused`` per shard, the
    halo as its history."""
    h = np.asarray(h, np.float64)
    t = len(h)

    def local(x):
        _check_halo(t - 1, x.shape[-1])
        ext = halo_left(x, t - 1, mesh)
        return overlap_save(x, h, nfft, history=ext[..., : t - 1], impl=impl,
                            fused=_f32_kernel(fused, x))

    return local


def sharded_resample(mesh: Mesh, up: int, down: int, h=None, fused: bool = False):
    """(C, N) -> (C, N*up/down) causal polyphase resample, halo'd."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    h = np.asarray(resample_filter(up, down) if h is None else h, np.float64)
    hl = history_len(len(h), up, down)

    def local(x):
        check(x.shape[-1] % down == 0,
              f"local shard length {x.shape[-1]} must be a multiple of "
              f"down={down} (integral resampled length per shard)")
        _check_halo(hl, x.shape[-1])
        ext = halo_left(x, hl, mesh)
        return resample_poly(x, up, down, h=h, zero_phase=False, history=ext[..., :hl],
                             fused=_f32_kernel(fused, x))

    return local


# ---------------------------------------------------------------------------
# the sharded spectral noise gate
# ---------------------------------------------------------------------------

def _gate_norms(nfft: int, hop: int, window_kind: str):
    """(head ramp (d), tail ramp (d), interior constant) of the whole-file
    WOLA norm, sliced from ``ops.stft._wola_norm`` of an output long
    enough to have an interior."""
    d = nfft - hop
    norm = _wola_norm(2 * (nfft // hop), nfft, hop, window_kind)
    return norm[:d].copy(), norm[-d:].copy(), float(norm[d])


def _spill_and_norm(acc, t, l_out, d, out_len, norms, mesh):
    """The sharded WOLA epilogue (gate and vocoder): add the d-sample OLA
    spill into the right neighbour's head, then divide by the whole-file
    WOLA norm at global positions (head ramp, interior, the finite file's
    tail ramp, 1.0 in the zero pad past ``out_len``, the global synthesis
    length).  ``acc`` holds l_out + d locally accumulated samples."""
    with span("asp.spill_and_norm"):
        head, tail, const = norms
        num_head = send_right_add(acc[..., l_out : l_out + d], acc[..., :d], mesh)
        num = torch.cat([num_head, acc[..., d:l_out]], dim=-1)
        p = t * l_out + np.arange(l_out)
        norm = np.where(p < d, head[np.clip(p, 0, d - 1)],
                        np.where(p < out_len - d, const,
                                 np.where(p < out_len,
                                          tail[np.clip(p - (out_len - d), 0, d - 1)], 1.0)))
        return num / upload(norm, acc.dtype, acc.device)


def gate_shard_body(x: torch.Tensor, mesh: Mesh, nfft: int, hop: int, threshold_db: float,
                    reduction_db: float, noise_frames: int, window_kind: str,
                    impl: str = fft_ops.DEFAULT_IMPL, release: float = 0.0,
                    fused: bool = False) -> torch.Tensor:
    """The gate of one (channel, time) shard: ``GateStage.full`` restricted
    to this shard's samples (the file's last nfft-hop samples zero).

    ``fused=True`` (float32, release 0) runs the frame/FFT/mask/IFFT/OLA
    of the shard as one ``gate_shard_fused``, the cross-shard parts around
    it: the floor from shard 0's first frames by ``noise_gate_fused``'s own
    prologue, the validity of frames against the file's end, the spill
    exchange and the norm at global positions.  Float64 and release > 0
    take the plain body; release crosses shards through an all_gather of
    each shard's last mask frame.
    """
    dtype, dev = x.dtype, x.device
    d = nfft - hop
    l = x.shape[-1]
    check(l % hop == 0 and l >= nfft, "shard length must be >= nfft, hop-aligned")
    check(l // hop >= noise_frames, f"shard 0 holds {l // hop} frames < noise_frames="
          f"{noise_frames}: the noise floor lives on the first shard (use longer shards)")
    n_sh, t = mesh.time, mesh.t
    n_glob = l * n_sh
    n_frames_glob = 1 + (n_glob - nfft) // hop
    check(n_frames_glob * hop >= 2 * d, "signal too short: WOLA head and tail ramps overlap")
    check(n_frames_glob >= noise_frames,
          f"signal has {n_frames_glob} frames < noise_frames={noise_frames}")
    norms = _gate_norms(nfft, hop, window_kind)
    out_len = nfft + (n_frames_glob - 1) * hop
    w = window(window_kind, nfft, periodic=True, dtype=dtype, device=dev)
    ext = halo_right(x, d, mesh)
    m = l // hop
    # frames that end inside the file: a prefix of the shard's frames
    n_valid = min(max((n_glob - nfft - t * l) // hop + 1, 0), m)
    if _f32_kernel(fused, x):
        check(release == 0.0, "fused sharded gate requires release == 0")
        # shard 0's first frames, sliced from the halo-extended signal so
        # that short shards work (ext holds l + d >= d + noise_frames*hop)
        floor = broadcast_first(
            noise_floor(frame(ext[..., : d + noise_frames * hop], nfft, hop) * w), mesh)
        acc = gate_shard_fused(ext, floor, n_valid, nfft, hop, threshold_db, reduction_db,
                               window_kind)
        return _spill_and_norm(acc, t, l, d, out_len, norms, mesh)
    valid = upload((np.arange(m) < n_valid).astype(np.float64), dtype, dev)[:, None]
    spec = fft_ops.rfft(frame(ext, nfft, hop) * w, impl=impl) * valid
    mag = spec.abs()
    floor = broadcast_first(mag[..., :noise_frames, :].mean(dim=-2, keepdim=True), mesh)
    mask = gate_mask(mag, floor, threshold_db, reduction_db, release)
    if release > 0.0 and n_sh > 1:
        # the scan s_q = max(mask_q, r*s_{q-1}) factors over shards: with
        # L_j shard j's last locally scanned frame, the carry into shard t
        # is C = max_{j<t} L_j * r^(m*(t-1-j)); the corrected local scan is
        # max(s_q, C * r^(q+1))
        last = all_gather(mask[..., -1:, :], mesh.time_group, mesh.backend)
        carry = torch.zeros_like(last[0])
        for j in range(t):
            carry = torch.maximum(carry, last[j] * (release ** m) ** (t - 1 - j))
        pows = upload(release ** np.arange(1, m + 1, dtype=np.float64), dtype, dev)[:, None]
        mask = torch.maximum(mask, pows * carry)
    acc = overlap_add(fft_ops.irfft(spec * mask, nfft, impl=impl) * w, hop)
    return _spill_and_norm(acc, t, l, d, out_len, norms, mesh)


def sharded_noise_gate(mesh: Mesh, nfft: int = 1024, hop: int = 256,
                       threshold_db: float = 6.0, reduction_db: float = 60.0,
                       noise_frames: int = 8, window_kind: str = "hann",
                       impl: str = fft_ops.DEFAULT_IMPL, release: float = 0.0,
                       fused: bool = False):
    """(C, N) -> (C, N) spectral noise gate == ``GateStage.full``, sharded
    (configs 3 and 5).  ``fused=True`` runs the kernels on float32: with no
    time sharding the whole-file ``noise_gate_fused`` (each rank holds whole
    signals), with time sharding ``gate_shard_fused`` per shard (the plain
    body when release > 0)."""

    def local(x):
        if _f32_kernel(fused, x) and mesh.time == 1:
            y = noise_gate_fused(x, nfft, hop, threshold_db, reduction_db, noise_frames,
                                 release, window_kind)
            return torch.nn.functional.pad(y, (0, x.shape[-1] - y.shape[-1]))
        return gate_shard_body(x, mesh, nfft, hop, threshold_db, reduction_db, noise_frames,
                               window_kind, impl, release=release,
                               fused=fused and release == 0.0)

    return local


# ---------------------------------------------------------------------------
# the sharded phase-vocoder time stretch
# ---------------------------------------------------------------------------

def stretch_shard_body(x: torch.Tensor, mesh: Mesh, p: int, q: int, nfft: int, hop: int,
                       window_kind: str = "hann",
                       impl: str = fft_ops.DEFAULT_IMPL) -> torch.Tensor:
    """Phase-vocoder time stretch of one shard at the exact rational rate
    p/q: ``StretchStage.full`` restricted to this shard's output.

    One frame of right halo covers every interpolation pair (the local
    slot (u*p)//q never passes m-1); the synthesis phase, a prefix product
    of rotors over all synthesis frames, takes the earlier shards' rotor
    totals from one all_gather; the first frame's rotor z0 is shard 0's,
    broadcast.  The OLA spill rides the gate's ``send_right_add``.
    """
    dtype, dev = x.dtype, x.device
    d = nfft - hop
    l = x.shape[-1]
    check(l % hop == 0 and l >= nfft, "shard length must be >= nfft, hop-aligned")
    m = l // hop
    check((m * q) % p == 0, f"shard frames {m} * q must be a multiple of p={p}")
    mo = m * q // p
    check(mo >= nfft // hop, f"shard emits {mo} synthesis frames < nfft/hop={nfft // hop}")
    n_sh, t = mesh.time, mesh.t
    nf_glob = 1 + (l * n_sh - nfft) // hop
    nof = (((nf_glob - 1) * q - 1) // p) + 1
    w = window(window_kind, nfft, periodic=True, dtype=dtype, device=dev)
    spec = fft_ops.rfft(frame(halo_right(x, nfft, mesh), nfft, hop) * w, impl=impl)
    z0 = broadcast_first(torch.stack(unit_rotor(spec[..., 0:1, :].real,
                                                spec[..., 0:1, :].imag)), mesh)
    u = np.arange(mo)
    ks = torch.as_tensor((u * p) // q, device=dev)
    s0, s1 = spec.index_select(-2, ks), spec.index_select(-2, ks + 1)
    emit = upload((t * mo + u < nof).astype(np.float64), dtype, dev)[:, None]
    ur, ui = unit_rotor(s1.real * s0.real + s1.imag * s0.imag,
                        s1.imag * s0.real - s1.real * s0.imag)
    # frames past the file's end are neutral, so shard products compose
    ur = torch.where(emit > 0, ur, 1.0)
    ui = torch.where(emit > 0, ui, 0.0)
    cr, ci = cumrotor(ur, ui)
    totals = all_gather(torch.stack([cr[..., -1:, :], ci[..., -1:, :]]), mesh.time_group,
                        mesh.backend) if n_sh > 1 else []
    carr, cari = torch.ones_like(cr[..., -1:, :]), torch.zeros_like(ci[..., -1:, :])
    for j in range(t):
        br, bi = totals[j]
        carr, cari = carr * br - cari * bi, carr * bi + cari * br
    er = torch.cat([torch.ones_like(cr[..., :1, :]), cr[..., :-1, :]], dim=-2)
    ei = torch.cat([torch.zeros_like(ci[..., :1, :]), ci[..., :-1, :]], dim=-2)
    z0r, z0i = z0
    sr, si = z0r * carr - z0i * cari, z0r * cari + z0i * carr
    phr, phi = sr * er - si * ei, sr * ei + si * er
    frac = upload(((u * p) % q) / q, dtype, dev)[:, None]
    mag = ((1.0 - frac) * s0.abs() + frac * s1.abs()) * emit
    acc = overlap_add(fft_ops.irfft(torch.complex(mag * phr, mag * phi), nfft, impl=impl)
                      * w, hop)
    return _spill_and_norm(acc, t, mo * hop, d, nfft + (nof - 1) * hop,
                           _gate_norms(nfft, hop, window_kind), mesh)


def sharded_time_stretch(mesh: Mesh, p: int, q: int, nfft: int = 1024, hop: int = 256,
                         window_kind: str = "hann", impl: str = fft_ops.DEFAULT_IMPL):
    """(C, N) -> (C, N*q/p) phase-vocoder stretch == ``StretchStage.full``,
    sharded."""

    def local(x):
        return stretch_shard_body(x, mesh, p, q, nfft, hop, window_kind, impl)

    return local


# ---------------------------------------------------------------------------
# the sharded whole-file chain
# ---------------------------------------------------------------------------

def _components(chain) -> list:
    """The chain's stages with each composite split into its components:
    across shards the halo and broadcast structure is the components'.  The
    components carry the composite's ``fused`` and ``impl``, as the JAX
    package's do.  A folded envelope becomes its direct-form FIR (|x| halo
    + MAC): the overlap-save form takes no abs."""
    from audiosignalprocess_tpu_torch.pipeline import FIRGateStage, FIRStage, ResFIRGateStage

    def env_direct(fg):
        return FIRStage(h=fg._env.h, pre="abs", post_scale=fg._env.post_scale,
                        fused=fg.fused)

    stages = []
    for s in chain.stages:
        fg = s._fg if isinstance(s, ResFIRGateStage) else s
        if isinstance(s, ResFIRGateStage):
            stages.append(s._res)
        if isinstance(fg, FIRGateStage):
            stages += [fg._fir, fg._gate] + ([env_direct(fg)] if fg._env is not None else [])
        else:
            stages.append(s)
    return stages


def chain_shard_body(chain, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A ``pipeline.Chain`` on one (channel, time) shard with halos:
    ``chain.full(x)`` restricted to this shard."""
    from audiosignalprocess_tpu_torch.pipeline import (
        FIRStage, GateStage, ResampleStage, StretchStage,
    )

    for s in _components(chain):
        with span(s.span_shard):
            if isinstance(s, FIRStage):
                t = len(s.h)
                src = x.abs() if s.pre == "abs" else x
                _check_halo(t - 1, src.shape[-1])
                hist = halo_left(src, t - 1, mesh)[..., : t - 1]
                if s.nfft is not None:
                    check(s.pre is None, "abs-pre + overlap-save not supported")
                    x = overlap_save(x, s.h, s.nfft, history=hist, impl=s.impl,
                                     fused=_f32_kernel(s.fused, x))
                else:
                    x = fir_direct(src, s.h, history=hist, fused=_f32_kernel(s.fused, x))
                if s.post_scale != 1.0:
                    x = x * s.post_scale
            elif isinstance(s, ResampleStage):
                hl = history_len(len(s.h), s.up, s.down)
                _check_halo(hl, x.shape[-1])
                x = resample_poly(x, s.up, s.down, h=s.h, zero_phase=False,
                                  history=halo_left(x, hl, mesh)[..., :hl],
                                  fused=_f32_kernel(s.fused, x))
            elif isinstance(s, GateStage):
                x = gate_shard_body(x, mesh, s.nfft, s.hop, s.threshold_db, s.reduction_db,
                                    s.noise_frames, s.window_kind, s.impl, release=s.release,
                                    fused=s.fused and s.release == 0.0)
            elif isinstance(s, StretchStage):
                x = stretch_shard_body(x, mesh, s.p, s.q, s.nfft, s.hop, s.window_kind, s.impl)
            else:
                raise NotImplementedError(f"sharded chain stage: {type(s).__name__}")
    return x


def sharded_chain(mesh: Mesh, chain):
    """Sharded whole-file execution of a ``pipeline.Chain`` ==
    ``chain.full(x)``."""

    def local(x):
        with span("asp.sharded_chain"):
            return chain_shard_body(chain, x, mesh)

    return local
