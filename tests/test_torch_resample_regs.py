"""The host side of the redesigned resample_mac (``csrc/resample_kernel.cu``,
``kernels/resample_kernel.resample_geometry``), on the CPU.

- A float32 numpy model of the kernel with an exact fmaf: every CTA of
  ``resample_geometry``'s grid (its range of groups, its strip of tiles)
  builds the tap table with the kernel's stepped phases and newest raw
  indices (checked against the division at every slot) into NaN-filled
  shared memory, stages each tile's raw window in the geometry's layout (a
  copied row a super-cycle, or the raw samples at stride D, 16-byte aligned
  like x's words) into a NaN-filled buffer, and runs each group's union
  walk, lane l on super-cycles l + 32 i of the tile (i < p), kQ outputs a
  thread, the columns in order, into the tile's NaN-filled rows of outputs,
  each row's run then copied to a NaN-filled output whose every position is
  written once.  It is bit
  for bit the plain fmaf chains in tap order (``resample_fmaf_reference``)
  and reads >= 100 dB against the JAX ``resample_mac`` (Pallas in interpret
  mode, ``cycle_tile=32`` as ``tests/kernels/test_fuzz_params.py`` runs it)
  at 160/147, 147/160, 1/2, 2/1, 3/4, pitch_shift's 37/44 and the eight
  ratios of ``test_fuzz_params._cases_rs``, zero-phase, causal and with a
  history, under the card's geometry and under one that keeps whole group
  ranges, strips of several tiles, two super-cycles a lane and the
  contiguous window.
- Exhaustive bank check: every window read of a warp touches 32 banks (one
  wavefront) in every conflict-free layout; the tap reads are one address
  a warp (broadcasts).  The prototype filter comes from a cache; the phase
  bank takes filters of one tap a phase.
- ``resample_geometry`` at the headline (64 x 441000 -> 480000) and at path
  D's block (64 x 4704 + 147 -> 64 x 5120): the bank loads and CTAs the
  kernel's note states; a whole file's grid is one wave of the CTAs an SM
  holds (``ctas_per_sm``: registers, warps, shared memory, 32 CTAs); every
  ratio and tap count the retired kernel's shared-memory check admitted
  still fits.
"""

import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

from audiosignalprocess_tpu.kernels.resample_kernel import resample_mac as jax_resample_mac
from audiosignalprocess_tpu_torch.kernels import resample_kernel as rk
from audiosignalprocess_tpu_torch.kernels._build import CSRC, SMEM_LIMIT
from audiosignalprocess_tpu_torch.ops.resample import (
    history_len, phase_bank, reduce_ratio, resample_filter, stream_geometry, taps_per_phase,
)

from torch_fmaf import fmaf32, resample_fmaf_reference


def _newest(q, up, down, delay):
    return (q * down + delay) // up


def mac_model(x, up, down, h=None, zero_phase=True, hist=None, sms=rk.H100_SMS):
    """resample_mac_kernel on float32 x (C, n), rows contiguous from a
    16-byte boundary; returns (y, geometry, the warps' window addresses)."""
    x = np.asarray(x, np.float32)
    up, down, h = reduce_ratio(up, down, h)
    n_ch, n = x.shape
    nk = taps_per_phase(len(h), up)
    hn, nout = stream_geometry(n, up, down, len(h), hist, zero_phase)
    delay = (len(h) - 1) // 2 if zero_phase else 0
    geo = rk.resample_geometry(n_ch, nout, up, down, nk, delay, sms)
    q, per, nt = geo["q"], geo["p"], geo["threads"]
    rows_n = rk.LANES * per  # super-cycles a tile: lane l takes l + LANES i, i < p
    cyc, raw_d, cols, rs, wl = geo["cyc"], geo["raw"], geo["cols"], geo["rs"], geo["wl"]
    rng, splits, strip, tiles = geo["range"], geo["splits"], geo["strip"], geo["tiles"]
    os_ = geo["os"]
    assert geo["smem"] == 4 * (rng * q * cols + -(-rng // 4) * 4 + wl + rows_n * os_)
    assert geo["smem"] <= SMEM_LIMIT and nt % 32 == 0 and nt <= 32 * rk.MAX_WARPS
    assert (os_ == 0) == (tiles == 1)
    assert os_ == 0 or (rng * q <= os_ and (os_ % 8 == 4 if q % 4 == 0 else os_ % 2 == 1))
    bank = np.ascontiguousarray(phase_bank(h, up)[:, ::-1]).astype(np.float32).reshape(-1)
    h32 = None if hist is None else np.asarray(hist, np.float32)

    def raw(c, r):  # RawSrc: [hist | x], zeros elsewhere
        in_x = (r >= 0) & (r < n)
        out = np.where(in_x, x[c, np.clip(r, 0, n - 1)], np.float32(0))
        if h32 is not None and hn:
            in_h = (r < 0) & (r >= -hn)
            out = np.where(in_h, h32[c, np.clip(hn + r, 0, hn - 1)], out)
        return out.astype(np.float32)

    y = np.full((n_ch, nout), np.nan, np.float32)
    written = np.zeros((n_ch, nout), np.int64)
    lanes = np.arange(rk.LANES)
    reads = []
    for bx in range(-(-tiles // strip) * splits):
        g0, t0 = (bx % splits) * rng, (bx // splits) * strip
        ng, t1 = min(rng, geo["groups"] - g0), min(tiles, t0 + strip)
        m0 = _newest(g0 * q, up, down, delay)
        r_lo = m0 - (nk - 1)
        col_s = [_newest((g0 + i) * q, up, down, delay) - m0 for i in range(ng)]
        lsub = col_s[-1] + cols
        assert lsub <= (rs if geo["rows"] else wl)
        tab = np.full((rng * q, cols), np.nan, np.float32)
        for tid in range(nt):  # the kernel's stepping
            pos = (g0 * q + tid) * down + delay
            m, p = pos // up, pos % up
            step_m, step_p = nt * down // up, nt * down % up
            for i in range(tid, ng * q, nt):
                assert (m, p) == divmod((g0 * q + i) * down + delay, up)
                t = np.arange(cols) - (m - m0 - col_s[i // q])
                ok = (g0 * q + i < cyc) & (t >= 0) & (t < nk)
                tab[i] = np.where(ok, bank[p * nk + np.clip(t, 0, nk - 1)], np.float32(0))
                m, p = m + step_m, p + step_p
                if p >= up:
                    m, p = m + 1, p - up
        for c in range(n_ch):
            for t in range(t0, t1):
                buf = np.full(wl, np.nan, np.float32)
                base = t * rows_n * raw_d + r_lo
                if geo["rows"]:
                    off = 0
                    for row in range(rows_n):
                        buf[row * rs + np.arange(lsub)] = raw(c, base + row * raw_d
                                                              + np.arange(lsub))
                else:  # x's row c starts at word c*n of a 16-byte aligned block
                    off = (c * n + base) % 4
                    v = np.arange(0, (rows_n - 1) * raw_d + lsub + off, 4)
                    for u in range(4):
                        buf[v + u] = raw(c, base + v - off + u)
                # the tile's outputs (where os is 0 the kernel stores them from
                # registers: the same values to the same positions)
                out = np.full((rows_n, max(os_, ng * q)), np.nan, np.float32)
                for gi in range(ng):
                    taps = tab[gi * q:(gi + 1) * q]
                    for i in range(per):  # lane l's super-cycle l + LANES i of the tile
                        row = lanes + rk.LANES * i
                        addr = row[:, None] * rs + off + col_s[gi] + np.arange(cols)
                        if c == 0 and t == t0:
                            reads.append(addr)
                        w = buf[addr]
                        acc = np.zeros((rk.LANES, q), np.float32)
                        for col in range(cols):
                            acc = fmaf32(taps[:, col][None, :], w[:, col:col + 1], acc)
                        out[row, gi * q:(gi + 1) * q] = acc
                length = min(ng * q, cyc - g0 * q)  # a row's run of y
                for row in range(rows_n):
                    j0 = (t * rows_n + row) * cyc + g0 * q
                    cnt = min(length, nout - j0)
                    if cnt > 0:
                        y[c, j0:j0 + cnt] = out[row, :cnt]
                        written[c, j0:j0 + cnt] += 1
    assert (written == 1).all()
    return y, geo, reads


def _cases_rs(k):
    """tests/kernels/test_fuzz_params.py's resampler draws (its seed)."""
    rng = np.random.default_rng(2028)
    out = []
    for _ in range(k):
        up = int(rng.integers(1, 24))
        down = int(rng.integers(1, 24))
        if up == down:
            down += 1
        n = int(rng.integers(40, 120)) * down + int(rng.integers(0, down))
        out.append((up, down, n))
    return out


_PITCH = Fraction(2 ** (3 / 12)).limit_denominator(128)  # pitch_shift(3): up/down = 37/44
RATIOS = ([(160, 147, 2947), (147, 160, 3207), (1, 2, 901), (2, 1, 777), (3, 4, 1001),
           (_PITCH.denominator, _PITCH.numerator, 1500)] + _cases_rs(8))
MODES = ("zero_phase", "causal", "history")


def _inputs(up, down, n, mode):
    """(x, hist) float32 from a seed; with a history, n and the history
    multiples of down (the JAX kernel's guard)."""
    rng = np.random.default_rng(up * 1000 + down + n)
    hist = None
    if mode == "history":
        u, d, h = reduce_ratio(up, down)
        n = max(d, n // d * d)
        hist = rng.standard_normal((2, history_len(len(h), u, d))).astype(np.float32)
    return rng.standard_normal((2, n)).astype(np.float32), hist


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-300))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("up,down,n", RATIOS)
def test_model_is_the_fmaf_chain_and_the_jax_kernel(up, down, n, mode):
    """The card's geometry (small inputs split the groups over CTAs): bit
    for bit the fmaf chains in tap order, >= 100 dB against the JAX kernel
    in float64, exact length."""
    x, hist = _inputs(up, down, n, mode)
    zp = mode == "zero_phase"
    y, geo, _ = mac_model(x, up, down, zero_phase=zp, hist=hist)
    ref = resample_fmaf_reference(x, up, down, zero_phase=zp, hist=hist)
    assert np.array_equal(y, ref)
    jx = np.asarray(jax_resample_mac(jnp.asarray(x, jnp.float64), up, down, zero_phase=zp,
                                     history=None if hist is None
                                     else jnp.asarray(hist, jnp.float64), cycle_tile=32))
    assert y.shape == jx.shape
    assert _snr(jx, y) >= 100.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("up,down,n", [(160, 147, 14700), (147, 160, 16000), (1, 2, 9000),
                                       (3, 4, 16000), (37, 44, 7000)])
def test_model_whole_ranges_and_strips(up, down, n, mode):
    """A one-SM card's geometry on the same small inputs: whole group
    ranges, strips of several tiles, two super-cycles a lane, the
    contiguous window at odd D; bit for bit the fmaf chains."""
    x, hist = _inputs(up, down, n, mode)
    zp = mode == "zero_phase"
    y, geo, _ = mac_model(x, up, down, zero_phase=zp, hist=hist, sms=1)
    assert geo["splits"] == 1
    if (up, down) == (160, 147):  # strips of 2 tiles, 2 super-cycles a lane, contiguous window
        assert (geo["strip"], geo["p"], geo["rows"]) == (2, 2, 0)
    assert np.array_equal(y, resample_fmaf_reference(x, up, down, zero_phase=zp, hist=hist))


def _wavefronts(addrs):
    """Shared-memory wavefronts of one warp's 4-byte loads at ``addrs``
    (word indices): the most distinct words any bank serves."""
    banks = {}
    for a in np.unique(addrs):
        banks.setdefault(int(a) % 32, set()).add(int(a))
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("up,down,n,sms", [(160, 147, 14700, 1), (160, 147, 4704, 132),
                                           (147, 160, 16000, 1), (1, 2, 9000, 132),
                                           (2, 1, 777, 132), (3, 4, 4000, 1),
                                           (37, 44, 7000, 132), (14, 9, 617, 132)])
def test_window_reads_touch_32_banks(up, down, n, sms):
    """Every window read of every group's walk: the warp's 32 lanes touch
    32 banks (one wavefront), the rows at an odd stride; the tap reads are
    one 16-byte address for the whole warp by construction (no lane term)."""
    x, _ = _inputs(up, down, n, "causal")
    _, geo, reads = mac_model(x, up, down, zero_phase=False, sms=sms)
    assert geo["rs"] % 2 == 1
    for addr in reads:
        for col in range(addr.shape[1]):
            assert _wavefronts(addr[:, col]) == 1


def _geo_for(channels, n_in, up, down, hn=0, zero_phase=False, taps=None):
    up, down, h = reduce_ratio(up, down, None if taps is None else np.ones(taps))
    nout = n_in * up // down if hn else -(-n_in * up // down)
    return rk.resample_geometry(channels, nout, up, down, taps_per_phase(len(h), up),
                                (len(h) - 1) // 2 if zero_phase else 0)


def test_geometry_at_the_headline():
    """64 x 441000 -> 480000 at 160/147: 8 outputs of 2 super-cycles a
    thread (tiles of 64 super-cycles), one CTA a strip of 12 tiles and every
    group (10 warps of 2 groups), 256 CTAs (2 an SM of 97712 bytes), so the
    bank is loaded 256 times where the retired kernel loaded it 469 x 64 =
    30016 times (117x fewer); the contiguous window at D = 147; the tile's
    outputs in rows of 164 floats (160 and 4 of padding)."""
    geo = _geo_for(64, 441000, 160, 147)
    assert (geo["q"], geo["p"], geo["threads"], geo["range"], geo["splits"]) == (8, 2, 320, 20, 1)
    assert (geo["strip"], geo["tiles"], geo["ctas"], geo["per_sm"]) == (12, 47, 256, 2)
    assert (geo["rows"], geo["rs"], geo["cols"], geo["os"]) == (0, 147, 28, 164)
    assert geo["smem"] == 97712 and 2 * (geo["smem"] + 1024) <= rk.SM_SMEM
    retired = -(-480000 // 1024) * 64
    assert retired == 30016 and geo["ctas"] * 8 <= retired  # a CTA reads the bank once
    assert _geo_for(64, 441000, 160, 147, zero_phase=True)["ctas"] == 256


def test_geometry_at_path_d_block():
    """Path D's block (64 x 4704 + 147 of history -> 64 x 5120): one tile of
    32 super-cycles a channel (one a lane), so the 20 groups split into 5
    ranges of 4: 320 CTAs on 132 SMs (as many as the retired kernel's 5 x
    64), a warp a group, the outputs stored from registers (no row
    buffer)."""
    hn = history_len(len(resample_filter(160, 147)), 160, 147)
    assert hn == 147
    geo = _geo_for(64, 4704, 160, 147, hn=hn)
    assert (geo["p"], geo["tiles"], geo["range"], geo["splits"], geo["ctas"]) == (1, 1, 4, 5, 320)
    assert geo["os"] == 0
    assert geo["ctas"] >= 2 * rk.H100_SMS and geo["threads"] == 128
    assert geo["rows"] == 1 and geo["rs"] % 2 == 1


def _retired_smem(up, down, taps):
    """The retired kernel's shared memory: the bank and the raw window of
    1024 outputs."""
    nk = taps_per_phase(taps, up)
    return 4 * (up * nk + rk.res_window(1024, up, down, nk))


def _retired_max_taps(up, down):
    """The most taps the retired kernel took at up/down."""
    w = -(-1023 * down // up)
    nk = (SMEM_LIMIT // 4 - w) // (up + 1)
    return nk * up if nk >= 1 else 0


@pytest.mark.parametrize("ups", [(1, 2, 3, 7, 8, 9), (40, 41, 147, 160, 397),
                                 (997, 1000, 2000, 4000)])
def test_geometry_fits_wherever_the_retired_kernel_did(ups):
    """Every reduced ratio up/down of these ups (below, at and past the 8
    outputs a group, the headline's, large) against odd and even downs from
    1 to 5000, at 1 tap, the prototype's, half the retired limit and the
    most taps the retired kernel admitted (where it admitted any): a
    geometry within SMEM_LIMIT, at the headline's 64 x 480000 and at one
    short block."""
    from math import gcd

    downs = [1, 2, 3, 4, 7, 8, 9, 59, 60, 97, 147, 160, 441, 1000, 2047, 5000]
    for up in ups:
        for down in downs:
            if gcd(up, down) != 1 or up == down == 1:
                continue
            top = _retired_max_taps(up, down)
            for taps in {1, len(resample_filter(up, down)), top // 2, top} - {0}:
                if _retired_smem(up, down, taps) > SMEM_LIMIT:
                    continue
                nk = taps_per_phase(taps, up)
                for channels, nout in ((64, 480000), (2, 700)):
                    geo = rk.resample_geometry(channels, nout, up, down, nk, 0)
                    assert geo["smem"] <= SMEM_LIMIT, (up, down, taps)


@pytest.mark.parametrize("threads,smem,regs,ctas", [
    (320, 97712, 64, 2),   # the headline's launch (the occupancy API on an H100: 2)
    (128, 16656, 62, 8),   # path D's with two window buffers (the API: 8)
    (320, 0, 64, 3),       # registers bind: 8 warps a sub-partition, 32 an SM
    (32, 0, 82, 20),       # 82 registers take 2816 a warp: 5 warps a sub-partition
    (32, 0, 32, 32),       # at most 32 CTAs an SM
    (32, 233472 - 1024 - 100, 32, 1),  # shared memory in 128-byte units
])
def test_ctas_per_sm(threads, smem, regs, ctas):
    """The occupancy calculator's rules for an H100's SM."""
    assert rk.ctas_per_sm(threads, smem, regs) == ctas


@pytest.mark.parametrize("up,down,n_in", [(1, 2, 960000), (147, 160, 480000), (2, 1, 240000),
                                          (160, 147, 441000)])
@pytest.mark.parametrize("regs", [rk.REGISTERS, (82, 82, 40), (128, 128, 64)])
def test_whole_file_grid_is_one_wave(up, down, n_in, regs):
    """64 channels of a whole file: a super-cycle of at least MIN_GROUPS
    groups (k periods at 1/2 and 2/1), the grid fits the CTAs the SMs hold
    at once (``per_sm`` by registers, warps, shared memory and 32 CTAs),
    and fills more than half of them."""
    upr, downr, h = reduce_ratio(up, down)
    nout = -(-n_in * upr // downr)
    geo = rk.resample_geometry(64, nout, upr, downr, taps_per_phase(len(h), upr), 0,
                               rk.H100_SMS, regs)
    assert geo["q"] == 8 and geo["groups"] >= rk.MIN_GROUPS and geo["cyc"] % upr == 0
    reg = regs[rk.INSTANCES.index((geo["q"], geo["p"]))]
    assert geo["per_sm"] == rk.ctas_per_sm(geo["threads"], geo["smem"], reg) <= rk.SM_CTAS
    assert rk.H100_SMS * geo["per_sm"] / 2 < geo["ctas"] <= rk.H100_SMS * geo["per_sm"]


def test_geometry_raises_naming_smem_limit():
    """Past what fits even one output a thread (a bank no CTA holds), a
    ValueError names SMEM_LIMIT."""
    with pytest.raises(ValueError, match="SMEM_LIMIT"):
        rk.resample_geometry(2, 1000, 1, 2, 60000, 0)


def test_geometry_takes_one_output_a_thread_where_eight_do_not_fit():
    """1/2 with 20000 taps (nk 20000: the retired kernel took it in 168 KB):
    8 outputs' tap table does not fit, one output a thread does."""
    assert _retired_smem(1, 2, 20000) <= SMEM_LIMIT
    geo = rk.resample_geometry(2, 5000, 1, 2, 20000, 0)
    assert geo["q"] == 1 and geo["smem"] <= SMEM_LIMIT


def test_geo_fields_match_the_kernel_struct():
    """GEO_FIELDS is ResMacGeo's field order in csrc/resample_kernel.cu."""
    src = (CSRC / "resample_kernel.cu").read_text()
    body = re.search(r"struct ResMacGeo \{(.*?)\};", src, re.S)[1]
    fields = [f.strip() for line in body.splitlines()
              for f in line.split("//")[0].replace("int ", "").strip().rstrip(";").split(",")
              if f.strip()]
    assert tuple(fields) == rk.GEO_FIELDS


def test_fmaf_reference_is_resample_poly():
    """The fmaf chain reference against the float64 plain resampler on the
    same float32 inputs: float32 rounding only."""
    import torch

    from audiosignalprocess_tpu_torch.ops.resample import resample_poly

    x, hist = _inputs(160, 147, 2940, "history")
    ref = resample_poly(torch.as_tensor(x, dtype=torch.float64), 160, 147, zero_phase=False,
                        history=torch.as_tensor(hist, dtype=torch.float64)).numpy()
    assert _snr(ref, resample_fmaf_reference(x, 160, 147, zero_phase=False, hist=hist)) >= 120.0


def test_chip_smoke_reads_the_kernel_ptxas():
    """chip_smoke's phase 13 reports ptxas's registers and spills of each
    instance <outputs, super-cycles a thread> of resample_mac_kernel."""
    import chip_smoke

    entry = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119resample_mac_kernel"
             "ILi{q}ELi{p}EEEvPKfS2_PfS2_NS_9ResMacGeoE' for 'sm_90a'\n"
             "    0 bytes stack frame, {sp} bytes spill stores, {sp} bytes spill loads\n"
             "ptxas info    : Used {regs} registers, used 1 barriers\n")
    log = (entry.format(q=8, p=2, sp=0, regs=82) + entry.format(q=8, p=1, sp=0, regs=64)
           + entry.format(q=1, p=1, sp=4, regs=40))
    assert (chip_smoke.chain_ptxas(log, "resample_mac_kernel")
            == "<8,2> 82 registers 0 bytes spill stores; <8,1> 64 registers 0 bytes spill "
               "stores; <1,1> 40 registers 4 bytes spill stores")


@pytest.mark.parametrize("up,taps", [(7, 5), (7, 7), (58110, 58110), (3, 4)])
def test_bank_table_with_one_tap_a_phase(up, taps):
    """bank_table where a filter has no more taps than up (one tap a phase):
    the reversed bank as a tensor (the reversed (up, 1) view has a negative
    stride that torch refuses, so resample_mac raised before its launch on
    the card), equal to the phase bank reversed."""
    import torch

    h = np.random.default_rng(up + taps).standard_normal(taps)
    bank = rk.bank_table(h.tobytes(), up, torch.device("cpu"))
    nk = taps_per_phase(taps, up)
    assert bank.shape == (up, nk)
    assert np.array_equal(bank.numpy(), phase_bank(h, up)[:, ::-1].astype(np.float32))


def test_resample_filter_is_designed_once():
    """The prototype filter comes from a cache (its design cost about 0.3
    ms of host time on every one-shot call): the same read-only array each
    time, bit for bit the oracle's."""
    from audiosignalprocess_tpu.cpu_ref import oracle

    a, b = resample_filter(160, 147), resample_filter(160, 147)
    assert a is b and not a.flags.writeable
    assert np.array_equal(a, oracle.resample_filter(160, 147))
    with pytest.raises(ValueError):
        a[0] = 1.0
