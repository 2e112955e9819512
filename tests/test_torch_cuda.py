"""The port's CUDA kernels vs their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU.  Imports
neither jax nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Bars: the linear kernels (fir_mac, overlap_save_fused, resample_mac and
the FFTs) >= 100 dB against their float64 plain versions; everything with
the gate >= 60 dB, because its hard thresholds flip a few borderline bins
under float32 rounding; the phase vocoder's step >= 60 dB against its
float64 plain version and >= 65 dB against its float32 plain version
(the JAX package's own bar: its rotor recursion integrates float32
rounding over the stream); the time-sharded fused gate of two gloo ranks
sharing the card >= 100 dB against the whole-file gate kernel (the two
kernels pair frames into complex transforms from different tile
origins, so a borderline bin may flip, and only at a hop where some
covering frame is paired otherwise: chip_smoke.unexplained_hops).
"""

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu_torch import api
from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
    fir_gate_step_fused, fir_gate_step_ref, fir_noise_gate_fused, fir_noise_gate_ref,
)
from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac, fir_mac_ref
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    gate_shard_fused, gate_shard_ref, gate_step_fused, gate_step_ref, noise_floor,
    noise_gate_fused, noise_gate_ref,
)
from audiosignalprocess_tpu_torch.kernels.os_kernel import (
    overlap_save_fused, overlap_save_ref,
)
from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
    res_fir_gate_step_fused, res_fir_gate_step_ref, resample_fir_gate_fused,
    resample_fir_gate_ref,
)
from audiosignalprocess_tpu_torch.kernels.resample_kernel import (
    resample_mac, resample_mac_ref,
)
from audiosignalprocess_tpu_torch.kernels.stretch_kernel import (
    stretch_step_fused, stretch_step_ref,
)
from audiosignalprocess_tpu_torch.ops import fft
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.resample import history_len, resample_filter
from audiosignalprocess_tpu_torch.ops.stft import frame
from audiosignalprocess_tpu_torch.ops.windows import window
from audiosignalprocess_tpu_torch.pipeline import (
    Chain, EnvelopeStage, FIRGateStage, FIRStage, GateStage, ResampleStage,
    ResFIRGateStage, StretchStage,
)
from audiosignalprocess_tpu_torch.utils.metrics import snr_db

pytestmark = pytest.mark.requires_cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _all_counters():
    """Every kernel wrapper of the port (each counts its launches)."""
    return (fir_noise_gate_fused, fir_gate_step_fused, gate_step_fused, overlap_save_fused,
            fir_mac, resample_mac, resample_fir_gate_fused, res_fir_gate_step_fused,
            noise_gate_fused, fk.fft_stockham_lanes, fk.rfft_stockham, fk.irfft_stockham,
            stretch_step_fused, gate_shard_fused, fk.fft_fourstep, fk.fft_radix2_lanes,
            fk.fft_radix2_stages, fk.fft_pease_lanes, fk.fft_stockham_manual)


def _launches(fn):
    """fn()'s launches of each kernel, by name (those it launched)."""
    before = {k.__name__: k.launches for k in _all_counters()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches - before[k.__name__] for k in _all_counters()
                 if k.launches != before[k.__name__]}


def _tone_burst(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


CHAIN_GRID = [(nfft, nfft // div, taps, release)
              for nfft in (256, 512, 1024, 2048) for div in (2, 4, 8)
              for taps in (1, 30, 64, 384) for release in (0.0, 0.6) if taps - 1 < nfft]


@pytest.mark.parametrize("c,nfft,hop,taps,release", [
    (3, 1024, 256, 64, 0.0), (3, 1024, 256, 64, 0.6), (3, 1024, 256, 384, 0.0),
    (3, 1024, 512, 30, 0.0), (3, 1024, 128, 64, 0.6),
    *((1 if k % 2 else 5, *case) for k, case in enumerate(CHAIN_GRID)),
])
def test_fir_noise_gate_kernel_vs_plain(card, c, nfft, hop, taps, release):
    """float32 kernel vs the float64 plain version on the same card:
    exact output length, finite, >= 60 dB (the gate's hard thresholds
    flip a few borderline bins under float32 rounding), one launch; nfft
    256 to 2048 at hops nfft/2 to nfft/8, 1 to 384 taps, release 0 and
    0.6, on 1, 3 or 5 channels (a file's last tile leaves a batch part
    empty)."""
    rng = np.random.default_rng(50)
    n = 40000 if nfft <= 1024 else 60000
    x = torch.as_tensor(_tone_burst(rng, c, n), device=card)
    h = design_fir(taps, 0.2 if taps == 384 else 0.3) if taps > 1 else np.array([0.7])
    before = fir_noise_gate_fused.launches
    out = fir_noise_gate_fused(x.float(), h, nfft=nfft, hop=hop, release=release)
    torch.cuda.synchronize()
    assert fir_noise_gate_fused.launches == before + 1
    ref = fir_noise_gate_ref(x, h, nfft=nfft, hop=hop, release=release)
    assert out.shape == ref.shape == (c, nfft + ((n - nfft) // hop) * hop)
    assert bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 60.0


def test_float64_on_card_raises(card):
    with pytest.raises(ValueError, match="float32"):
        fir_noise_gate_fused(torch.zeros(1, 8192, dtype=torch.float64, device=card),
                             design_fir(64, 0.3))


@pytest.mark.parametrize("taps,n,hist", [(1, 5000, False), (64, 40000, True),
                                          (129, 4096, True), (300, 3000, True)])
def test_fir_mac_vs_plain(card, taps, n, hist):
    rng = np.random.default_rng(51)
    x = torch.as_tensor(rng.standard_normal((3, n)), device=card)
    h = rng.standard_normal(taps)
    history = (torch.as_tensor(rng.standard_normal((3, taps - 1)), device=card)
               if hist else None)
    before = fir_mac.launches
    out = fir_mac(x.float(), h, None if history is None else history.float())
    torch.cuda.synchronize()
    assert fir_mac.launches == before + 1
    ref = fir_mac_ref(x, h, history)
    assert out.shape == ref.shape == (3, n) and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


@pytest.mark.parametrize("taps,nfft,n", [(64, 1024, 4096), (64, 1024, 40000),
                                          (384, 1024, 9000), (1, 256, 1000)])
def test_overlap_save_vs_plain(card, taps, nfft, n):
    rng = np.random.default_rng(52)
    x = torch.as_tensor(rng.standard_normal((3, n)), device=card)
    h = design_fir(taps, 0.3) if taps > 1 else np.array([0.5])
    history = torch.as_tensor(rng.standard_normal((3, taps - 1)), device=card)
    before = overlap_save_fused.launches
    out = overlap_save_fused(x.float(), h, nfft, history.float())
    torch.cuda.synchronize()
    assert overlap_save_fused.launches == before + 1
    ref = overlap_save_ref(x, h, nfft, history)
    assert out.shape == ref.shape == (3, n) and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


def _poisoned_launch(kernel, call, numel, dev):
    """call() after a warm-up call (the wrapper's tables are uploaded and
    cached) and two blocks of ``numel`` floats NaN-filled and freed, so the
    caching allocator hands that memory to the output's torch.empty and a
    position the kernel leaves unwritten shows as NaN.  Asserts one launch
    and that the output lies in the NaN-filled memory; returns it."""
    call()
    blocks = [torch.full((numel,), float("nan"), device=dev) for _ in range(2)]
    spans = [(b.data_ptr(), b.data_ptr() + 4 * numel) for b in blocks]
    del blocks
    before = kernel.launches
    y = call()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert any(a <= y.data_ptr() and y.data_ptr() + 4 * y.numel() <= b for a, b in spans)
    return y


def _os_fuzz_cases(k):
    """tests/kernels/test_fuzz_params.py's overlap-save cases (its seed and
    draws: nfft 256 to 4096, taps up to nfft - 1, n below one nfft in
    every third case, 1 to 4 channels)."""
    rng = np.random.default_rng(2026)
    out = []
    for i in range(k):
        nfft = int(2 ** rng.integers(8, 13))
        hi = nfft // 2 if i % 2 == 0 else nfft
        taps = int(rng.integers(1, max(3, hi)))
        n = int(rng.integers(1 if i % 3 else nfft, 6 * nfft))
        b = int(rng.integers(1, 5))
        out.append((taps, nfft, n, b))
    return out


OS_TWIN_CASES = _os_fuzz_cases(16) + [
    (1023, 1024, 1000, 3), (1024, 1024, 5000, 2), (64, 1024, 700, 5), (1, 2, 9, 3),
    (2, 2, 1, 2), (3, 4, 37, 70), (5, 8, 300, 9), (16, 16, 100, 3), (5, 32, 333, 40),
    (64, 64, 500, 7), (100, 128, 999, 5), (300, 512, 1234, 9),
    (4096, 8192, 30000, 3), (8192, 8192, 2000, 2), (4096, 16384, 50000, 2),
    (16384, 16384, 1500, 2), (3, 16384, 10000, 1)]


@pytest.mark.parametrize("taps,nfft,n,b", OS_TWIN_CASES)
@pytest.mark.parametrize("hist", (False, True))
def test_overlap_save_fuzz_twin(card, taps, nfft, n, b, hist):
    """The card twin of test_fuzz_params.py::test_overlap_save_fuzz, with
    the taps up to nfft (one output a block), n below one block and across
    channels inside a batch, every power of two from nfft 2 to 16384, with
    and without a history: >= 100 dB against the float64 plain version,
    every output written (NaN-filled before the call), one launch."""
    rng = np.random.default_rng(taps * 1000 + n)
    x = torch.as_tensor(rng.standard_normal((b, n)), device=card)
    h = rng.standard_normal(taps)
    history = (torch.as_tensor(rng.standard_normal((b, taps - 1)), device=card)
               if hist else None)
    h32 = None if history is None else history.float()
    out = _poisoned_launch(overlap_save_fused,
                           lambda: overlap_save_fused(x.float(), h, nfft, h32), b * n, card)
    ref = overlap_save_ref(x, h, nfft, history)
    assert out.shape == ref.shape == (b, n) and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


def test_overlap_save_config4_geometry(card):
    """Config 4's geometry: 4096 taps at nfft 16384 on a shard of 64 x
    96000 with its halo as the history, >= 100 dB against float64, every
    output written, one launch."""
    rng = np.random.default_rng(54)
    h = design_fir(4096, 0.1, window_kind="blackman")
    x = torch.as_tensor(rng.standard_normal((64, 96000)), device=card)
    history = torch.as_tensor(rng.standard_normal((64, 4095)), device=card)
    xf, hf = x.float(), history.float()
    out = _poisoned_launch(overlap_save_fused, lambda: overlap_save_fused(xf, h, 16384, hf),
                           x.numel(), card)
    ref = overlap_save_ref(x, h, 16384, history)
    assert bool(torch.isfinite(out).all()) and snr_db(ref, out) >= 100.0


@pytest.mark.parametrize("taps", (1, 2, 128, 129, 257, 897, 898))
@pytest.mark.parametrize("hist", (False, True))
@pytest.mark.parametrize("n", (4096, 4099, 700))
def test_fir_mac_fuzz_twin(card, taps, hist, n):
    """The card twin of test_fuzz_params.py's envelope tap counts for
    fir_mac (1, 2, 128, 129, 257, 897, 898), with and without a history, at
    a stream's block, a ragged length (unaligned rows) and one shorter
    than the taps: >= 100 dB against the float64 plain version, every
    output written (NaN-filled before the call), one launch."""
    rng = np.random.default_rng(taps + 7)
    x = torch.as_tensor(rng.standard_normal((3, n)), device=card)
    h = design_fir(taps, 0.05) if taps >= 8 else rng.standard_normal(taps)
    history = (torch.as_tensor(rng.standard_normal((3, taps - 1)), device=card)
               if hist else None)
    h32 = None if history is None else history.float()
    out = _poisoned_launch(fir_mac, lambda: fir_mac(x.float(), h, h32), 3 * n, card)
    ref = fir_mac_ref(x, h, history)
    assert out.shape == ref.shape == (3, n) and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


@pytest.mark.parametrize("taps", (28032, 28543, 28544))
def test_fir_mac_at_the_shared_memory_limit(card, taps):
    """Tap counts at the shared-memory edge (28544, the retired kernel's
    limit): bit for bit the taps' fmaf chains in order (a float32 model
    with exact fmaf), every output written, one launch; one tap more
    raises naming SMEM_LIMIT before any launch."""
    from test_torch_os_fir_regs import fmaf_reference

    rng = np.random.default_rng(taps)
    x = torch.as_tensor(rng.standard_normal((2, 600)), dtype=torch.float32, device=card)
    h = design_fir(taps, 0.1)
    history = torch.as_tensor(rng.standard_normal((2, taps - 1)), dtype=torch.float32,
                              device=card)
    out = _poisoned_launch(fir_mac, lambda: fir_mac(x, h, history), x.numel(), card)
    ref = fmaf_reference(x.cpu().numpy(), h, history.cpu().numpy())
    assert np.array_equal(out.cpu().numpy(), ref)
    before = fir_mac.launches
    with pytest.raises(ValueError, match="SMEM_LIMIT"):
        fir_mac(x, design_fir(28545, 0.1))
    assert fir_mac.launches == before


def _streams(chain_kernel, chain_plain, x, block, drain):
    """The f32 kernel stream and the f64 plain stream of the same input."""
    y = chain_kernel.stream(x.float(), block, drain=drain)
    torch.cuda.synchronize()
    ref = chain_plain.stream(x, block, drain=drain)
    return y, ref


@pytest.mark.parametrize("release,drain,block", [(0.0, False, 1024), (0.6, True, 1024),
                                                  (0.0, True, 256), (0.6, False, 3072)])
def test_gate_step_vs_plain(card, release, drain, block):
    """GateStage(fused=True) float32 (one gate_step_fused launch per block)
    against the float64 plain step stream on the same card."""
    rng = np.random.default_rng(53)
    n = 12 * 3072 + (777 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 3, n), device=card)
    kw = dict(nfft=1024, hop=256, noise_frames=4, release=release)
    ck, cp = Chain([GateStage(fused=True, **kw)]), Chain([GateStage(**kw)])
    ck.build()
    blocks = ck.drain_blocks(n, block) if drain else n // block
    before = gate_step_fused.launches
    y, ref = _streams(ck, cp, x, block, drain)
    assert gate_step_fused.launches == before + blocks
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref, y) >= 60.0


GATE_STEP_GRID = [  # (nfft, hop, block frames m, release, drain): 2B = 4096 R / nfft frames a batch
    (4, 1, 3, 0.0, False), (4, 1, 600, 0.6, True), (8, 2, 5, 0.6, True),
    (16, 4, 1031, 0.0, False), (32, 8, 129, 0.6, False), (64, 16, 9, 0.0, True),
    (256, 64, 33, 0.6, True), (256, 64, 64, 0.0, False), (512, 128, 3, 0.0, False),
    (512, 128, 17, 0.6, True), (1024, 256, 3, 0.6, False), (1024, 256, 5, 0.0, True),
    (1024, 256, 9, 0.6, False), (1024, 256, 16, 0.0, False), (1024, 256, 17, 0.6, True),
    (1024, 256, 24, 0.0, False), (1024, 256, 257, 0.6, False), (2048, 512, 7, 0.6, True),
    (4096, 1024, 1, 0.0, False), (4096, 1024, 2, 0.6, True), (4096, 512, 5, 0.0, False),
    (8192, 2048, 1, 0.6, False), (8192, 2048, 3, 0.0, True), (8192, 1024, 9, 0.6, False),
]


@pytest.mark.parametrize("nfft,hop,m,release,drain", GATE_STEP_GRID)
def test_gate_step_kernel_every_nfft(card, nfft, hop, m, release, drain):
    """GateStage(fused=True) float32, one gate_step_fused launch per block,
    against its float64 plain step stream: nfft 4 to 8192, blocks of m
    frames below the noise frames (4) and above, not a multiple of a batch
    (2B), at the edges of the cluster's split (the second CTA with no
    frame, one frame, a whole batch) and past the shared memory (segments,
    the popped spectra in device memory); every output and carry of every
    step written (NaN-filled before each call); >= 60 dB with the plain
    gate's float32 flips counted."""
    rng = np.random.default_rng(57)
    block = m * hop
    n = max(6 * block, 16 * nfft) // block * block + (777 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 3, n), device=card)
    kw = dict(nfft=nfft, hop=hop, noise_frames=4, release=release)
    chain = Chain([GateStage(fused=True, **kw)])
    chain.build()
    blocks = chain.drain_blocks(n, block) if drain else n // block
    before = gate_step_fused.launches
    ok = _nan_steps(chain)
    y = chain.stream(x.float(), block, drain=drain)
    torch.cuda.synchronize()
    del chain.step
    ref = Chain([GateStage(**kw)]).stream(x, block, drain=drain)
    assert gate_step_fused.launches == before + blocks
    assert len(ok) == blocks and all(ok)
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    snr = snr_db(ref, y)
    if snr < 60.0:
        import chip_smoke

        pytest.fail(f"{snr:.2f} dB against float64, "
                    f"{chip_smoke.decision_flips(x, nfft, hop, 4)} bins the plain gate flips")


def test_gate_step_carry_switches_between_kernel_and_plain(card):
    """One carry layout: blocks alternate between gate_step_fused and the
    plain float32 step; the stream equals the kernel-only stream."""
    rng = np.random.default_rng(58)
    block = 9 * 256
    x = torch.as_tensor(_tone_burst(rng, 2, 8 * block), device=card, dtype=torch.float32)
    stage = GateStage(fused=True, noise_frames=4, release=0.6)
    chain = Chain([stage])
    ref = chain.stream(x, block)
    st = chain.init_state((2,), block, torch.float32, card)
    ys = []
    before = gate_step_fused.launches
    for k in range(8):
        xb = x[:, k * block : (k + 1) * block]
        if k % 2:
            st, y = chain.step(st, xb)
        else:
            s0, y = gate_step_ref(xb, st[0], **stage._step_kw())
            st = [s0]
        ys.append(y)
    assert gate_step_fused.launches == before + 4
    assert snr_db(ref, torch.cat(ys, dim=-1)) >= 60.0


def _tensors(tree):
    """The tensors of a nested carry (lists and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nan_steps(chain):
    """Make each chain.step call into NaN-filled memory: just before it,
    blocks of the sizes of the previous step's output and new carries are
    NaN-filled and freed, so the caching allocator hands them to the
    kernel's output and new carries (torch.empty), and a position the
    kernel leaves unwritten shows as not finite.  Returns the list the
    steps append their check to (every output and carry tensor finite)."""
    step, sizes, ok = chain.step, [1 << 16], []

    def poisoned(states, x):
        blocks = [torch.full((n,), float("nan"), device=x.device) for n in sizes
                  for _ in range(2)]
        del blocks
        st, y = step(states, x)
        torch.cuda.synchronize()
        ts = [y] + _tensors(st)
        sizes[:] = sorted({t.numel() for t in ts if t.numel()})
        ok.append(all(bool(torch.isfinite(t).all()) for t in ts))
        return st, y

    chain.step = poisoned
    return ok


@pytest.mark.parametrize("nfft,hop,block,release,env_taps,drain,taps", [
    (1024, 256, 4096, 0.0, 0, False, 64), (1024, 256, 4096, 0.6, 129, True, 64),
    (1024, 256, 4096, 0.0, 129, False, 64), (1024, 256, 4096, 0.6, 0, True, 64),
    (1024, 256, 4096, 0.0, 300, True, 500), (1024, 256, 4096, 0.0, 1, False, 1),
    (256, 64, 5 * 64, 0.6, 129, False, 64), (512, 128, 33 * 128, 0.0, 0, True, 64),
    (1024, 256, 3 * 256, 0.6, 0, False, 64), (1024, 256, 21 * 256, 0.0, 129, True, 64),
    (1024, 256, 257 * 256, 0.6, 3000, False, 64), (2048, 512, 7 * 512, 0.6, 300, False, 500),
    (4096, 1024, 5 * 1024, 0.0, 129, True, 64), (4096, 512, 9 * 512, 0.6, 0, False, 64),
    (8192, 2048, 3 * 2048, 0.6, 129, False, 64), (8192, 2048, 5 * 2048, 0.0, 0, True, 64),
    (8192, 1024, 9 * 1024, 0.6, 0, False, 1),
])
def test_fir_gate_step_vs_plain(card, nfft, hop, block, release, env_taps, drain, taps):
    """FIRGateStage float32 (one fir_gate_step_fused launch per block,
    envelope folded in) against its float64 plain composition: nfft 256 to
    8192, blocks of m frames odd, below a batch (2B) and the noise frames,
    above both, and one past the shared memory (segments, the popped
    spectra and the envelope's input in device memory); every output and
    carry of every step written (NaN-filled before each call)."""
    rng = np.random.default_rng(54)
    n = max(10 * 4096, 6 * block, 12 * nfft) // block * block + (1234 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 3, n), device=card)
    h = design_fir(taps, 0.3) if taps > 1 else np.array([0.8])
    env_h = None
    if env_taps:
        env_h = design_fir(env_taps, 0.01) if env_taps > 1 else np.array([0.5])
    chain = Chain([FIRGateStage(h=h, nfft=nfft, hop=hop, noise_frames=4, release=release,
                                env_h=env_h)])
    chain.build()
    blocks = chain.drain_blocks(n, block) if drain else n // block
    before = fir_gate_step_fused.launches
    ok = _nan_steps(chain)
    y = chain.stream(x.float(), block, drain=drain)
    torch.cuda.synchronize()
    del chain.step
    ref = chain.stream(x, block, drain=drain)
    assert fir_gate_step_fused.launches == before + blocks
    assert len(ok) == blocks and all(ok)
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref, y) >= 60.0


def test_path_b_launches_each_kernel_per_block(card):
    rng = np.random.default_rng(55)
    x = torch.as_tensor(_tone_burst(rng, 2, 8 * 4096), device=card)
    h, he = design_fir(64, 0.3), design_fir(129, 0.01)
    stages = lambda fused: [FIRStage(h=h, nfft=1024, fused=fused),
                            GateStage(noise_frames=4, fused=fused),
                            EnvelopeStage(he, fused=fused)]
    counters = (overlap_save_fused, gate_step_fused, fir_mac)
    before = [k.launches for k in counters]
    chain = Chain(stages(True))
    chain.build()
    blocks = chain.drain_blocks(x.shape[-1], 4096)
    y, ref = _streams(chain, Chain(stages(False)), x, 4096, True)
    assert [k.launches - b for k, b in zip(counters, before)] == [blocks] * 3
    assert snr_db(ref, y) >= 60.0


def test_carry_switches_between_kernel_and_plain(card):
    """One carry layout: blocks alternate between the kernel and the plain
    float32 step and the stream equals the kernel-only stream."""
    rng = np.random.default_rng(56)
    x = torch.as_tensor(_tone_burst(rng, 2, 8 * 2048), device=card, dtype=torch.float32)
    stage = FIRGateStage(h=design_fir(64, 0.3), noise_frames=4, release=0.6,
                         env_h=design_fir(129, 0.01))
    chain = Chain([stage])
    ref = chain.stream(x, 2048)
    st = chain.init_state((2,), 2048, torch.float32, card)
    ys = []
    for k in range(8):
        xb = x[:, k * 2048 : (k + 1) * 2048]
        if k % 2:
            st, y = chain.step(st, xb)
        else:
            s0, y = fir_gate_step_ref(xb, st[0], stage.h, env_h=stage.env_h,
                                      env_scale=stage.env_scale,
                                      **stage._gate._step_kw())
            st = [s0]
        ys.append(y)
    assert snr_db(ref, torch.cat(ys, dim=-1)) >= 60.0


def _gate_step_f64(x):
    g = GateStage()
    return gate_step_fused(x, g.init_state((1,), 4096, torch.float64, x.device),
                           **g._step_kw())


def _fir_gate_step_f64(x):
    st = FIRGateStage(h=design_fir(64, 0.3))
    return fir_gate_step_fused(x, st.init_state((1,), 4096, torch.float64, x.device),
                               st.h, **st._gate._step_kw())


def _res_fir_gate_step_f64(x):
    st = ResFIRGateStage(h=design_fir(64, 0.3))
    return res_fir_gate_step_fused(x, st.init_state((1,), 4704, torch.float64, x.device),
                                   160, 147, st.h, **st._fg._gate._step_kw())


def _stretch_step_f64(x):
    st = StretchStage(4, 3)
    st.configure(0)
    return stretch_step_fused(x[:, :4096], st.init_state((1,), 4096, torch.float64, x.device),
                              **st._step_kw())


@pytest.mark.parametrize("call", [
    lambda x: fir_mac(x, design_fir(64, 0.3)),
    lambda x: overlap_save_fused(x, design_fir(64, 0.3), 1024),
    _gate_step_f64,
    _fir_gate_step_f64,
    lambda x: resample_mac(x, 160, 147),
    lambda x: resample_fir_gate_fused(x, 160, 147, design_fir(64, 0.3)),
    _res_fir_gate_step_f64,
    noise_gate_fused,
    lambda x: fk.fft_stockham_lanes(x, x, -1.0),
    fk.rfft_stockham,
    lambda x: fk.irfft_stockham(x[:, :2049], x[:, :2049], 4096),
    _stretch_step_f64,
    lambda x: gate_shard_fused(x, torch.ones(1, 513, dtype=x.dtype, device=x.device), 13,
                               1024, 256),
])
def test_new_kernels_raise_on_float64(card, call):
    with pytest.raises(ValueError, match="float32"):
        call(torch.zeros(1, 4096, dtype=torch.float64, device=card))


def test_gate_stage_fused_full_launches_one_kernel(card):
    """GateStage(fused=True).full on a CUDA float32 tensor: one
    noise_gate_fused and no other kernel, >= 60 dB against float64."""
    rng = np.random.default_rng(62)
    x = torch.as_tensor(_tone_burst(rng, 3, 40000), device=card)
    counters = _all_counters()
    before = [k.launches for k in counters]
    y = GateStage(noise_frames=4, fused=True).full(x.float())
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [
        int(k is noise_gate_fused) for k in counters]
    ref = GateStage(noise_frames=4).full(x)
    assert y.shape == ref.shape == (3, 40000) and bool(torch.isfinite(y).all())
    assert snr_db(ref, y) >= 60.0


@pytest.mark.parametrize("up,down", [(160, 147), (147, 160), (2, 1), (1, 2), (3, 4)])
@pytest.mark.parametrize("mode", ["zero_phase", "causal", "history"])
def test_resample_mac_vs_plain(card, up, down, mode):
    """resample_mac float32 against its float64 plain version: >= 100 dB,
    exact length, one launch."""
    rng = np.random.default_rng(57)
    n = down * 300
    x = torch.as_tensor(rng.standard_normal((3, n)), device=card)
    hist = None
    if mode == "history":
        hn = history_len(len(resample_filter(up, down)), up, down)
        hist = torch.as_tensor(rng.standard_normal((3, hn)), device=card)
    zp = mode == "zero_phase"
    before = resample_mac.launches
    out = resample_mac(x.float(), up, down, zero_phase=zp,
                       history=None if hist is None else hist.float())
    torch.cuda.synchronize()
    assert resample_mac.launches == before + 1
    ref = resample_mac_ref(x, up, down, zero_phase=zp, history=hist)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


def _rs_fuzz_cases(k):
    """tests/kernels/test_fuzz_params.py's resampler draws (its seed): up and
    down below 24, n not a multiple of down (a ragged last cycle)."""
    rng = np.random.default_rng(2028)
    out = []
    for _ in range(k):
        up = int(rng.integers(1, 24))
        down = int(rng.integers(1, 24))
        if up == down:
            down += 1
        out.append((up, down, int(rng.integers(40, 120)) * down + int(rng.integers(0, down))))
    return out


@pytest.mark.parametrize("zp", (True, False), ids=("zero_phase", "causal"))
@pytest.mark.parametrize("up,down,n", _rs_fuzz_cases(8))
def test_resample_fuzz_twin(card, up, down, n, zp):
    """The card twin of test_fuzz_params.py::test_resample_fuzz: random up/down
    below 24 with ragged tails, zero-phase and causal, on 2 channels: >= 100
    dB against the float64 plain version, exact length, every output written
    (NaN-filled before the call), one launch."""
    rng = np.random.default_rng(up * 100 + down)
    x = torch.as_tensor(rng.standard_normal((2, n)), device=card)
    xf = x.float()
    out = _poisoned_launch(resample_mac, lambda: resample_mac(xf, up, down, zero_phase=zp),
                           2 * (n * up // down + 1), card)
    ref = resample_mac_ref(x, up, down, zero_phase=zp)
    assert out.shape == ref.shape == (2, -(-n * up // down)) and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


@pytest.mark.parametrize("up,down,c,n,mode", [
    (160, 147, 2, 441000, "causal"), (160, 147, 2, 441000, "zero_phase"),
    (160, 147, 64, 4704, "history"), (147, 160, 3, 48000, "zero_phase"),
    (147, 160, 64, 4800, "history"), (1, 2, 3, 40001, "causal"), (1, 2, 64, 4096, "history")])
def test_resample_mac_is_the_fmaf_chain(card, up, down, c, n, mode):
    """Bit for bit the polyphase fmaf chains in tap order (a float32 model
    with exact fmaf, tests/torch_fmaf.py) at the whole file's geometry (2
    channels of 441000: strips of tiles, the contiguous window), path D's
    block with its history (the groups split over CTAs), 147/160 and 1/2:
    every output written, one launch."""
    from torch_fmaf import resample_fmaf_reference

    rng = np.random.default_rng(up + down + n)
    x = torch.as_tensor(rng.standard_normal((c, n)), dtype=torch.float32, device=card)
    hist = None
    if mode == "history":
        hist = torch.as_tensor(rng.standard_normal((c, history_len(
            len(resample_filter(up, down)), up, down))), dtype=torch.float32, device=card)
    zp = mode == "zero_phase"
    out = _poisoned_launch(resample_mac, lambda: resample_mac(x, up, down, zero_phase=zp,
                                                              history=hist),
                           c * (n * up // down + 1), card)
    ref = resample_fmaf_reference(x.cpu().numpy(), up, down, zero_phase=zp,
                                  hist=None if hist is None else hist.cpu().numpy())
    assert np.array_equal(out.cpu().numpy(), ref)


@pytest.mark.parametrize("up,down,taps,channels,nout", [
    (160, 147, None, 64, 480000), (160, 147, None, 64, 5120), (1, 2, None, 64, 480000),
    (147, 160, None, 64, 441000), (2, 1, None, 64, 960000), (1, 2, 8000, 2, 3000)])
def test_resample_mac_geometry_counts_the_ctas_an_sm_holds(card, up, down, taps, channels, nout):
    """resample_geometry's CTAs an SM (``ctas_per_sm`` with the built
    kernels' registers; it sizes the strips) is the occupancy API's at the
    launch it chose, and the grid is at most one wave of them."""
    from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac_info

    info = resample_mac_info(up, down, taps, channels, nout, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert info["ctas"] == info["per_sm"] >= 1, info
    assert info["grid"] <= info["per_sm"] * sms, info


@pytest.mark.parametrize("up,down,taps,n", [(160, 147, 56800, 6000), (58110, 1, 58110, 4),
                                             (1, 2, 8000, 6000)])
def test_resample_mac_at_the_retired_limit(card, up, down, taps, n):
    """Filters at the retired kernel's edge (its bank and 1024 outputs'
    window within 227 KB): 160/147 with the most taps it took (355 a
    phase), 58110/1 with one tap a phase (the largest up*nk it took), and
    1/2 with 8000 taps (where 8 outputs' tap table no longer fits: one
    output a thread): still one launch, >= 100 dB against the float64 plain
    version, every output written."""
    from audiosignalprocess_tpu_torch.kernels import resample_kernel as rk
    from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT

    nk = -(-taps // up)
    assert 4 * (up * nk + rk.res_window(1024, up, down, nk)) <= SMEM_LIMIT
    rng = np.random.default_rng(taps)
    h = design_fir(taps, 0.9 / max(up, down)) * up
    x = torch.as_tensor(rng.standard_normal((2, n)), device=card)
    xf = x.float()
    out = _poisoned_launch(resample_mac, lambda: resample_mac(xf, up, down, h=h),
                           2 * (n * up // down + 1), card)
    ref = resample_mac_ref(x, up, down, h=h)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 100.0


@pytest.mark.parametrize("c,up,down,taps,n,release,nfft,hop", [
    (2, 160, 147, 64, 47040, 0.0, 1024, 256), (2, 2, 1, 96, 16384, 0.7, 1024, 256),
    (2, 160, 147, 384, 47040, 0.0, 1024, 256), (2, 147, 160, 64, 40960 + 333, 0.0, 1024, 256),
    (2, 160, 147, 64, 20000, 0.6, 1024, 256),
    *((1 if k % 2 else 3, 160, 147, taps, 44100, release, nfft, hop)
      for k, (nfft, hop, taps, release) in enumerate(CHAIN_GRID)),
])
def test_resample_fir_gate_vs_plain(card, c, up, down, taps, n, release, nfft, hop):
    """resample_fir_gate_fused float32 against its float64 plain version on
    a tone burst: >= 60 dB, exact length, one launch and no resample_mac
    (the floor prologue runs the plain resampler); the chain kernel's
    nfft/hop/taps grid at 160/147 on 1 or 3 channels."""
    rng = np.random.default_rng(58)
    x = torch.as_tensor(_tone_burst(rng, c, n, fs=44100), device=card)
    h = (design_fir(taps, 0.2 if taps == 384 else (0.25 if taps == 96 else 0.3)) if taps > 1
         else np.array([0.7]))
    before = (resample_fir_gate_fused.launches, resample_mac.launches)
    out = resample_fir_gate_fused(x.float(), up, down, h, nfft=nfft, hop=hop, noise_frames=4,
                                  release=release)
    torch.cuda.synchronize()
    assert (resample_fir_gate_fused.launches, resample_mac.launches) == (before[0] + 1,
                                                                          before[1])
    ref = resample_fir_gate_ref(x, up, down, h, nfft=nfft, hop=hop, noise_frames=4,
                                release=release)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 60.0


@pytest.mark.parametrize("nfft,hop,release,env,drain,block", [
    (1024, 256, 0.0, False, False, 4704), (1024, 256, 0.6, True, True, 4704),
    (1024, 256, 0.0, True, False, 1176), (1024, 256, 0.6, False, True, 2352),
    (256, 64, 0.6, True, False, 294), (1024, 256, 0.0, False, True, 3 * 1176),
    (2048, 512, 0.6, True, False, 2352), (4096, 1024, 0.0, True, True, 4704),
    (8192, 2048, 0.6, True, False, 9408), (8192, 2048, 0.0, False, True, 9408),
])
def test_res_fir_gate_step_vs_plain(card, nfft, hop, release, env, drain, block):
    """ResFIRGateStage float32 (one res_fir_gate_step_fused launch per
    block, envelope folded in) against its float64 plain composition, at
    nfft 256 to 8192 and blocks of 5 to 20 resampled hops (odd, below a
    batch, above the noise frames); every output and carry of every step
    written (NaN-filled before each call)."""
    rng = np.random.default_rng(59)
    n = max(8 * 4704, 6 * block) // block * block + (777 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 3, n, fs=44100), device=card)
    chain = Chain([ResFIRGateStage(h=design_fir(64, 0.3), nfft=nfft, hop=hop, noise_frames=4,
                                   release=release,
                                   env_h=design_fir(129, 0.01) if env else None)])
    chain.build()
    blocks = chain.drain_blocks(n, block) if drain else n // block
    before = res_fir_gate_step_fused.launches
    ok = _nan_steps(chain)
    y = chain.stream(x.float(), block, drain=drain)
    torch.cuda.synchronize()
    del chain.step
    ref = chain.stream(x, block, drain=drain)
    assert res_fir_gate_step_fused.launches == before + blocks
    assert len(ok) == blocks and all(ok)
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref, y) >= 60.0


def test_res_paths_launch_counts(card):
    """Path 1 (whole file): one resample_fir_gate_fused (+ fir_mac for the
    envelope); path D: resample_mac + fir_gate_step_fused per block."""
    rng = np.random.default_rng(60)
    x = torch.as_tensor(_tone_burst(rng, 2, 8 * 4704, fs=44100), device=card,
                        dtype=torch.float32)
    h, he = design_fir(64, 0.3), design_fir(129, 0.01)
    counters = (resample_fir_gate_fused, res_fir_gate_step_fused, resample_mac,
                fir_gate_step_fused, fir_noise_gate_fused, fir_mac)
    counts = lambda: [k.launches for k in counters]
    whole = Chain([ResFIRGateStage(h=h, noise_frames=4, env_h=he)])
    whole.build()
    before = counts()
    y = whole.full_flush(x)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 0, 0, 0, 0, 1]
    assert y.shape == (2, whole.out_len(x.shape[-1]))
    path_d = Chain([ResampleStage(160, 147, fused=True), FIRGateStage(h=h, noise_frames=4)])
    path_d.build()
    blocks = path_d.drain_blocks(x.shape[-1], 4704)
    before = counts()
    yd = path_d.stream(x, 4704, drain=True)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, blocks, blocks, 0, 0]
    ref = Chain([ResampleStage(160, 147), FIRGateStage(h=h, noise_frames=4)]).full_flush(
        x.double())
    assert snr_db(ref, yd) >= 60.0


def test_res_carry_switches_between_kernel_and_plain(card):
    """One carry layout: blocks alternate between res_fir_gate_step_fused
    and its plain float32 step; the stream equals the kernel-only one."""
    rng = np.random.default_rng(61)
    x = torch.as_tensor(_tone_burst(rng, 2, 8 * 2352, fs=44100), device=card,
                        dtype=torch.float32)
    stage = ResFIRGateStage(h=design_fir(64, 0.3), noise_frames=4, release=0.6,
                            env_h=design_fir(129, 0.01))
    chain = Chain([stage])
    ref = chain.stream(x, 2352)
    st = chain.init_state((2,), 2352, torch.float32, card)
    ys = []
    for k in range(8):
        xb = x[:, k * 2352 : (k + 1) * 2352]
        if k % 2:
            st, y = chain.step(st, xb)
        else:
            s0, y = res_fir_gate_step_ref(xb, st[0], 160, 147, stage.h, stage.h_res,
                                          env_h=stage.env_h, env_scale=stage.env_scale,
                                          **stage._fg._gate._step_kw())
            st = [s0]
        ys.append(y)
    assert snr_db(ref, torch.cat(ys, dim=-1)) >= 60.0


@pytest.mark.parametrize("n", (2, 4, 8, 256, 1024, 4096, 16384))
@pytest.mark.parametrize("batch", (1, 100, 300))
def test_fft_kernels_vs_plain(card, n, batch):
    """fft_stockham_lanes (both signs), rfft_stockham and irfft_stockham in
    float32 against their float64 plain versions: >= 100 dB, one launch
    each; n = 16384 runs the complex kernel on buffers in device memory."""
    rng = np.random.default_rng(63)
    xr = torch.as_tensor(rng.standard_normal((batch, n)), device=card)
    xi = torch.as_tensor(rng.standard_normal((batch, n)), device=card)
    for sign in (-1.0, 1.0):
        (yr, yi), k = _launches(lambda: fk.fft_stockham_lanes(xr.float(), xi.float(), sign))
        assert k == {"fft_stockham_lanes": 1}
        rr, ri = fk.fft_stockham_lanes_ref(xr, xi, sign)
        assert snr_db(torch.cat([rr, ri]), torch.cat([yr, yi])) >= 100.0
    if n < 4:
        return
    (sr, si), k = _launches(lambda: fk.rfft_stockham(xr.float()))
    assert k == {"rfft_stockham": 1} and sr.shape == (batch, n // 2 + 1)
    rr, ri = fk.rfft_stockham_ref(xr)
    assert snr_db(torch.cat([rr, ri]), torch.cat([sr, si])) >= 100.0
    # edge bins with imaginary parts: dropped, as torch.fft.irfft drops them
    ri = ri + xi[:, : n // 2 + 1]
    y, k = _launches(lambda: fk.irfft_stockham(rr.float(), ri.float(), n))
    assert k == {"irfft_stockham": 1} and y.shape == (batch, n)
    assert snr_db(fk.irfft_stockham_ref(rr, ri, n), y) >= 100.0
    assert snr_db(torch.fft.irfft(torch.complex(rr, ri), n), y) >= 100.0


REAL_SIZES = (16, 32, 64, 128, 512, 2048, 8192, 16384, 32768, 131072)  # chip_smoke's 14b


@pytest.mark.parametrize("n", REAL_SIZES)
def test_real_stockham_every_pass_shape(card, n):
    """rfft_stockham and irfft_stockham on the register Stockham passes of
    their n/2-point transform: every pass count and shorter last pass, the
    leading pass of three (n = 512, 8192, 131072) and the exchange in
    scratch (n = 32768, 131072), on one row and on a CTA's rows + 1:
    >= 130 dB against the float64 plain version and torch.fft, one launch
    each; the imaginary parts of the edge bins drop."""
    rng = np.random.default_rng(130 + n)
    for b in (1, fk.real_stockham_geometry(n)[0] + 1):
        x = torch.as_tensor(rng.standard_normal((b, n)), device=card)
        (sr, si), k = _launches(lambda: fk.rfft_stockham(x.float()))
        assert k == {"rfft_stockham": 1} and sr.shape == (b, n // 2 + 1)
        spec = torch.fft.rfft(x)
        got = torch.cat([sr, si])
        assert snr_db(torch.cat(fk.rfft_stockham_ref(x)), got) >= 130.0
        assert snr_db(torch.cat([spec.real, spec.imag]), got) >= 130.0
        rr, ri = spec.real.contiguous(), spec.imag.clone()
        ri[:, 0], ri[:, -1] = 1.0, -1.0
        y, k = _launches(lambda: fk.irfft_stockham(rr.float(), ri.float(), n))
        assert k == {"irfft_stockham": 1} and y.shape == (b, n)
        assert snr_db(fk.irfft_stockham_ref(rr, ri, n), y) >= 130.0
        assert snr_db(torch.fft.irfft(torch.complex(rr, ri), n), y) >= 130.0


VARIANTS = {  # the FFT variant kernels: (plain version, ops.fft impl)
    "fft_fourstep": (fk.fft_fourstep_ref, "fourstep"),
    "fft_radix2_lanes": (fk.fft_radix2_lanes_ref, "radix2_lanes"),
    "fft_radix2_stages": (fk.fft_radix2_stages_ref, "radix2_stages"),
    "fft_pease_lanes": (fk.fft_pease_lanes_ref, "pease"),
}


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("n", (4, 8, 512, 4096, 16384))
@pytest.mark.parametrize("batch", (1, 7, 300))
def test_fft_variants_vs_plain(card, name, n, batch):
    """Each FFT variant kernel (both signs) in float32 against its float64
    plain version and torch.fft: >= 100 dB, one launch each; n = 16384
    runs on buffers in device memory."""
    kernel, plain = getattr(fk, name), VARIANTS[name][0]
    rng = np.random.default_rng(66)
    xr = torch.as_tensor(rng.standard_normal((batch, n)), device=card)
    xi = torch.as_tensor(rng.standard_normal((batch, n)), device=card)
    z = torch.complex(xr, xi)
    for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
        (yr, yi), k = _launches(lambda: kernel(xr.float(), xi.float(), sign))
        assert k == {name: 1} and yr.shape == (batch, n)
        rr, ri = plain(xr, xi, sign)
        assert snr_db(torch.cat([rr, ri]), torch.cat([yr, yi])) >= 100.0
        assert snr_db(torch.cat([lib.real, lib.imag]), torch.cat([yr, yi])) >= 100.0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fft_variant_impls_launch_their_kernel(card, name):
    """ops.fft with each variant impl on CUDA float32: the complex
    transforms one launch of the kernel, the real ones one launch on the
    n/2-point rows; float64 raises (the kernels compute in float32)."""
    impl = VARIANTS[name][1]
    rng = np.random.default_rng(67)
    x = torch.as_tensor(rng.standard_normal((2, 3, 1024)), device=card)
    z = torch.complex(x, x.flip(-1))
    for call, ref in ((lambda: fft.fft(z.to(torch.complex64), impl=impl), torch.fft.fft(z)),
                      (lambda: fft.ifft(z.to(torch.complex64), impl=impl), torch.fft.ifft(z)),
                      (lambda: fft.rfft(x.float(), impl=impl), torch.fft.rfft(x))):
        out, k = _launches(call)
        assert k == {name: 1}
        assert snr_db(torch.view_as_real(ref), torch.view_as_real(out)) >= 100.0
    y, k = _launches(lambda: fft.irfft(torch.fft.rfft(x).to(torch.complex64), 1024, impl=impl))
    assert k == {name: 1} and snr_db(x, y) >= 100.0
    with pytest.raises(ValueError, match="float32"):
        fft.fft(z, impl=impl)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fft_variant_slice_chain(card, name):
    """The slice, FIRStage -> GateStage (nfft 1024) with each variant impl:
    four launches of the variant's kernel per whole-file call (a real
    transform pair in the overlap-save and in the gate), nothing else,
    >= 60 dB against the float64 chain on torch.fft."""
    impl = VARIANTS[name][1]
    rng = np.random.default_rng(68)
    x = torch.as_tensor(_tone_burst(rng, 4, 48128), device=card)
    h = design_fir(64, 0.3)

    def chain(impl):
        return Chain([FIRStage(h=h, nfft=1024, impl=impl),
                      GateStage(nfft=1024, hop=256, noise_frames=8, impl=impl)])

    y, k = _launches(lambda: chain(impl).full_flush(x.float()))
    assert k == {name: 4} and y.shape == x.shape
    assert snr_db(chain("torch").full_flush(x), y) >= 60.0


REDESIGNED = {  # the kernels redesigned for the card: (launch geometry, smallest n)
    "fft_fourstep": (fk.fourstep_geometry, 4),
    "fft_radix2_lanes": (fk.radix2_lanes_geometry, 2),
    "fft_radix2_stages": (fk.radix2_lanes_geometry, 2),
    "fft_pease_lanes": (fk.pease_geometry, 2),
    "fft_stockham_lanes": (fk.stockham_geometry, 2),
}
REDESIGN_PATH = ((32000, 512), (119808, 512), (4096, 1024), (4096, 4096))


def _check_redesigned(card, name, b, n, seed):
    """One kernel of REDESIGNED on b x n rows, both signs: >= 100 dB against
    its float64 plain version and torch.fft, one launch each."""
    kernel, plain = getattr(fk, name), getattr(fk, f"{name}_ref")
    gen = torch.Generator(device=card).manual_seed(seed)
    xr = torch.randn((b, n), generator=gen, dtype=torch.float64, device=card)
    xi = torch.randn((b, n), generator=gen, dtype=torch.float64, device=card)
    z = torch.complex(xr, xi)
    for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
        (yr, yi), k = _launches(lambda: kernel(xr.float(), xi.float(), sign))
        assert k == {name: 1} and yr.shape == (b, n)
        rr, ri = plain(xr, xi, sign)
        assert snr_db(torch.cat([rr, ri]), torch.cat([yr, yi])) >= 100.0
        assert snr_db(torch.cat([lib.real, lib.imag]), torch.cat([yr, yi])) >= 100.0


@pytest.mark.parametrize("name,n", [(name, 1 << k) for name, (_, least) in REDESIGNED.items()
                                    for k in range(least.bit_length() - 1, 15)])
def test_fft_redesigned_every_n(card, name, n):
    """fft_fourstep (tensor cores, 3xTF32) at every n from 4, and
    fft_radix2_lanes, fft_radix2_stages, fft_pease_lanes and
    fft_stockham_lanes (stages in registers) at every n from 2, to 16384,
    on 3 CTAs' rows and one more (a partial last CTA), both signs."""
    _check_redesigned(card, name, 3 * REDESIGNED[name][0](n)[0] + 1, n, 71 + n.bit_length())


@pytest.mark.parametrize("name", list(REDESIGNED))
@pytest.mark.parametrize("b,n", REDESIGN_PATH)
def test_fft_redesigned_at_the_path_rows(card, name, b, n):
    """The redesigned kernels at the rows the slice gives them (32000 and
    119808 rows of 512 points: an rfft and an irfft of each block) and at
    the two timed points, both signs."""
    _check_redesigned(card, name, b, n, 72)


@pytest.mark.parametrize("b,n", [(3 * fk.radix2_lanes_geometry(1 << k)[0] + 1, 1 << k)
                                 for k in range(1, 15)] + list(REDESIGN_PATH))
def test_fft_radix2_stages_is_radix2_lanes_bit_for_bit(card, b, n):
    """fft_radix2_stages runs fft_radix2_lanes' passes on its stacked table,
    whose distinct entries are the same float32 values: the two kernels'
    results are equal bit for bit, both signs, at every n from 2 to 16384
    with a partial last CTA and at the slice's and the timed rows."""
    gen = torch.Generator(device=card).manual_seed(73 + n)
    xr = torch.randn((b, n), generator=gen, device=card)
    xi = torch.randn((b, n), generator=gen, device=card)
    for sign in (-1.0, 1.0):
        (sr, si), k = _launches(lambda: fk.fft_radix2_stages(xr, xi, sign))
        assert k == {"fft_radix2_stages": 1}
        lr, li = fk.fft_radix2_lanes(xr, xi, sign)
        assert torch.equal(sr, lr) and torch.equal(si, li)


@pytest.mark.parametrize("n", [1 << k for k in range(1, 14)])
@pytest.mark.parametrize("batch", ("one", "partial", "wrap"))
def test_fft_stockham_manual_vs_plain(card, n, batch):
    """The copy-ring kernel (both signs) in float32 against its float64
    plain version and torch.fft: >= 100 dB, one launch each, at every n
    from 2 to 8192 (an odd and an even number of register passes, so the
    result ends in the work tile or in the slot) and at the ring's edges:
    one row (fewer tiles than slots; at n = 2 too short for a bulk copy),
    300 rows (a partial last tile below n = 1024), and 3 grid + 1 tiles
    (every CTA fills its ring and one takes a tile more)."""
    rows = fk.manual_ring(n)[0]
    b = {"one": 1, "partial": 300, "wrap": (3 * fk.manual_ctas(n, card) + 1) * rows}[batch]
    rng = np.random.default_rng(69)
    xr = torch.as_tensor(rng.standard_normal((b, n)), device=card)
    xi = torch.as_tensor(rng.standard_normal((b, n)), device=card)
    z = torch.complex(xr, xi)
    for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
        (yr, yi), k = _launches(lambda: fk.fft_stockham_manual(xr.float(), xi.float(), sign))
        assert k == {"fft_stockham_manual": 1} and yr.shape == (b, n)
        rr, ri = fk.fft_stockham_manual_ref(xr, xi, sign)
        assert snr_db(torch.cat([rr, ri]), torch.cat([yr, yi])) >= 100.0
        assert snr_db(torch.cat([lib.real, lib.imag]), torch.cat([yr, yi])) >= 100.0


@pytest.mark.parametrize("b,n", ((32000, 512), (119808, 512), (4096, 1024), (4096, 4096)))
def test_fft_stockham_manual_at_the_main_path_rows(card, b, n):
    """The copy-ring kernel at the rows the stockham_split slice gives it
    (32000 and 119808 rows of 512 points) and at two timed points: 5 to 76
    tiles a CTA, so a slot's barrier parity flips back and forth; >= 100
    dB against its float64 plain version and torch.fft, one launch each."""
    gen = torch.Generator(device=card).manual_seed(70)
    xr = torch.randn((b, n), generator=gen, dtype=torch.float64, device=card)
    xi = torch.randn((b, n), generator=gen, dtype=torch.float64, device=card)
    z = torch.complex(xr, xi)
    for sign, lib in ((-1.0, torch.fft.fft(z)), (1.0, torch.fft.ifft(z) * n)):
        (yr, yi), k = _launches(lambda: fk.fft_stockham_manual(xr.float(), xi.float(), sign))
        assert k == {"fft_stockham_manual": 1} and yr.shape == (b, n)
        rr, ri = fk.fft_stockham_manual_ref(xr, xi, sign)
        assert snr_db(torch.cat([rr, ri]), torch.cat([yr, yi])) >= 100.0
        assert snr_db(torch.cat([lib.real, lib.imag]), torch.cat([yr, yi])) >= 100.0


def test_sk_pipe_routes_every_stockham_caller(card, monkeypatch):
    """ASP_SK_PIPE=manual: ops.fft with stockham (complex) and
    stockham_split (real) and ops.stft/istft launch fft_stockham_manual and
    not fft_stockham_lanes; the fused rfft_stockham stays as it is; without
    the pipe the same calls launch fft_stockham_lanes."""
    from audiosignalprocess_tpu_torch.ops.stft import istft, stft

    rng = np.random.default_rng(70)
    x = torch.as_tensor(rng.standard_normal((2, 3, 1024)), device=card)
    z = torch.complex(x, x.flip(-1))
    sig = torch.as_tensor(rng.standard_normal((2, 8192)), device=card)
    spec64 = stft(sig, 1024, 256, impl="torch")
    calls = (
        (lambda: fft.fft(z.to(torch.complex64), impl="stockham"), torch.fft.fft(z)),
        (lambda: fft.ifft(z.to(torch.complex64), impl="stockham"), torch.fft.ifft(z)),
        (lambda: fft.rfft(x.float(), impl="stockham_split"), torch.fft.rfft(x)),
        (lambda: fft.irfft(torch.fft.rfft(x).to(torch.complex64), 1024, impl="stockham_split"),
         x),
        (lambda: stft(sig.float(), 1024, 256, impl="stockham_split"), spec64),
    )
    for pipe, name in (("manual", "fft_stockham_manual"), ("auto", "fft_stockham_lanes")):
        monkeypatch.setenv("ASP_SK_PIPE", pipe)
        for call, ref in calls:
            out, k = _launches(call)
            assert k == {name: 1}
            if out.is_complex():
                out, ref = torch.view_as_real(out), torch.view_as_real(ref)
            assert snr_db(ref, out) >= 100.0
        y, k = _launches(lambda: istft(spec64.to(torch.complex64), 1024, 256,
                                       impl="stockham_split"))
        assert k == {name: 1} and snr_db(istft(spec64, 1024, 256, impl="torch"), y) >= 100.0
    monkeypatch.setenv("ASP_SK_PIPE", "manual")
    _, k = _launches(lambda: fft.rfft(x.float(), impl="stockham"))
    assert k == {"rfft_stockham": 1}


def test_fft_stockham_manual_unaligned_input_never_reaches_a_bulk_copy(card):
    """A contiguous view 4 bytes past an aligned start (x[1:] of 2-point
    rows) is copied by the wrapper and transforms right; the launcher
    itself refuses a misaligned plane before any copy is issued."""
    import ctypes

    from audiosignalprocess_tpu_torch.kernels._build import kernel_fn

    rng = np.random.default_rng(71)
    x64 = torch.as_tensor(rng.standard_normal((301, 2)), device=card)
    x = x64.float()
    assert x[1:].data_ptr() % 16 != 0
    (yr, yi), k = _launches(lambda: fk.fft_stockham_manual(x[1:], x[1:], -1.0))
    assert k == {"fft_stockham_manual": 1}
    rr, ri = fk.fft_stockham_manual_ref(x64[1:], x64[1:], -1.0)
    assert snr_db(torch.cat([rr, ri]), torch.cat([yr, yi])) >= 100.0
    rows, nbuf, smem = fk.manual_ring(2)
    out = torch.empty_like(x)
    args = fk.FftManualArgs(x[1:].data_ptr(), x.data_ptr(), out.data_ptr(), out.data_ptr(),
                            fk.fft_twiddles(2, card).data_ptr(), 300, 2, -1, rows, nbuf, 1)
    rc = kernel_fn("asp_fft_stockham_manual", 1)(ctypes.byref(args), smem, card.index or 0,
                                                  torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_fft_stockham_manual_ring_limit_raises(card):
    """Past n = 8192 not even a 2-slot ring of one row fits in shared
    memory: a ValueError naming the limit, before any launch."""
    z = torch.zeros((2, 16384), dtype=torch.float32, device=card)
    before = fk.fft_stockham_manual.launches
    with pytest.raises(ValueError, match="SMEM_LIMIT"):
        fk.fft_stockham_manual(z, z, -1.0)
    assert fk.fft_stockham_manual.launches == before


@pytest.mark.parametrize("impl,want", [("auto", {"rfft_stockham": 1, "irfft_stockham": 1}),
                                       ("stockham_split", {"fft_stockham_lanes": 2})])
def test_time_stretch_grid_on_the_last_frame(card, impl, want):
    """Where the float frame grid lands on the last frame ((2, 3000), rate
    0.7, nfft 256, hop 64), the stretch through the Stockham kernels is
    finite everywhere and reads >= 60 dB against the port's float64 run
    on the CPU (which the CPU tests hold to the JAX package wherever it is
    finite)."""
    from audiosignalprocess_tpu_torch.effects.phase_vocoder import time_stretch

    x = np.random.default_rng(2).standard_normal((2, 3000))
    ref = time_stretch(torch.as_tensor(x), 0.7, 256, 64)
    y, k = _launches(lambda: time_stretch(torch.as_tensor(x, dtype=torch.float32,
                                                          device=card), 0.7, 256, 64, impl=impl))
    assert k == want and y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref, y.cpu()) >= 60.0


@pytest.mark.parametrize("impl", ("auto", "stockham", "stockham_split"))
def test_empty_inputs_launch_nothing(card, impl):
    """ops.stft.istft of zero frames (zeros of length nfft - hop) and
    ops.overlap_save of an empty signal (an empty result), plain and fused,
    on CUDA float32: the results without a launch of rfft_stockham,
    irfft_stockham, fft_stockham_lanes or overlap_save_fused, which the
    same calls reach on non-empty input."""
    from audiosignalprocess_tpu_torch.ops.stft import istft

    spec = torch.zeros((2, 0, 129), dtype=torch.complex64, device=card)
    y, k = _launches(lambda: istft(spec, 256, 64, impl=impl))
    assert k == {} and y.shape == (2, 192) and y.dtype == torch.float32 and y.is_cuda
    assert not bool(y.any())
    x = torch.zeros((2, 0), dtype=torch.float32, device=card)
    h = design_fir(5, 0.3)
    for fused in (False, True):
        y, k = _launches(lambda: overlap_save(x, h, 64, impl=impl, fused=fused))
        assert k == {} and y.shape == (2, 0) and y.is_cuda
    _, k = _launches(lambda: (istft(torch.ones((2, 1, 129), dtype=torch.complex64, device=card),
                                    256, 64, impl=impl),
                              overlap_save(torch.ones((2, 5), device=card), h, 64, impl=impl),
                              overlap_save(torch.ones((2, 5), device=card), h, 64, fused=True)))
    cores = ({"fft_stockham_lanes": 3} if impl == "stockham_split"
             else {"rfft_stockham": 1, "irfft_stockham": 2})
    assert k == {**cores, "overlap_save_fused": 1}


def test_ops_fft_auto_launches_one_kernel(card):
    """ops.fft with the default impl on CUDA float32: one Stockham launch
    per transform; float64 stays on torch.fft with none."""
    rng = np.random.default_rng(64)
    x = torch.as_tensor(rng.standard_normal((2, 3, 1024)), device=card)
    z = torch.complex(x, x.flip(-1))
    for call, name in ((lambda: fft.fft(z.to(torch.complex64)), "fft_stockham_lanes"),
                       (lambda: fft.ifft(z.to(torch.complex64)), "fft_stockham_lanes"),
                       (lambda: fft.rfft(x.float()), "rfft_stockham"),
                       (lambda: fft.irfft(torch.fft.rfft(x).to(torch.complex64), 1024),
                        "irfft_stockham")):
        _, k = _launches(call)
        assert k == {name: 1}
    out, k = _launches(lambda: (fft.fft(z), fft.rfft(x)))
    assert k == {}
    assert snr_db(torch.view_as_real(torch.fft.fft(z)),
                  torch.view_as_real(fft.fft(z.to(torch.complex64)))) >= 100.0


def test_unfused_gate_and_overlap_save_launch_the_real_ffts(card):
    """GateStage(fused=False).full and ops.overlap_save on CUDA float32: one
    rfft_stockham and one irfft_stockham, nothing else."""
    rng = np.random.default_rng(65)
    x = torch.as_tensor(_tone_burst(rng, 3, 40000), device=card)
    y, k = _launches(lambda: GateStage(noise_frames=4).full(x.float()))
    assert k == {"rfft_stockham": 1, "irfft_stockham": 1}
    assert snr_db(GateStage(noise_frames=4).full(x), y) >= 60.0
    h = design_fir(64, 0.3)
    y, k = _launches(lambda: overlap_save(x.float(), h, 1024))
    assert k == {"rfft_stockham": 1, "irfft_stockham": 1}
    assert snr_db(overlap_save(x, h, 1024), y) >= 100.0


GATE_GRID = [(nfft, nfft // div, release) for nfft in (256, 512, 1024, 2048, 4096)
             for div in (2, 4, 8) for release in (0.0, 0.6)]


@pytest.mark.parametrize("c,n,nfft,hop,release", [
    (3, 48128, 1024, 256, 0.0), (3, 48128, 1024, 256, 0.9), (2, 40960 + 333, 2048, 512, 0.0),
    (2, 30000, 512, 128, 0.5),
    *((1 if k % 2 else 3, 60000 + 77 * k, *case) for k, case in enumerate(GATE_GRID)),
])
def test_noise_gate_kernel_vs_plain(card, c, n, nfft, hop, release):
    """noise_gate_fused float32 against its float64 plain version, over
    nfft 256 to 4096 (a warp spanning transforms below 512), hops nfft/2
    to nfft/8 and both launches: exact length, finite, >= 60 dB, one
    launch and no other kernel."""
    rng = np.random.default_rng(66)
    x = torch.as_tensor(_tone_burst(rng, c, n), device=card)
    y, k = _launches(lambda: noise_gate_fused(x.float(), nfft, hop, release=release))
    assert k == {"noise_gate_fused": 1}
    ref = noise_gate_ref(x, nfft, hop, release=release)
    assert y.shape == ref.shape == (c, nfft + ((n - nfft) // hop) * hop)
    assert bool(torch.isfinite(y).all()) and snr_db(ref, y) >= 60.0


@pytest.mark.parametrize("name,kw,bar", [
    ("noise_gate_file", {}, 60.0), ("lowpass_file", dict(cutoff_hz=3000.0), 100.0),
    ("bandpass_file", dict(lo_hz=300.0, hi_hz=3000.0), 100.0),
    ("envelope_file", {}, 100.0), ("time_stretch_file", dict(rate_factor=1.25), 60.0),
    ("pitch_shift_file", dict(semitones=3.0), 60.0),
])
def test_one_shots_cuda_vs_cpu(card, tmp_path, name, kw, bar):
    rng = np.random.default_rng(67)
    p = str(tmp_path / "in.wav")
    write_wav(p, (0.5 * _tone_burst(rng, 2, 48000)).astype(np.float32), 48000,
              float_fmt=True)
    outs = {}
    for d in ("cuda", "cpu"):
        getattr(api, name)(p, str(tmp_path / f"{d}.wav"), device=d, float_fmt=True, **kw)
        outs[d] = read_wav(str(tmp_path / f"{d}.wav"), dtype=np.float64)[0]
    assert outs["cuda"].shape == outs["cpu"].shape
    assert snr_db(outs["cpu"], outs["cuda"]) >= bar


# ---------------------------------------------------------------------------
# the phase vocoder: stretch_step_fused and the whole-file routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drain", (False, True))
@pytest.mark.parametrize("nfft,hop", ((256, 64), (1024, 256), (2048, 512)))
@pytest.mark.parametrize("p,q", ((4, 3), (3, 4), (1, 2), (147, 160)))
def test_stretch_step_vs_plain(card, p, q, nfft, hop, drain):
    """StretchStage(fused=True) float32, one stretch_step_fused launch per
    block and no other kernel, against the float64 (>= 60 dB) and float32
    (>= 65 dB) plain step streams on the same card."""
    rng = np.random.default_rng(71)
    block = p * max(1, 16 // p + 1) * hop
    n = 5 * block + (321 if drain else 0)
    x = torch.as_tensor(rng.standard_normal((3, n)), device=card)
    kern, plain = Chain([StretchStage(p, q, nfft=nfft, hop=hop, fused=True)]), \
        Chain([StretchStage(p, q, nfft=nfft, hop=hop)])
    kern.build()
    blocks = kern.drain_blocks(n, block) if drain else n // block
    y, counts = _launches(lambda: kern.stream(x.float(), block, drain=drain))
    assert counts == {"stretch_step_fused": blocks}
    ref64 = plain.stream(x, block, drain=drain)
    ref32 = plain.stream(x.float(), block, drain=drain)
    assert y.shape == ref64.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref64, y) >= 60.0
    assert snr_db(ref32, y) >= 65.0


STRETCH_GRID = [(4, 1), (16, 4), (256, 64), (1024, 256), (4096, 1024), (8192, 2048)]


@pytest.mark.parametrize("nfft,hop", STRETCH_GRID)
@pytest.mark.parametrize("p,q", ((4, 3), (3, 4), (1, 2), (147, 160)))
def test_stretch_step_kernel_every_nfft(card, p, q, nfft, hop):
    """StretchStage(fused=True) float32 over nfft 4 to 8192 (a cluster of
    two CTAs a channel up to 4096, one CTA of 512 threads at 8192), the
    four rates, drained: one stretch_step_fused launch per block, every
    output and carry of every step written (NaN-filled before each call),
    >= 60 dB against the float64 and >= 65 dB against the float32 plain
    step streams."""
    rng = np.random.default_rng(76)
    block = p * max(1, 16 // p + 1) * hop
    n = (3 if p > 16 else 5) * block + 321
    x = torch.as_tensor(rng.standard_normal((2, n)), device=card)
    kern = Chain([StretchStage(p, q, nfft=nfft, hop=hop, fused=True)])
    plain = Chain([StretchStage(p, q, nfft=nfft, hop=hop)])
    kern.build()
    blocks = kern.drain_blocks(n, block)
    before = stretch_step_fused.launches
    ok = _nan_steps(kern)
    y = kern.stream(x.float(), block, drain=True)
    torch.cuda.synchronize()
    del kern.step
    assert stretch_step_fused.launches == before + blocks
    assert len(ok) == blocks and all(ok)
    ref64 = plain.stream(x, block, drain=True)
    ref32 = plain.stream(x.float(), block, drain=True)
    assert y.shape == ref64.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref64, y) >= 60.0
    assert snr_db(ref32, y) >= 65.0


def test_stretch_from_rate_irrational_vs_plain(card):
    rng = np.random.default_rng(72)
    st = StretchStage.from_rate(2.0 ** (1.0 / 3.0), 64, nfft=256, hop=64, fused=True)
    block = st.p * max(1, 16 // st.p + 1) * 64
    x = torch.as_tensor(rng.standard_normal((2, 4 * block)), device=card)
    kern = Chain([st])
    y, counts = _launches(lambda: kern.stream(x.float(), block))
    assert counts == {"stretch_step_fused": 4}
    ref = Chain([StretchStage(st.p, st.q, nfft=256, hop=64)]).stream(x, block)
    assert snr_db(ref, y) >= 60.0


def test_stretch_carry_switches_between_kernel_and_plain(card):
    """One carry layout: blocks alternate between the kernel and the plain
    float32 step; the stream equals the kernel-only stream."""
    rng = np.random.default_rng(73)
    block = 16 * 256
    x = torch.as_tensor(rng.standard_normal((2, 8 * block)), device=card, dtype=torch.float32)
    stage = StretchStage(4, 3, fused=True)
    chain = Chain([stage])
    ref = chain.stream(x, block)
    st = chain.init_state((2,), block, torch.float32, card)
    ys = []
    for k in range(8):
        xb = x[:, k * block : (k + 1) * block]
        if k % 2:
            st, y = chain.step(st, xb)
        else:
            s0, y = stretch_step_ref(xb, st[0], **stage._step_kw())
            st = [s0]
        ys.append(y)
    assert st[0]["blk"] == 8
    assert snr_db(ref, torch.cat(ys, dim=-1)) >= 65.0


def test_stretch_streams_launch_counts(card):
    """S3: stretch 1/2 then resample 1/2 streamed: one stretch_step_fused
    and one resample_mac per block, >= 60 dB against the float64 whole
    file."""
    rng = np.random.default_rng(74)
    x = torch.as_tensor(rng.standard_normal((2, 10 * 4096 + 99)), device=card)
    chain = Chain([StretchStage(1, 2, fused=True), ResampleStage(1, 2, fused=True)])
    chain.build()
    blocks = chain.drain_blocks(x.shape[-1], 4096)
    y, counts = _launches(lambda: chain.stream(x.float(), 4096, drain=True))
    assert counts == {"stretch_step_fused": blocks, "resample_mac": blocks}
    assert snr_db(chain.full_flush(x), y) >= 60.0


def test_vocoder_whole_file_launch_counts(card, tmp_path):
    """W1/W2: a whole-file stretch runs one rfft_stockham and one
    irfft_stockham (StretchStage.full_flush, api.time_stretch_file), a
    pitch shift those and one resample_mac."""
    rng = np.random.default_rng(75)
    x = torch.as_tensor(rng.standard_normal((3, 40000)), device=card)
    real = {"rfft_stockham": 1, "irfft_stockham": 1}
    chain = Chain([StretchStage(4, 3)])
    y, counts = _launches(lambda: chain.full_flush(x.float()))
    assert counts == real and snr_db(chain.full_flush(x), y) >= 60.0
    p = str(tmp_path / "in.wav")
    write_wav(p, (0.5 * _tone_burst(rng, 2, 48000)).astype(np.float32), 48000, float_fmt=True)
    for name, kw, want in (("time_stretch_file", dict(rate_factor=1.25), real),
                           ("pitch_shift_file", dict(semitones=3.0),
                            dict(real, resample_mac=1))):
        _, counts = _launches(lambda: getattr(api, name)(p, str(tmp_path / "o.wav"),
                                                         float_fmt=True, **kw))
        assert counts == want, name


@pytest.mark.parametrize("t,n_sh,l", [(0, 4, 16384), (1, 4, 16384), (3, 4, 16384), (3, 4, 512)])
def test_gate_shard_vs_plain(card, t, n_sh, l):
    """One time shard of the sharded gate (the file's start, a middle shard,
    an end shard with frames past the file's end, one with none valid):
    float32 kernel vs the float64 plain version, >= 60 dB, the
    un-normalized overlap-add of (l + d) samples, zeros past the last valid
    frame, one launch."""
    nfft, hop, d = 1024, 256, 768
    rng = np.random.default_rng(76 + t)
    x = torch.as_tensor(_tone_burst(rng, 3, n_sh * l), device=card)
    xp = torch.nn.functional.pad(x, (0, d))
    ext = xp[:, t * l : (t + 1) * l + d]
    n_valid = min(max((n_sh * l - nfft - t * l) // hop + 1, 0), l // hop)
    floors = {}
    for dt in (torch.float32, torch.float64):
        w = window("hann", nfft, periodic=True, dtype=dt, device=card)
        floors[dt] = noise_floor(frame(xp[:, : d + 8 * hop].to(dt), nfft, hop) * w)
    before = gate_shard_fused.launches
    y = gate_shard_fused(ext.float().contiguous(), floors[torch.float32], n_valid, nfft, hop)
    torch.cuda.synchronize()
    assert gate_shard_fused.launches == before + 1
    ref = gate_shard_ref(ext, floors[torch.float64], n_valid, nfft, hop)
    assert y.shape == ref.shape == (3, l + d) and bool(torch.isfinite(y).all())
    end = max(n_valid - 1, 0) * hop + nfft if n_valid else 0
    assert not bool(y[:, end:].any())
    if n_valid:
        assert snr_db(ref, y) >= 60.0


@pytest.mark.parametrize("nfft,hop,l_hops,n_valid", [
    (1024, 256, 468, 1), (1024, 256, 468, 100), (1024, 256, 468, 465), (1024, 256, 67, 0),
    (512, 128, 101, 37), (2048, 512, 75, 70), (256, 32, 300, 299),
])
def test_gate_shard_tail_is_written_zero(card, nfft, hop, l_hops, n_valid):
    """A shard whose valid frames stop short of l/hop (the file's end inside
    it): the (l + d)-sample output finite, 0 from the last valid frame's
    end on (the tiles past every frame write only zeros), >= 60 dB against
    the float64 plain version before it, one launch."""
    rng = np.random.default_rng(79 + n_valid)
    d = nfft - hop
    ext = torch.as_tensor(_tone_burst(rng, 3, l_hops * hop + d), device=card)
    w = window("hann", nfft, periodic=True, dtype=torch.float64, device=card)
    floor = noise_floor(frame(ext[:, : d + 8 * hop], nfft, hop) * w)
    y, k = _launches(lambda: gate_shard_fused(ext.float(), floor.float(), n_valid, nfft, hop))
    assert k == {"gate_shard_fused": 1}
    ref = gate_shard_ref(ext, floor, n_valid, nfft, hop)
    assert y.shape == ref.shape == ext.shape and bool(torch.isfinite(y).all())
    end = (n_valid - 1) * hop + nfft if n_valid else 0
    assert not bool(y[:, end:].any())
    if n_valid:
        assert snr_db(ref, y) >= 60.0


@pytest.mark.parametrize("shard,nfft,hop,arg", [
    (False, 1024, 256, 0.0), (False, 256, 32, 0.6), (False, 4096, 512, 0.0),
    (True, 1024, 256, 100), (True, 1024, 256, 0), (True, 512, 64, 467),
])
def test_gate_kernels_write_every_position(card, shard, nfft, hop, arg):
    """Both C entry points launched into NaN-filled outputs, with the
    wrapper's own arguments (gate_geometry, file_tables, the floor): every
    position written (finite), and bit-equal to the wrapper's output on
    the same input, which allocates it with torch.empty.  ``arg``: the
    release of the whole-file gate, or the shard's n_valid (of 468 hops)."""
    import ctypes

    from audiosignalprocess_tpu_torch.kernels import gate_kernel as gk

    rng = np.random.default_rng(80 + nfft)
    d = nfft - hop
    x = torch.as_tensor(_tone_burst(rng, 2, 468 * hop + d), dtype=torch.float32, device=card)
    win, twf, twi, inv_tab = gk.file_tables(nfft, hop, "hann", card)
    floor = noise_floor(frame(x[:, : d + 8 * hop], nfft, hop) * win).contiguous()
    geo = gk.gate_geometry(nfft, hop, not shard and arg > 0.0)
    gain, att = ctypes.c_float(10.0 ** 0.3), ctypes.c_float(10.0 ** -3.0)
    stream = torch.cuda.current_stream(card).cuda_stream
    if shard:
        want = gate_shard_fused(x, floor, arg, nfft, hop)
        out = torch.full_like(x, float("nan"))
        spans = gk.regs_span_rows(nfft, hop, geo, 2, out.shape[-1], False, card)
        rc = gk._shard_lib()(x.data_ptr(), out.data_ptr(), floor.data_ptr(), win.data_ptr(),
                             twf.data_ptr(), twi.data_ptr(), gk.data_ptr(spans), 2,
                             x.shape[-1], nfft, nfft.bit_length() - 1, hop, arg, geo["mf"],
                             gain, att, geo["smem"], card.index or 0, stream)
    else:
        want = noise_gate_fused(x, nfft, hop, release=arg)
        out = torch.full_like(want, float("nan"))
        nframes = 1 + (x.shape[-1] - nfft) // hop
        spans = gk.regs_span_rows(nfft, hop, geo, 2, out.shape[-1], arg > 0.0, card)
        rc = gk._lib()(x.data_ptr(), out.data_ptr(), floor.data_ptr(), win.data_ptr(),
                       twf.data_ptr(), twi.data_ptr(), inv_tab.data_ptr(), gk.data_ptr(spans),
                       2, x.shape[-1], nfft, nfft.bit_length() - 1, hop, nframes, geo["mf"],
                       int(arg > 0.0), gain, att, ctypes.c_float(arg), geo["smem"],
                       card.index or 0, stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool(torch.isfinite(out).all()) and torch.equal(out, want)


def _queue3_input(card, n=69632):
    """The input of the nfft 8192 fault: (1, n) float64, 0.01 x
    default_rng(0) noise plus a unit 440 Hz sine over the middle third."""
    x = 0.01 * np.random.default_rng(0).standard_normal((1, n))
    t = np.arange(n) / 48000
    x[0, n // 3 : 2 * n // 3] += np.sin(2 * np.pi * 440.0 * t[n // 3 : 2 * n // 3])
    return torch.as_tensor(x, device=card)


@pytest.mark.parametrize("release", (0.0, 0.6))
@pytest.mark.parametrize("name", ("noise_gate_fused", "fir_noise_gate_fused",
                                  "resample_fir_gate_fused", "gate_shard_fused"))
def test_whole_file_kernels_at_nfft_8192(card, name, release):
    """The four whole-file kernels at nfft 8192, hop 2048 (one transform of
    512 threads a batch, one exchange buffer), release 0 and 0.6 (the shard
    has none: its n_valid short of l/hop instead): one launch, no other
    kernel, the exact length, finite, >= 60 dB against the float64 plain
    version, with design_fir(64, 0.3) for the chains."""
    x = _queue3_input(card)
    h = design_fir(64, 0.3)
    kw = dict(nfft=8192, hop=2048, release=release)
    if name == "noise_gate_fused":
        y, k = _launches(lambda: noise_gate_fused(x.float(), **kw))
        ref = noise_gate_ref(x, **kw)
    elif name == "fir_noise_gate_fused":
        y, k = _launches(lambda: fir_noise_gate_fused(x.float(), h, **kw))
        ref = fir_noise_gate_ref(x, h, **kw)
    elif name == "resample_fir_gate_fused":
        xr = x[:, : 69632 * 147 // 160]
        y, k = _launches(lambda: resample_fir_gate_fused(xr.float(), 160, 147, h, **kw))
        ref = resample_fir_gate_ref(xr, 160, 147, h, **kw)
    else:
        d = 8192 - 2048
        ext = x[:, : 30 * 2048 + d]
        w = window("hann", 8192, periodic=True, dtype=torch.float64, device=card)
        floor = noise_floor(frame(ext[:, : d + 8 * 2048], 8192, 2048) * w)
        n_valid = 27 if release else 30
        y, k = _launches(lambda: gate_shard_fused(ext.float(), floor.float(), n_valid, 8192,
                                                  2048))
        ref = gate_shard_ref(ext, floor, n_valid, 8192, 2048)
    assert k == {name: 1}
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert snr_db(ref, y) >= 60.0


@pytest.mark.parametrize("name", ("noise_gate_fused", "fir_noise_gate_fused",
                                  "resample_fir_gate_fused", "gate_shard_fused",
                                  "fir_gate_step_fused", "res_fir_gate_step_fused",
                                  "gate_step_fused", "stretch_step_fused"))
def test_kernels_raise_at_nfft_16384(card, name):
    """Past nfft 8192 one transform of the batched bodies needs more shared
    memory per block than SMEM_LIMIT: each wrapper raises a ValueError that
    names it, and launches nothing."""
    x = _queue3_input(card, 4 * 16384).float()
    h = design_fir(64, 0.3)
    kw = dict(nfft=16384, hop=4096)
    calls = {
        "noise_gate_fused": lambda: noise_gate_fused(x, **kw),
        "fir_noise_gate_fused": lambda: fir_noise_gate_fused(x, h, **kw),
        "resample_fir_gate_fused": lambda: resample_fir_gate_fused(x, 160, 147, h, **kw),
        "gate_shard_fused": lambda: gate_shard_fused(
            x[:, : 8 * 4096 + 12288], torch.ones(1, 8193, device=card), 5, **kw),
        "fir_gate_step_fused": lambda: Chain([FIRGateStage(h=h, noise_frames=4, **kw)]).stream(
            x[:, : 2 * 16384], 16384),
        "res_fir_gate_step_fused": lambda: Chain([ResFIRGateStage(
            h=h, noise_frames=4, **kw)]).stream(x[:, : 2 * 18816], 18816),
        "gate_step_fused": lambda: Chain([GateStage(fused=True, noise_frames=4, **kw)]).stream(
            x[:, : 2 * 16384], 16384),
        "stretch_step_fused": lambda: Chain([StretchStage(4, 3, fused=True, **kw)]).stream(
            x[:, : 2 * 16384], 16384),
    }
    before = {k.__name__: k.launches for k in _all_counters()}
    with pytest.raises(ValueError, match="SMEM_LIMIT"):
        calls[name]()
    assert {k.__name__: k.launches for k in _all_counters()} == before


def test_sharded_chain_nccl_world_1(card, tmp_path):
    """The config-5 composite as a sharded chain in a one-rank NCCL group
    on a 1x1 mesh: its components run resample_mac, overlap_save_fused and
    gate_shard_fused once each, >= 60 dB against the float64 plain chain."""
    import torch.distributed as dist

    from audiosignalprocess_tpu_torch import parallel

    rng = np.random.default_rng(77)
    x = torch.as_tensor(_tone_burst(rng, 2, 147 * 64, fs=44100), device=card)
    chain = Chain([ResFIRGateStage(160, 147, h=design_fir(64, 0.3), noise_frames=4)])
    chain.build()
    parallel.initialize(f"file://{tmp_path}/store", 1, 0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        mesh = parallel.make_mesh(1, 1)
        fn = parallel.sharded_chain(mesh, chain)
        y, counts = _launches(lambda: fn(parallel.shard_audio(x.float(), mesh)))
        parallel.warmup(fn, parallel.shard_audio(x.float(), mesh))
    finally:
        dist.destroy_process_group()
    assert counts == {"resample_mac": 1, "overlap_save_fused": 1, "gate_shard_fused": 1}
    ref = chain.full(x)
    assert y.shape == ref.shape and snr_db(ref, y) >= 60.0


def test_time_sharded_gate_gloo_on_the_card(card):
    """Two ranks sharing the card over gloo (CUDA tensors staged through
    host memory for every transfer): the time-sharded fused gate == the
    whole-file noise_gate_fused (>= 100 dB: the kernels pair frames into
    complex transforms from different tile origins) and >= 60 dB against
    the float64 plain gate."""
    import torch_dist_workers
    from audiosignalprocess_tpu_torch.parallel import spawn_local

    rng = np.random.default_rng(78)
    x = _tone_burst(rng, 2, 2 * 16384).astype(np.float32)
    cases = [("gate", "gate", (1, 2), dict(noise_frames=8, fused=True), x)]
    out = spawn_local(torch_dist_workers.run_cases, 2, backend="gloo", device="cuda",
                      args=(cases, "cuda"), timeout_s=240.0)[0]["gate"]
    import chip_smoke

    xc = torch.as_tensor(x, device=card)
    whole = noise_gate_fused(xc, noise_frames=8).cpu()
    got = torch.as_tensor(out[:, : whole.shape[-1]])
    assert snr_db(whole, got) >= 100.0
    # the hops that differ beyond rounding: each with a covering frame
    # paired otherwise in its shard's launch than in the whole file's
    err = (got - whole).abs().reshape(2, -1, 256).amax(dim=(0, 2))
    hops = torch.nonzero(err > 1e-5 * whole.abs().max()).flatten().numpy()
    assert chip_smoke.unexplained_hops(hops, x.shape[-1], 2) == []
    ref = noise_gate_ref(xc.double(), noise_frames=8).cpu()
    assert snr_db(ref, torch.as_tensor(out[:, : ref.shape[-1]])) >= 60.0
