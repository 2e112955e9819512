"""Composable processing chain: whole-file and block-streaming modes.

Mirrors the JAX package's ``pipeline.py``: a ``Chain`` of stages with
latency propagation (``build``), the rate-mapped output length
(``out_len``), the whole-signal paths ``full`` / ``full_flush`` and the
block streamer (``init_state`` / ``step`` / ``stream``), whose output
equals the whole-file output exactly in structure:

    stream(x, block)[..., L:] == full(x)[..., : emitted - L]   (L = latency)

and ``stream(x, block, drain=True) == full_flush(x)`` for any input
length, to floating-point reassociation (the stream sums the same terms
in another order).  The carry is a list with one entry per stage (tensors,
dicts of tensors and Python ints) and is checkpointable
(``utils/checkpoint``).  ``stream`` is a Python loop over the blocks that
writes into a preallocated output and never reads the device.

Stages with a hand-written kernel route by ``fused`` and tensor: with
``fused`` a CUDA float32 tensor launches the kernel, a CPU tensor runs the
kernel's plain version, and float64 takes the plain path on any device
(the kernels compute in float32), as the JAX package does on a TPU;
``fused=False`` takes the unfused route, plain PyTorch around ``ops.fft``
with the stage's ``impl`` (the Stockham kernels on a CUDA float32 tensor
by default).

Stage parameters carry over from the JAX package as plain dictionaries:
``Chain.from_params([dict(dataclasses.asdict(jax_stage), stage=name)])``
builds the chain that computes the same thing.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.effects.phase_vocoder import stretch_spec_rational
from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
    fir_gate_step_fused, fir_gate_step_ref, fir_noise_gate_fused, history_tail,
)
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (
    gate_step_fused, gate_step_init_state, gate_step_ref,
)
from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (
    res_fir_gate_step_fused, res_fir_gate_step_ref, resample_fir_gate_fused,
)
from audiosignalprocess_tpu_torch.kernels.stretch_kernel import (
    stretch_block_frames, stretch_slots, stretch_step_fused, stretch_step_init_state,
    stretch_step_ref,
)
from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.fir import fir_direct
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.resample import (
    history_len, resample_filter, resample_poly,
)
from audiosignalprocess_tpu_torch.ops.stft import istft, stft
from audiosignalprocess_tpu_torch.utils.profiling import span
from audiosignalprocess_tpu_torch.utils.validate import check

_NOT_CARRIED = ("impl", "fused", "input_latency")
"""JAX stage fields that are execution choices or set by ``Chain.build``.
``from_params`` keeps those the port's stage has as fields (``fused`` and
``impl`` on every stage but ``ResampleStage``, which has no ``impl``; a
JAX impl name resolves in ``ops.fft``) and drops the rest."""


def _pad_to(y: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis of y up to n samples."""
    return torch.cat([y, y.new_zeros(y.shape[:-1] + (n - y.shape[-1],))], dim=-1)


class Stage:
    """Stage protocol.  Latency is in output samples."""

    latency: int = 0
    input_latency: int = 0
    _eof_n: int | None = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # the spans around this class's calls (Chain, parallel.sharded),
        # named once rather than at every block
        cls.span_step = f"asp.{cls.__name__}.step"
        cls.span_full = f"asp.{cls.__name__}.full"
        cls.span_shard = f"asp.shard.{cls.__name__}"

    @classmethod
    def from_params(cls, params: dict) -> Stage:
        """Build from the JAX package's stage fields, as
        ``dataclasses.asdict`` gives them."""
        own = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in params.items()
                      if k in own or k not in _NOT_CARRIED})

    def configure(self, input_latency: int) -> int:
        """Receive the cumulative upstream latency; return this stage's
        output latency."""
        self.input_latency = input_latency
        return input_latency + self.latency

    def out_block(self, b: int) -> int:
        return b

    def out_len(self, n: int) -> int:
        """Whole-file output length for input length n."""
        return n

    def tail_width(self, t: int) -> int:
        """If the input changes over its last t samples, at most the last
        ``tail_width(t)`` output samples differ (sizes a drained stream's
        flush blocks).  Causal sample maps: t."""
        return t

    # -- end of file (drained streams) -------------------------------------
    # Chain.stream(drain=True) arms each stage with the length of its real
    # input; frame-based stages then drop frames straddling end-of-file and
    # switch their emission norm to the finite-file ramp-out, so the
    # drained stream reproduces full().  Causal sample maps need nothing.

    def set_eof(self, n_in: int) -> None:
        """The real input occupies stream positions
        [input_latency, input_latency + n_in)."""
        self._eof_n = n_in

    def clear_eof(self) -> None:
        self._eof_n = None

    def _eof_in(self) -> int | None:
        return None if self._eof_n is None else self.input_latency + self._eof_n

    def full(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, batch: tuple, block: int, dtype=torch.float32, device=None):
        return ()

    def step(self, state, x):
        raise NotImplementedError


@dataclass
class FIRStage(Stage):
    """Causal FIR, direct form or overlap-save when ``nfft`` is given.
    Latency 0.  ``pre="abs"`` rectifies the input (the envelope follower);
    ``fused`` routes float32 through the hand-written kernels
    (``overlap_save_fused`` / ``fir_mac``); ``impl`` is the overlap-save's
    FFT implementation otherwise (``ops.fft``)."""

    h: np.ndarray
    nfft: int | None = None
    pre: str | None = None
    post_scale: float = 1.0
    fused: bool = False
    impl: str = fft_ops.DEFAULT_IMPL

    def __post_init__(self):
        self.h = np.asarray(self.h, np.float64)
        check(self.pre in (None, "abs"), f"pre must be None or 'abs', got {self.pre!r}")

    def _apply(self, x, history):
        if self.pre == "abs":
            x = x.abs()
        fused = self.fused and x.dtype != torch.float64
        if self.nfft is not None:
            y = overlap_save(x, self.h, self.nfft, history=history, impl=self.impl,
                             fused=fused)
        else:
            y = fir_direct(x, self.h, history=history, fused=fused)
        return y * self.post_scale if self.post_scale != 1.0 else y

    def full(self, x):
        return self._apply(x, None)

    def init_state(self, batch, block, dtype=torch.float32, device=None):
        return torch.zeros(batch + (len(self.h) - 1,), dtype=dtype, device=device)

    def step(self, state, x):
        y = self._apply(x, state)
        xin = x.abs() if self.pre == "abs" else x
        return history_tail(state, xin, len(self.h)), y


def EnvelopeStage(h, fused: bool = False) -> FIRStage:
    """Envelope follower as a stage: |x| -> FIR lowpass -> * pi/2."""
    return FIRStage(h=np.asarray(h), pre="abs", post_scale=math.pi / 2.0, fused=fused)


@dataclass
class ResampleStage(Stage):
    """Causal polyphase rational resampler.  Latency 0 (the filter's group
    delay is part of the signal, not stream misalignment).  Blocks and the
    upstream latency must be multiples of ``down``; the carry is the last
    ``history_len`` raw samples.  ``fused`` routes float32 through the
    hand-written ``resample_mac``."""

    up: int
    down: int
    h: np.ndarray | None = None
    fused: bool = False

    def __post_init__(self):
        g = math.gcd(self.up, self.down)
        self.up //= g
        self.down //= g
        if self.h is None:
            self.h = resample_filter(self.up, self.down)
        self.h = np.asarray(self.h, dtype=np.float64)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.down == 0,
              f"upstream latency {input_latency} not a multiple of down={self.down}")
        self.input_latency = input_latency
        return input_latency * self.up // self.down

    def out_block(self, b):
        check(b % self.down == 0, f"block {b} not a multiple of down={self.down}")
        return b * self.up // self.down

    def out_len(self, n):
        return -(-n * self.up // self.down)

    def tail_width(self, t):
        return -(-t * self.up // self.down) + 1

    def _resample(self, x, history):
        return resample_poly(x, self.up, self.down, h=self.h, zero_phase=False,
                             history=history,
                             fused=self.fused and x.dtype != torch.float64)

    def full(self, x):
        return self._resample(x, None)

    def init_state(self, batch, block, dtype=torch.float32, device=None):
        return torch.zeros(batch + (history_len(len(self.h), self.up, self.down),),
                           dtype=dtype, device=device)

    def step(self, state, x):
        y = self._resample(x, state)
        hn = state.shape[-1]
        return (torch.cat([state, x], dim=-1)[..., -hn:] if hn else state), y


@dataclass
class GateStage(Stage):
    """Spectral noise gate (STFT -> mask -> WOLA ISTFT).

    Streaming carries the input tail of nfft-hop samples, a spectral FIFO
    of ``noise_frames`` frames (so every frame is masked with the final
    noise floor, as the whole-file gate does) and the un-emitted OLA tail
    (``kernels/gate_kernel``).  Latency = (nfft-hop) + noise_frames*hop
    output samples; the whole-file output is aligned to the input.
    ``fused`` routes float32 through the hand-written kernels:
    ``noise_gate_fused`` for the whole file, ``gate_step_fused`` per
    block (their plain versions on a CPU tensor); float64 takes the plain
    path on any device.  ``impl`` is the FFT implementation of the
    unfused route, whole file and step (``ops.fft``; a CUDA float32 tensor
    then runs one ``rfft_stockham`` and one ``irfft_stockham`` a call or
    a block by default).
    """

    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"
    fused: bool = False
    impl: str = fft_ops.DEFAULT_IMPL

    def __post_init__(self):
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")
        self.latency = (self.nfft - self.hop) + self.noise_frames * self.hop

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0,
              f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        return super().configure(input_latency)

    def tail_width(self, t):
        # the zero-pad tail of full() becomes true WOLA synthesis once later
        # frames exist: nfft-hop of overlap plus up to hop-1 of truncation
        return t + self.nfft - 1

    def full(self, x):
        """Whole-signal gate, zero-padded back to the input length (the
        gate's output is nfft-hop shorter)."""
        y = noise_gate(x, self.nfft, self.hop, self.threshold_db,
                       self.reduction_db, self.noise_frames, self.release,
                       self.window_kind, impl=self.impl,
                       fused=self.fused and x.dtype != torch.float64)
        return _pad_to(y, x.shape[-1])

    def set_eof(self, n_in: int) -> None:
        d = self.nfft - self.hop
        check(n_in >= self.nfft, f"drain needs >= one complete frame "
              f"(nfft={self.nfft}), got {n_in} input samples; use full()")
        nframes = 1 + (n_in - self.nfft) // self.hop
        check(nframes >= self.noise_frames,
              f"signal has {nframes} frames < noise_frames={self.noise_frames}")
        nout = self.nfft + (nframes - 1) * self.hop
        check(nout >= 2 * d, f"drain needs disjoint WOLA edge ramps "
              f"(synthesis length {nout} < {2 * d}); use full()")
        self._eof_n = n_in

    def _step_kw(self) -> dict:
        return dict(nfft=self.nfft, hop=self.hop, threshold_db=self.threshold_db,
                    reduction_db=self.reduction_db, noise_frames=self.noise_frames,
                    release=self.release, window_kind=self.window_kind,
                    input_latency=self.input_latency, latency=self.latency,
                    eof_in=self._eof_in())

    def init_state(self, batch, block, dtype=torch.float32, device=None):
        check(block % self.hop == 0 and block >= self.hop,
              f"block {block} not a multiple of hop={self.hop}")
        return gate_step_init_state(batch, self.nfft, self.hop, self.noise_frames,
                                    self.release, dtype, device)

    def step(self, state, x):
        if self.fused and x.dtype != torch.float64:
            return gate_step_fused(x, state, **self._step_kw())
        return gate_step_ref(x, state, impl=self.impl, **self._step_kw())


@dataclass
class FIRGateStage(Stage):
    """FIR -> spectral gate (-> envelope) composite, the headline 48 kHz
    chain.

    Equivalent to ``FIRStage(h, nfft) -> GateStage(nfft, hop, ...)``, with
    ``env_h`` also ``-> EnvelopeStage(env_h)`` (|y| -> FIR -> *
    ``env_scale``).  Routes by ``fused`` and tensor:

    - ``fused`` and float32: ``full`` runs ``fir_noise_gate_fused`` (then
      ``fir_mac`` for the envelope) and each streaming block one
      ``fir_gate_step_fused``, envelope included: the hand-written kernels
      on a CUDA tensor, their plain versions on a CPU tensor;
    - ``fused`` and float64 runs the composed plain path on any device, as
      the JAX package does (the kernels compute in float32);
    - ``fused=False`` runs the components, ``FIRStage`` -> ``GateStage``
      (-> the direct-form envelope), unfused with ``impl`` on any device
      and dtype: a CUDA float32 block under the default ``impl`` launches
      two ``rfft_stockham`` and two ``irfft_stockham`` (the FIR's and the
      gate's), the envelope runs ``conv1d``.

    Both routes take the same carry, ``[fir, gate(, env)]``.
    """

    h: np.ndarray = None
    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    fused: bool = True
    env_h: np.ndarray | None = None
    env_scale: float = math.pi / 2.0

    def __post_init__(self):
        check(self.h is not None, "FIRGateStage requires filter taps h")
        self.h = np.asarray(self.h, np.float64)
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")
        check(self.nfft > len(self.h) - 1, "nfft must exceed taps-1")
        self.latency = (self.nfft - self.hop) + self.noise_frames * self.hop
        # the components follow fused and impl: they are the unfused route,
        # and a sharded chain (parallel.sharded_chain) executes this stage
        # as them
        self._fir = FIRStage(h=self.h, nfft=self.nfft, fused=self.fused, impl=self.impl)
        self._gate = GateStage(
            nfft=self.nfft, hop=self.hop, threshold_db=self.threshold_db,
            reduction_db=self.reduction_db, noise_frames=self.noise_frames,
            release=self.release, window_kind=self.window_kind, fused=self.fused,
            impl=self.impl)
        self._env = None
        if self.env_h is not None:
            self.env_h = np.asarray(self.env_h, np.float64)
            check(len(self.env_h) >= 1, "the envelope FIR needs at least one tap")
            self._env = FIRStage(h=self.env_h, pre="abs",
                                 post_scale=self.env_scale, fused=self.fused)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0,
              f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        self._fir.configure(input_latency)
        self._gate.configure(input_latency)
        if self._env is not None:
            self._env.configure(input_latency + self.latency)
        return super().configure(input_latency)

    def tail_width(self, t):
        return t + self.nfft - 1  # see GateStage.tail_width

    def set_eof(self, n_in: int) -> None:
        # the FIR front is a 1:1 causal map: the gate sees the same EOF
        self._gate.set_eof(n_in)
        self._eof_n = n_in

    def clear_eof(self) -> None:
        self._gate.clear_eof()
        self._eof_n = None

    def full(self, x):
        if self.fused and x.dtype != torch.float64:
            y = _pad_to(fir_noise_gate_fused(
                x, self.h, self.nfft, self.hop, self.threshold_db,
                self.reduction_db, self.noise_frames, self.release,
                self.window_kind), x.shape[-1])
        else:
            y = self._gate.full(self._fir.full(x))
        return y if self._env is None else self._env.full(y)

    def init_state(self, batch, block, dtype=torch.float32, device=None):
        check(block % self.hop == 0 and block >= self.hop,
              f"block {block} not a multiple of hop={self.hop}")
        st = [self._fir.init_state(batch, block, dtype, device),
              self._gate.init_state(batch, block, dtype, device)]
        if self._env is not None:
            st.append(self._env.init_state(batch, block, dtype, device))
        return st

    def step(self, state, x):
        if not self.fused:
            stages = [self._fir, self._gate] + ([self._env] if self._env is not None else [])
            new = []
            for s, st in zip(stages, state):
                st, x = s.step(st, x)
                new.append(st)
            return new, x
        step = fir_gate_step_ref if x.dtype == torch.float64 else fir_gate_step_fused
        return step(x, state, self.h, env_h=self.env_h, env_scale=self.env_scale,
                    **self._gate._step_kw())


@dataclass
class ResFIRGateStage(Stage):
    """Resample -> FIR -> spectral gate (-> envelope) composite, the
    config-5 chain (44.1 -> 48 kHz at 160/147).

    Equivalent to ``ResampleStage(up, down, h_res) -> FIRGateStage(h,
    ...)``; latencies and positions after the resampler are in resampled
    samples.  Routes by ``fused`` and tensor:

    - ``fused`` and float32: ``full`` runs ``resample_fir_gate_fused``
      (then ``fir_mac`` for the envelope) and each streaming block one
      ``res_fir_gate_step_fused``, envelope included: the hand-written
      kernels on a CUDA tensor, their plain versions on a CPU tensor;
    - ``fused`` and float64 runs the composed plain path on any device;
    - ``fused=False`` runs ``ResampleStage(fused=False)`` ->
      ``FIRGateStage(fused=False, impl)`` on any device and dtype.

    The streaming carry is the composition's, ``[res_hist, FIRGateStage
    carry]``, for every route.  Blocks are multiples of the input quantum
    down*hop/gcd(up, hop) (``res_step_geometry``).
    """

    up: int = 160
    down: int = 147
    h: np.ndarray = None
    h_res: np.ndarray | None = None
    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    fused: bool = True
    env_h: np.ndarray | None = None
    env_scale: float = math.pi / 2.0

    def __post_init__(self):
        check(self.h is not None, "ResFIRGateStage requires filter taps h")
        self._res = ResampleStage(up=self.up, down=self.down, h=self.h_res, fused=self.fused)
        self.up, self.down, self.h_res = self._res.up, self._res.down, self._res.h
        self._fg = FIRGateStage(
            h=self.h, nfft=self.nfft, hop=self.hop, threshold_db=self.threshold_db,
            reduction_db=self.reduction_db, noise_frames=self.noise_frames,
            release=self.release, window_kind=self.window_kind, impl=self.impl,
            fused=self.fused, env_h=self.env_h, env_scale=self.env_scale)
        self.h, self.env_h = self._fg.h, self._fg.env_h
        self.latency = self._fg.latency  # resampled domain

    def configure(self, input_latency: int) -> int:
        self.input_latency = self._res.configure(input_latency)  # the gate's domain
        return self._fg.configure(self.input_latency)

    def out_block(self, b: int) -> int:
        return self._fg.out_block(self._res.out_block(b))

    def out_len(self, n: int) -> int:
        return self._fg.out_len(self._res.out_len(n))

    def tail_width(self, t: int) -> int:
        return self._fg.tail_width(self._res.tail_width(t))

    def set_eof(self, n_in: int) -> None:
        # the gate frames the resampled stream; positions past the
        # resampler's rate-mapped end of file are the polyphase history's
        # phantom continuation, which full() never analyzes
        self._fg.set_eof(self._res.out_len(n_in))
        self._eof_n = n_in

    def clear_eof(self) -> None:
        self._fg.clear_eof()
        self._eof_n = None

    def _fused_args(self) -> tuple:
        return (self.up, self.down, self.h, self.h_res)

    def full(self, x):
        if not self.fused or x.dtype == torch.float64:
            return self._fg.full(self._res.full(x))
        g = self._fg
        y = _pad_to(resample_fir_gate_fused(
            x, *self._fused_args(), g.nfft, g.hop, g.threshold_db, g.reduction_db,
            g.noise_frames, g.release, g.window_kind), self._res.out_len(x.shape[-1]))
        return y if g._env is None else g._env.full(y)

    def init_state(self, batch, block, dtype=torch.float32, device=None):
        # name the INPUT-domain quantum: the inner stages would report the
        # resampled block ("block 4800 not a multiple of hop=256" for 4410)
        quantum = self.down * (self.hop // math.gcd(self.up, self.hop))
        check(block % quantum == 0,
              f"block {block} not a multiple of this chain's input quantum "
              f"{quantum} (= down*hop/gcd(up,hop): the resampled block "
              f"{self.up}/{self.down}*block must be a multiple of hop={self.hop})")
        return [self._res.init_state(batch, block, dtype, device),
                self._fg.init_state(batch, self._res.out_block(block), dtype, device)]

    def step(self, state, x):
        if not self.fused:
            sr, y = self._res.step(state[0], x)
            sf, y = self._fg.step(state[1], y)
            return [sr, sf], y
        step = res_fir_gate_step_ref if x.dtype == torch.float64 else res_fir_gate_step_fused
        return step(x, state, *self._fused_args(), env_h=self.env_h,
                    env_scale=self.env_scale, **self._fg._gate._step_kw())


@dataclass
class StretchStage(Stage):
    """Streaming phase-vocoder time stretch at the exact rational rate p/q
    (analysis frames advanced per synthesis frame; p > q speeds up).

    - Output frame i samples analysis position t_i = i*p/q.  Blocks of m
      = block/hop frames with m*q % p == 0 emit exactly mo = m*q/p
      synthesis frames each.
    - The emission offset ``off`` (warm-up frames, latency/hop) makes
      frame availability hold for every block and the analysis-FIFO slots
      of synthesis frame u block-independent (``stretch_slots``).
    - The phase is a running product of unit rotors carried across
      blocks; z0, the first true analysis frame's rotor, is captured when
      its physical frame (``n_skip``) arrives.
    - WOLA synthesis uses the gate's OLA-tail carry and streaming norm.

    Streaming contract: stream[L:] == full(x)[: emitted - L] for interior
    samples (the whole-file tail ramp has no streaming counterpart but in
    a drained stream).  Routes by tensor: with ``fused`` a float32 block
    runs ``stretch_step_fused`` (the kernel on a CUDA tensor, its plain
    version on a CPU tensor); otherwise, and for float64 on any device,
    the plain step with ``impl``.  ``full`` runs ``stft`` ->
    ``stretch_spec_rational`` -> ``istft`` with ``impl``.  A CUDA float32
    tensor under the default ``impl`` runs one ``rfft_stockham`` and one
    ``irfft_stockham`` a call or an unfused block.
    """

    p: int
    q: int
    nfft: int = 1024
    hop: int = 256
    window_kind: str = "hann"
    impl: str = fft_ops.DEFAULT_IMPL
    fused: bool = False

    def __post_init__(self):
        g = math.gcd(self.p, self.q)
        self.p //= g
        self.q //= g
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")

    @classmethod
    def from_rate(cls, rate: float, max_den: int = 64, **kw) -> StretchStage:
        """Streaming stage for any (also irrational) float rate: the
        continued-fraction best approximation p/q with q <= max_den (rate
        error < 1/(q*max_den)).  Exact float rates on a whole file are
        ``effects.time_stretch`` / ``pitch_shift``."""
        check(rate > 0 and math.isfinite(rate), "rate must be finite and > 0")
        f = Fraction(rate).limit_denominator(max_den)
        check(f.numerator > 0, f"rate {rate} too small for max_den={max_den}")
        return cls(p=f.numerator, q=f.denominator, **kw)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0,
              f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        self.input_latency = input_latency
        # physical frames (starting at stream position -d) before the first
        # true analysis frame
        self.n_skip = (input_latency + self.nfft - self.hop) // self.hop
        # smallest block-independent warm-up with
        # (mo-1-off)*p < (m - n_skip - 1)*q for every block
        self.off = -(-((self.n_skip + 1) * self.q + 1) // self.p) - 1
        self.latency = self.off * self.hop
        return self.latency

    def out_block(self, b: int) -> int:
        return stretch_block_frames(b, self.hop, self.p, self.q)[1] * self.hop

    def out_len(self, n: int) -> int:
        return n * self.q // self.p

    def tail_width(self, t: int) -> int:
        # frame overlap + analysis-slot lookahead + frame truncation
        return -(-t * self.q // self.p) + self.nfft + self.hop

    def set_eof(self, n_in: int) -> None:
        d = self.nfft - self.hop
        check(n_in >= self.nfft + self.hop,
              f"drain needs >= two complete analysis frames "
              f"(nfft+hop={self.nfft + self.hop}), got {n_in}; use full()")
        check(self.nfft + (self._nof(n_in) - 1) * self.hop >= 2 * d,
              "drain needs disjoint WOLA edge ramps; use full()")
        self._eof_n = n_in

    def _nof(self, n_in: int) -> int:
        """The whole file's output frame count (``stretch_steps_rational``:
        nf complete analysis frames give nf-1 slot pairs)."""
        nf = (n_in - self.nfft) // self.hop + 1
        return 0 if nf < 2 else ((nf - 1) * self.q - 1) // self.p + 1

    def _eof_frames_out(self) -> int | None:
        return None if self._eof_n is None else self._nof(self._eof_n)

    def full(self, x):
        spec = stft(x, self.nfft, self.hop, self.window_kind, impl=self.impl)
        out = stretch_spec_rational(spec, self.p, self.q, self.nfft, self.hop)
        y = istft(out, self.nfft, self.hop, self.window_kind, impl=self.impl)
        target = x.shape[-1] * self.q // self.p
        return (_pad_to(y, target) if y.shape[-1] < target else y)[..., :target]

    def _slots(self, m: int):
        """Static FIFO geometry for blocks of m frames: (depth, slot[u],
        frac[u])."""
        return stretch_slots(m, self.p, self.q, self.n_skip, self.off)

    def _step_kw(self) -> dict:
        return dict(nfft=self.nfft, hop=self.hop, p=self.p, q=self.q,
                    n_skip=self.n_skip, off=self.off, window_kind=self.window_kind,
                    eof_frames_out=self._eof_frames_out())

    def init_state(self, batch, block, dtype=torch.float32, device=None):
        m, _ = stretch_block_frames(block, self.hop, self.p, self.q)
        depth, _, _ = self._slots(m)
        return stretch_step_init_state(batch, self.nfft, self.hop, depth, dtype, device)

    def step(self, state, x):
        if self.fused and x.dtype != torch.float64:
            return stretch_step_fused(x, state, **self._step_kw())
        return stretch_step_ref(x, state, impl=self.impl, **self._step_kw())


STAGES = {"FIRStage": FIRStage, "EnvelopeStage": FIRStage,
          "GateStage": GateStage, "FIRGateStage": FIRGateStage,
          "ResampleStage": ResampleStage, "ResFIRGateStage": ResFIRGateStage,
          "StretchStage": StretchStage}
"""Stage classes ``Chain.from_params`` builds by name (the JAX package's
``EnvelopeStage`` is a ``FIRStage`` with ``pre="abs"``)."""


@dataclass
class Chain:
    """Sequential stage composition with whole-file and streaming modes."""

    stages: list = field(default_factory=list)

    @classmethod
    def from_params(cls, params: list[dict]) -> Chain:
        """One stage per dict of the JAX stage's fields; the optional key
        ``stage`` names its class (see ``STAGES``), ``FIRGateStage`` when
        absent."""
        stages = []
        for p in params:
            p = dict(p)
            name = p.pop("stage", "FIRGateStage")
            check(name in STAGES, f"unknown stage {name!r}; one of {sorted(STAGES)}")
            stages.append(STAGES[name].from_params(p))
        return cls(stages)

    def build(self) -> int:
        """Propagate latencies; returns the total chain latency."""
        lat = 0
        for s in self.stages:
            lat = s.configure(lat)
        self.latency = lat
        return lat

    def out_block(self, b: int) -> int:
        for s in self.stages:
            b = s.out_block(b)
        return b

    def out_len(self, n: int) -> int:
        """Rate-mapped whole-file output length: len(full(x)) for any x."""
        for s in self.stages:
            n = s.out_len(n)
        return n

    def tail_width(self) -> int:
        """Output samples at the end of ``full(x)`` that change once the
        input is extended past end-of-file (see Stage.tail_width)."""
        t = 0
        for s in self.stages:
            t = s.tail_width(t)
        return t

    def full(self, x: torch.Tensor) -> torch.Tensor:
        with span("asp.Chain.full"):
            for s in self.stages:
                with span(s.span_full):
                    x = s.full(x)
            return x

    def full_flush(self, x: torch.Tensor) -> torch.Tensor:
        """``full`` with the output length pinned to ``out_len(n)``."""
        with span("asp.Chain.full_flush"):
            n_out = self.out_len(x.shape[-1])
            y = self.full(x)
            if y.shape[-1] < n_out:
                y = _pad_to(y, n_out)
            return y[..., :n_out]

    def init_state(self, batch: tuple, block: int, dtype=torch.float32, device=None):
        self.build()
        states = []
        for s in self.stages:
            states.append(s.init_state(batch, block, dtype, device))
            block = s.out_block(block)
        return states

    def step(self, states, x):
        with span("asp.Chain.step"):
            new_states = []
            for s, st in zip(self.stages, states):
                with span(s.span_step):
                    st, x = s.step(st, x)
                new_states.append(st)
            return new_states, x

    def arm_eof(self, n: int) -> None:
        """Arm every stage's end-of-file handling for a drained stream of
        ``n`` real input samples (see Stage.set_eof).  A caller running its
        own loop over ``step`` arms before the first block and disarms
        after the last; ``stream(drain=True)`` does both."""
        for s in self.stages:
            s.set_eof(n)
            n = s.out_len(n)

    def disarm_eof(self) -> None:
        for s in self.stages:
            s.clear_eof()

    def drain_blocks(self, n: int, block: int) -> int:
        """Input blocks (>= ceil(n/block)) a drained stream steps so that
        its emission covers [0, out_len(n)) past the latency and every
        emitted position has converged.  Requires ``build()``."""
        need = self.out_len(n) + max(self.latency, self.tail_width())
        return max(-(-n // block), -(-need // self.out_block(block)))

    def stream(self, x: torch.Tensor, block: int, drain: bool = False) -> torch.Tensor:
        """Run the whole signal through the block streamer.

        ``drain=False``: len(x) must be a multiple of ``block``; returns the
        emitted stream, whose first ``latency`` samples precede the signal
        and whose last ``latency`` samples of ``full(x)`` stay in the carry.

        ``drain=True``: any input length.  Zero-pads to ``drain_blocks``
        whole blocks, arms every stage's end-of-file handling, streams, and
        returns exactly ``out_len(len(x))`` samples aligned to position 0:
        ``full_flush(x)`` to streaming reassociation.
        """
        n = x.shape[-1]
        if drain:
            self.build()
            nblocks = self.drain_blocks(n, block)
            if nblocks * block > n:
                x = _pad_to(x, nblocks * block)
            try:
                self.arm_eof(n)
                y = self.stream(x, block)
            finally:
                self.disarm_eof()
            return y[..., self.latency : self.latency + self.out_len(n)]
        check(n % block == 0, "stream length must be a multiple of the block")
        states = self.init_state(x.shape[:-1], block, x.dtype, x.device)
        ob = self.out_block(block)
        out = x.new_empty(x.shape[:-1] + ((n // block) * ob,))
        for k in range(n // block):
            states, y = self.step(states, x[..., k * block : (k + 1) * block])
            out[..., k * ob : (k + 1) * ob] = y
        return out
