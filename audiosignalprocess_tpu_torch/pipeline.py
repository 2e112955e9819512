"""Composable processing chain, whole-file mode.

Mirrors the JAX package's ``pipeline.py``: a ``Chain`` of stages with
latency propagation (``build``), the rate-mapped output length
(``out_len``) and the whole-signal paths ``full`` / ``full_flush``.
The block-streaming mode (``init_state`` / ``step`` / ``stream``) is not
ported yet and raises (ROADMAP Queue 1: the streaming Chain).

Stage parameters carry over from the JAX package as plain dictionaries:
``FIRGateStage.from_params(dataclasses.asdict(jax_stage))`` builds the
stage that computes the same thing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.kernels.chain_kernel import fir_noise_gate_fused
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.utils.validate import check

_STREAMING = ("block streaming is not ported yet "
              "(ROADMAP Queue 1: the streaming Chain and its step kernels)")


def _pad_to(y: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis of y up to n samples."""
    return torch.cat([y, y.new_zeros(y.shape[:-1] + (n - y.shape[-1],))], dim=-1)


class Stage:
    """Stage protocol.  Latency is in output samples."""

    latency: int = 0

    def configure(self, input_latency: int) -> int:
        """Receive the cumulative upstream latency; return this stage's
        output latency."""
        self.input_latency = input_latency
        return input_latency + self.latency

    def out_len(self, n: int) -> int:
        """Whole-file output length for input length n."""
        return n

    def full(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, batch: tuple, block: int, dtype):
        raise NotImplementedError(_STREAMING)

    def step(self, state, x):
        raise NotImplementedError(_STREAMING)


@dataclass
class FIRStage(Stage):
    """Causal FIR by overlap-save at FFT size ``nfft``.  Latency 0."""

    h: np.ndarray
    nfft: int | None = None

    def full(self, x):
        if self.nfft is None:
            raise NotImplementedError(
                "the direct-form FIR is not ported yet (ROADMAP Queue 1: fir_direct)")
        return overlap_save(x, self.h, self.nfft)


@dataclass
class GateStage(Stage):
    """Spectral noise gate (STFT -> mask -> WOLA ISTFT).

    Latency = (nfft-hop) + noise_frames*hop output samples (the streaming
    delay; the whole-file output is aligned to the input)."""

    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"

    def __post_init__(self):
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")
        self.latency = (self.nfft - self.hop) + self.noise_frames * self.hop

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0,
              f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        return super().configure(input_latency)

    def full(self, x):
        """Whole-signal gate, zero-padded back to the input length (the
        gate's output is nfft-hop shorter)."""
        y = noise_gate(x, self.nfft, self.hop, self.threshold_db,
                       self.reduction_db, self.noise_frames, self.release,
                       self.window_kind)
        return _pad_to(y, x.shape[-1])


@dataclass
class FIRGateStage(Stage):
    """FIR -> spectral gate composite, the headline 48 kHz chain.

    Equivalent to ``FIRStage(h, nfft) -> GateStage(nfft, hop, ...)``.
    ``full`` routes by tensor:

    - float32 runs ``fir_noise_gate_fused``: the fused Hopper kernel on a
      CUDA tensor, its plain PyTorch version on a CPU tensor;
    - float64 runs the composed plain path FIRStage -> GateStage on any
      device, as the JAX package does (the kernel computes in float32).
    """

    h: np.ndarray = None
    nfft: int = 1024
    hop: int = 256
    threshold_db: float = 6.0
    reduction_db: float = 60.0
    noise_frames: int = 8
    release: float = 0.0
    window_kind: str = "hann"

    def __post_init__(self):
        check(self.h is not None, "FIRGateStage requires filter taps h")
        self.h = np.asarray(self.h, np.float64)
        check(self.nfft % self.hop == 0, "nfft must be a multiple of hop")
        check(self.nfft > len(self.h) - 1, "nfft must exceed taps-1")
        self.latency = (self.nfft - self.hop) + self.noise_frames * self.hop
        self._fir = FIRStage(h=self.h, nfft=self.nfft)
        self._gate = GateStage(
            nfft=self.nfft, hop=self.hop, threshold_db=self.threshold_db,
            reduction_db=self.reduction_db, noise_frames=self.noise_frames,
            release=self.release, window_kind=self.window_kind)

    @classmethod
    def from_params(cls, params: dict) -> FIRGateStage:
        """Build from the JAX package's stage fields, as
        ``dataclasses.asdict`` gives them.  Its execution choices (``impl``,
        ``fused``) and the latency that ``Chain.build`` sets
        (``input_latency``) do not carry over; the envelope fold
        (``env_h``) is not ported yet."""
        p = dict(params)
        for key in ("impl", "fused", "input_latency", "env_scale"):
            p.pop(key, None)
        if p.pop("env_h", None) is not None:
            raise NotImplementedError(
                "the envelope fold is not ported yet (ROADMAP Queue 1: "
                "resample and envelope)")
        return cls(**p)

    def configure(self, input_latency: int) -> int:
        check(input_latency % self.hop == 0,
              f"upstream latency {input_latency} not a multiple of hop={self.hop}")
        self._fir.configure(input_latency)
        self._gate.configure(input_latency)
        return super().configure(input_latency)

    def full(self, x):
        if x.dtype == torch.float64:
            return self._gate.full(self._fir.full(x))
        y = fir_noise_gate_fused(
            x, self.h, self.nfft, self.hop, self.threshold_db,
            self.reduction_db, self.noise_frames, self.release,
            self.window_kind)
        return _pad_to(y, x.shape[-1])


@dataclass
class Chain:
    """Sequential stage composition (whole-file mode)."""

    stages: list = field(default_factory=list)

    @classmethod
    def from_params(cls, params: list[dict]) -> Chain:
        """A chain of ``FIRGateStage.from_params`` stages, one per dict."""
        return cls([FIRGateStage.from_params(p) for p in params])

    def build(self) -> int:
        """Propagate latencies; returns the total chain latency."""
        lat = 0
        for s in self.stages:
            lat = s.configure(lat)
        self.latency = lat
        return lat

    def out_len(self, n: int) -> int:
        """Rate-mapped whole-file output length: len(full(x)) for any x."""
        for s in self.stages:
            n = s.out_len(n)
        return n

    def full(self, x: torch.Tensor) -> torch.Tensor:
        for s in self.stages:
            x = s.full(x)
        return x

    def full_flush(self, x: torch.Tensor) -> torch.Tensor:
        """``full`` with the output length pinned to ``out_len(n)``."""
        n_out = self.out_len(x.shape[-1])
        y = self.full(x)
        if y.shape[-1] < n_out:
            y = _pad_to(y, n_out)
        return y[..., :n_out]

    def init_state(self, batch: tuple, block: int, dtype=torch.float32):
        raise NotImplementedError(_STREAMING)

    def step(self, states, x):
        raise NotImplementedError(_STREAMING)

    def stream(self, x: torch.Tensor, block: int, drain: bool = False):
        raise NotImplementedError(_STREAMING)
