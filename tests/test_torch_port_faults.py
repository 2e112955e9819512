"""The port against the JAX package where the two once parted: a vocoder
grid that lands on the last frame, empty inputs, lengths that are not a
power of two under the torch route, and ``fft_flops``.

- ``effects.time_stretch``: where the float frame grid of
  ``np.arange(0, nf - 1, rate)`` lands on frame nf - 1, the port clamps the
  neighbour frame (frac is 0 there, so the interpolation is exact) and
  stays finite; the JAX package's ``jnp.take`` fills NaN.  Wherever the JAX
  output is finite the two agree.
- ``ops.stft.istft`` of zero frames gives zeros of length nfft - hop, and
  ``ops.overlap_save`` of an empty signal an empty result, on every impl,
  as the JAX package does.
- An explicit ``impl="torch"`` (``"xla"``) takes any length, as the JAX
  ``"xla"`` does; ``"auto"`` still checks.
- ``ops.fft.fft_flops`` is the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.effects import phase_vocoder as jax_pv
from audiosignalprocess_tpu.ops import fft as jax_fft
from audiosignalprocess_tpu.ops import overlap_save as jax_os
from audiosignalprocess_tpu.ops import stft as jax_stft
from audiosignalprocess_tpu_torch.effects import phase_vocoder as pv
from audiosignalprocess_tpu_torch.ops import fft
from audiosignalprocess_tpu_torch.ops import overlap_save as os_ops
from audiosignalprocess_tpu_torch.ops import stft

KERNEL_IMPLS = ("torch", "radix2", "splitradix", "matmul", "stockham", "stockham_split",
                "fourstep", "radix2_lanes", "radix2_stages", "pease", "auto")


# ---------------------------------------------------------------------------
# time_stretch where the float grid overshoots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rate,nfft,hop", [
    ((2, 3000), 0.7, 256, 64),
    ((2, 11876), 1.4, 1024, 256),
    ((2, 11900), 0.7, 1024, 256),
    ((3000,), 0.7, 256, 64),
])
def test_time_stretch_grid_on_the_last_frame(shape, rate, nfft, hop):
    """On inputs whose float grid ends on frame nf - 1 (the JAX output holds
    nfft NaN samples a channel there), the port's output has JAX's shape, is
    finite everywhere and agrees with JAX wherever JAX is finite."""
    x = np.random.default_rng(2).standard_normal(shape)
    nf = 1 + (shape[-1] - nfft) // hop
    steps = np.arange(0, nf - 1, rate)
    assert np.floor(steps[-1]) == nf - 1  # the grid lands on the last frame
    got = pv.time_stretch(torch.as_tensor(x), rate, nfft, hop).numpy()
    ref = np.asarray(jax_pv.time_stretch(jnp.asarray(x), rate, nfft, hop))
    assert got.shape == ref.shape and np.isfinite(got).all()
    finite = np.isfinite(ref)
    assert not finite.all()
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=1e-12)


@pytest.mark.parametrize("rate", (1.0, 0.5))
def test_time_stretch_of_one_frame(rate):
    """A one-frame signal (n = nfft) stretches to no frame, and the ISTFT of
    zero frames gives nfft - hop zeros, as in the JAX package."""
    x = np.random.default_rng(3).standard_normal((2, 256))
    got = pv.time_stretch(torch.as_tensor(x), rate, 256, 64).numpy()
    ref = np.asarray(jax_pv.time_stretch(jnp.asarray(x), rate, 256, 64))
    assert got.shape == ref.shape == (2, 192)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# empty inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("dtype", (torch.complex128, torch.complex64))
def test_istft_of_zero_frames(impl, dtype):
    """Zero frames: zeros of length nfft - hop in the spectrum's real dtype,
    on every impl, equal to the JAX package's."""
    spec = torch.zeros((2, 3, 0, 129), dtype=dtype)
    got = stft.istft(spec, 256, 64, impl=impl)
    ref = np.asarray(jax_stft.istft(jnp.zeros((2, 3, 0, 129), jnp.complex128), 256, 64,
                                    impl="xla"))
    assert got.shape == ref.shape == (2, 3, 192) and got.dtype == spec.real.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("fused", (False, True))
def test_overlap_save_of_an_empty_signal(impl, fused):
    """n = 0: an empty (..., 0) result, as the JAX package's, on every impl
    and through the fused route."""
    h = np.hanning(7)[1:-1]
    for shape in ((2, 0), (0,), (2, 3, 0)):
        x = np.zeros(shape)
        got = os_ops.overlap_save(torch.as_tensor(x), h, 64, impl=impl, fused=fused)
        ref = np.asarray(jax_os.overlap_save(jnp.asarray(x), h, 64, impl="xla"))
        assert got.shape == ref.shape == shape and got.dtype == torch.float64


# ---------------------------------------------------------------------------
# the torch route at any length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (3, 12, 1000))
@pytest.mark.parametrize("impl", ("torch", "xla"))
def test_torch_route_takes_any_length(n, impl):
    """fft, ifft, rfft and irfft at lengths that are not powers of two under
    an explicit torch route, against the JAX package's xla route."""
    rng = np.random.default_rng(n)
    z = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    x = rng.standard_normal((2, n))
    spec = np.fft.rfft(x)
    pairs = (
        (fft.fft(torch.as_tensor(z), impl=impl), jax_fft.fft(jnp.asarray(z), impl="xla")),
        (fft.ifft(torch.as_tensor(z), impl=impl), jax_fft.ifft(jnp.asarray(z), impl="xla")),
        (fft.rfft(torch.as_tensor(x), impl=impl), jax_fft.rfft(jnp.asarray(x), impl="xla")),
        (fft.irfft(torch.as_tensor(spec), n, impl=impl),
         jax_fft.irfft(jnp.asarray(spec), n, impl="xla")),
    )
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nfft,hop", ((960, 240), (1000, 250)))
def test_stft_at_a_length_that_is_not_a_power_of_two(nfft, hop):
    """ops.stft and ops.istft with impl="torch" at nfft 960 and 1000, against
    the JAX package's xla route."""
    x = np.random.default_rng(nfft).standard_normal((2, 6000))
    spec = stft.stft(torch.as_tensor(x), nfft, hop, impl="torch")
    ref = jax_stft.stft(jnp.asarray(x), nfft, hop, impl="xla")
    np.testing.assert_allclose(spec.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    y = stft.istft(spec, nfft, hop, impl="torch")
    yref = jax_stft.istft(ref, nfft, hop, impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(yref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("impl", ("auto", "radix2", "stockham", "matmul"))
def test_other_routes_still_check_the_length(impl):
    """auto (torch.fft on the CPU, but checked as the JAX auto is) and every
    other impl raise on a length that is not a power of two."""
    z = torch.zeros((2, 12), dtype=torch.complex128)
    for call in (lambda: fft.fft(z, impl=impl), lambda: fft.ifft(z, impl=impl),
                 lambda: fft.rfft(z.real, impl=impl), lambda: fft.irfft(z[:, :7], 12, impl=impl)):
        with pytest.raises(ValueError, match="power-of-two"):
            call()


# ---------------------------------------------------------------------------
# fft_flops
# ---------------------------------------------------------------------------

def test_fft_flops_is_the_jax_packages():
    for k in range(1, 15):
        assert fft.fft_flops(1 << k) == jax_fft.fft_flops(1 << k)
