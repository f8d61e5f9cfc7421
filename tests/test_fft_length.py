"""fft_convolve_same's single FFT-length rule (next 5-smooth length on
every backend) against scipy, on the jax path the rule applies to."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sg

from opticomlib_tpu.ops import pulses


def _is_5_smooth(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


@pytest.mark.parametrize("n,m", [(1000, 33), (1000, 64), (4096, 129),
                                 (777, 10)])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_jax_fft_convolve_same_matches_scipy(kind, n, m):
    rng = np.random.default_rng(n + m)
    x = rng.normal(size=n)
    if kind == "complex":
        x = x + 1j * rng.normal(size=n)
    h = rng.normal(size=m)
    dtype = np.complex64 if kind == "complex" else np.float32
    got = np.asarray(pulses.fft_convolve_same(
        jnp.asarray(x.astype(dtype)), jnp.asarray(h.astype(np.float32))))
    ref = sg.fftconvolve(x, h, mode="same")
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n", [3, 100, 1023, 4097, 2**20 + 1])
def test_next_fast_len_is_smallest_5_smooth(n):
    got = pulses._next_fast_len(n)
    assert got >= n and _is_5_smooth(got)
    assert not any(_is_5_smooth(k) for k in range(n, got))


def test_rule_length_and_power_of_two_agree():
    """The padding changes the work, never the result."""
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=1000).astype(np.float32))
    h = jnp.asarray(rng.normal(size=41).astype(np.float32))
    a = np.asarray(pulses.fft_convolve_same(x, h))
    b = np.asarray(pulses._fft_convolve(x, h, 2048))
    np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(a).max())
