"""The sites where a float32 matrix product would run in TF32 on a GPU:
the pencil FFT's P-point DFT, the sharded laser-phase prefix and the eye
KDE contraction.  Each is checked against a plain NumPy reference on the
CPU here; the eye contraction also on the GPU (marked ``chip``), and the
two sharded sites by ``chip_smoke.py --four``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from opticomlib_tpu.link_sharded import blockwise_cumsum
from opticomlib_tpu.ops import eyeana
from opticomlib_tpu.parallel.dfft import pencil_fft, pencil_ifft


def _time_mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), ("time",))


def _pencil(x, n_dev, inverse=False):
    """pencil_fft (or its inverse) of a 1-D array sharded over n_dev
    devices, gathered back to the host."""
    fn = pencil_ifft if inverse else pencil_fft
    f = shard_map(lambda b: fn(b, "time"), mesh=_time_mesh(n_dev),
                  in_specs=P("time"), out_specs=P("time"))
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def _strided_to_natural(X, n_dev):
    """pencil_fft's layout (device q holds bins q + P*k2) -> natural."""
    B = X.size // n_dev
    return X.reshape(n_dev, B).T.reshape(-1)


@pytest.mark.parametrize("n", [2**10, 3 * 2**9])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_pencil_fft_matches_numpy(n_dev, n):
    rng = np.random.default_rng(n_dev)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    X = _strided_to_natural(_pencil(x, n_dev), n_dev)
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.linalg.norm(X - ref) / np.linalg.norm(ref) < 1e-6
    back = _pencil(_pencil(x, n_dev), n_dev, inverse=True)
    assert np.linalg.norm(back - x) / np.linalg.norm(x) < 1e-6


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_blockwise_cumsum_matches_cumsum(n_dev):
    """The sharded laser phase walk: local cumsum + masked prefix of the
    preceding blocks' sums equals one global cumsum."""
    rng = np.random.default_rng(n_dev)
    x = rng.normal(size=(3, 64 * n_dev)).astype(np.float32)
    f = shard_map(lambda b: blockwise_cumsum(b, "time"),
                  mesh=_time_mesh(n_dev), in_specs=P(None, "time"),
                  out_specs=P(None, "time"))
    got = np.asarray(jax.jit(f)(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64),
                                              axis=-1),
                               rtol=1e-5, atol=1e-4)


def _two_level(seed, mu1, s0, s1, n=8000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, s0, n // 2),
                           rng.normal(mu1, s1, n // 2)]).astype(np.float32)


EYE_CASES = [(11, 1.0, 0.05, 0.08), (12, 0.4, 0.03, 0.06),
             (13, 2.0, 0.2, 0.3)]


def _kde_thresholds(y, mu1):
    host = eyeana.kde_min_threshold(y, 0.0, mu1)
    dev, _ = eyeana._kde_min_threshold_jax(
        jnp.asarray(y), jnp.ones(y.size, bool), jnp.float32(0.0),
        jnp.float32(mu1))
    return host, float(dev)


@pytest.mark.parametrize("case", EYE_CASES)
def test_device_eye_threshold_matches_host(case):
    seed, mu1, s0, s1 = case
    host, dev = _kde_thresholds(_two_level(seed, mu1, s0, s1), mu1)
    # same argmin up to the KDE grid step (mu1/500) and the bin width
    assert dev == pytest.approx(host, abs=5e-3 * mu1)


@pytest.mark.chip
@pytest.mark.parametrize("case", EYE_CASES)
def test_gpu_eye_threshold_matches_host(gpu, case):
    seed, mu1, s0, s1 = case
    host, dev = _kde_thresholds(_two_level(seed, mu1, s0, s1), mu1)
    assert dev == pytest.approx(host, abs=5e-3 * mu1)
