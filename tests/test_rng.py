"""Keyed device-side noise: reproducibility and statistical equivalence.

VERDICT round-1 item 2 / SURVEY §7.4: LASER/EDFA/PD accept an explicit
``key=`` (or draw from the global stream seeded by ``gv(seed=...)``) and
generate their noise with ``jax.random`` on-device.  Exact stream match
with NumPy's legacy RNG is impossible; equivalence is statistical
(variances vs the analytic models in utils/theory.py), as BASELINE allows.
"""
import jax
import numpy as np
import pytest

from opticomlib_tpu import gv, rng
from opticomlib_tpu.devices import EDFA, FIBER, LASER, PD
from opticomlib_tpu.signals import OpticalSignal
from opticomlib_tpu.utils.theory import p_ase
from opticomlib_tpu.utils.analysis import idb, idbm
from scipy.constants import e, k as kB


@pytest.fixture(autouse=True)
def _reset():
    gv.default()
    gv(sps=16, R=10e9, N=2**12)
    yield
    gv.default()


class TestReproducibility:
    def test_laser_same_key_same_waveform(self):
        a = LASER(5, lw=1e6, rin=-140, key=7)
        b = LASER(5, lw=1e6, rin=-140, key=7)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())

    def test_laser_different_keys_differ(self):
        a = LASER(5, lw=1e6, key=7)
        b = LASER(5, lw=1e6, key=8)
        assert not np.array_equal(a.to_numpy(), b.to_numpy())

    def test_edfa_same_key_same_ase(self):
        x = OpticalSignal(np.ones(4096, complex) * 0.01)
        a = EDFA(x, G=20, NF=5, key=3)
        b = EDFA(x, G=20, NF=5, key=3)
        np.testing.assert_array_equal(np.asarray(a.noise),
                                      np.asarray(b.noise))

    def test_pd_same_key_same_noise(self):
        x = OpticalSignal(np.ones(4096, complex) * 0.01)
        a = PD(x, BW=7.5e9, include_noise="thermal-shot", key=11)
        b = PD(x, BW=7.5e9, include_noise="thermal-shot", key=11)
        np.testing.assert_array_equal(np.asarray(a.noise),
                                      np.asarray(b.noise))

    def test_gv_seed_stream_reproducible(self):
        gv(seed=42)
        a = LASER(5, lw=1e6)
        a2 = LASER(5, lw=1e6)  # consumes the next key -> different
        gv(seed=42)
        b = LASER(5, lw=1e6)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
        assert not np.array_equal(a.to_numpy(), a2.to_numpy())

    def test_gv_default_clears_stream(self):
        gv(seed=1)
        assert rng.is_seeded()
        gv.default()
        assert not rng.is_seeded()

    def test_explicit_key_object(self):
        k = jax.random.key(5)
        a = LASER(5, lw=1e6, key=k)
        b = LASER(5, lw=1e6, key=jax.random.key(5))
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


class TestStatistics:
    """Keyed noise matches the analytic variances the reference encodes."""

    def test_edfa_ase_power(self):
        gv(sps=16, R=10e9, N=2**14)
        x = OpticalSignal(np.zeros(gv.N * gv.sps, complex))
        G, NF = 20.0, 5.0
        out = EDFA(x, G=G, NF=NF, key=0)
        expected = p_ase(G=G, NF=NF, BW_opt=gv.fs)  # NF*h*f0*(G-1)*BW
        measured = float(np.mean(np.abs(np.asarray(out.noise)) ** 2)) * 2
        # (2 pols each carry P_ase/2; mean over pol axis halves it)
        assert measured == pytest.approx(expected, rel=0.05)

    def test_laser_rin_variance(self):
        gv(sps=16, R=10e9, N=2**14)
        rin = -145.0
        out = LASER(0, rin=rin, key=1)
        # P(t) = P0*(1+n) with var(n) = idb(rin)*fs
        P = np.abs(out.to_numpy()) ** 2 / idbm(0)
        assert float(P.var()) == pytest.approx(idb(rin) * gv.fs, rel=0.05)

    def test_laser_phase_noise_variance_growth(self):
        gv(sps=16, R=10e9, N=2**14)
        lw = 1e6
        out = LASER(0, lw=lw, key=2)
        ph = np.unwrap(np.angle(out.to_numpy()))
        n = ph.size
        # Wiener walk: var(phi_k) = k * 2*pi*lw*dt; check at the endpoint
        # via the increment variance (stationary, much tighter estimator)
        inc = np.diff(ph)
        assert float(inc.var()) == pytest.approx(
            2 * np.pi * lw * gv.dt, rel=0.05)

    def test_pd_thermal_variance(self):
        gv(sps=16, R=10e9, N=2**14)
        x = OpticalSignal(np.zeros(gv.N * gv.sps, complex))
        T, R_load = 300.0, 50.0
        out = PD(x, BW=gv.fs / 2 * 0.999, include_noise="thermal-only",
                 key=3, T=T, R_load=R_load)
        S_T = 4 * kB * T * gv.fs / 2 / R_load  # current variance
        v = np.asarray(out.noise)
        # output is voltage (xR_load) after a near-fullband LPF
        assert float(v.var()) == pytest.approx(S_T * R_load**2, rel=0.10)


def test_numpy_integer_seed_coerced():
    """Round-3 review fix: np integer seeds coerce to PRNG keys like
    Python ints (previously they passed through and crashed in split)."""
    import numpy as np

    from opticomlib_tpu import rng as rng_mod

    k1 = rng_mod.as_key(np.uint32(42))
    k2 = rng_mod.as_key(42)
    assert jax.random.uniform(k1) == jax.random.uniform(k2)


# --------------------------------------------------- placement of staged work
def test_keys_live_on_default_device():
    """Key creation and splitting run on the default device (no routing
    to another backend)."""
    rng.seed(3)
    try:
        keys = [rng.next_key(), rng.as_key(5), rng.resolve(None)]
    finally:
        rng.clear()
    for k in keys:
        assert k.devices() == {jax.devices()[0]}


def _capture(monkeypatch, module, name):
    """Wrap a jitted kernel so the devices of its outputs are recorded."""
    seen = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        for leaf in jax.tree_util.tree_leaves(out):
            seen.append(leaf.devices())
        return out

    monkeypatch.setattr(module, name, wrapped)
    return seen


STAGED_KERNELS = {
    "fiber_adaptive": ("ssfm", "_ssfm_loop",
                       lambda x: FIBER(x, length=10, alpha=0.2, beta_2=-20,
                                       gamma=2)),
    "fiber_fixed": ("ssfm", "_ssfm_scan",
                    lambda x: FIBER(x, length=10, alpha=0.2, beta_2=-20,
                                    gamma=2, h=1.0)),
    "laser_phase": ("noise", "_wiener",
                    lambda x: LASER(P0=0, lw=1e6, key=2)),
    "pd_noise": ("noise", "_gaussian",
                 lambda x: PD(x, BW=7.5e9, include_noise="thermal-only",
                              key=4)),
}


@pytest.mark.parametrize("name", sorted(STAGED_KERNELS))
def test_staged_kernels_run_on_default_device(monkeypatch, name):
    """Small staged waveforms (2^10 samples here) compute on the default
    device: no size threshold sends them elsewhere."""
    from opticomlib_tpu.ops import noise, ssfm

    mod_name, fn_name, call = STAGED_KERNELS[name]
    seen = _capture(monkeypatch, {"ssfm": ssfm, "noise": noise}[mod_name],
                    fn_name)
    gv(sps=16, R=10e9, N=2**6)
    x = OpticalSignal((np.ones(2**10) * 0.1).astype(complex))
    call(x)
    assert seen and all(d == {jax.devices()[0]} for d in seen)
