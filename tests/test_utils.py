"""Utility-layer tests with analytic oracles
(modeled on reference tests/utils_test.py)."""
import numpy as np
import pytest
from scipy.constants import c, h

from opticomlib_tpu import (
    Q, db, dbm, dec2bin, gaus, idb, idbm, nearest, nearest_index,
    noise_variances, norm, optimum_threshold, p_ase, phase_estimator,
    shortest_int, si, str2array, theory_BER, get_psd,
)
from opticomlib_tpu.utils.analysis import dec2bin_array


def test_db_conversions():
    assert np.isclose(db(10), 10.0)
    assert np.isclose(idb(10), 10.0)
    assert np.isclose(dbm(1e-3), 0.0)
    assert np.isclose(idbm(0), 1e-3)
    assert np.isclose(idb(db(123.4)), 123.4)
    with pytest.raises(ValueError):
        db(-1)


def test_Q_and_gaus():
    assert np.isclose(Q(0), 0.5)
    assert np.isclose(Q(5), 2.866515719235352e-07, rtol=1e-9)
    # gaussian pdf integrates to 1
    x = np.linspace(-10, 10, 10001)
    assert np.isclose(np.trapezoid(gaus(x, 0, 1), x), 1.0, atol=1e-6)


def test_shortest_int_gaussian():
    """50% shortest interval of N(0,1) ~ +-0.6745 (width ~1.349 sigma)."""
    rng = np.random.default_rng(42)
    x = rng.normal(0, 1, 200_000)
    lo, hi = shortest_int(x, 50)
    assert np.isclose(hi - lo, 1.349, atol=0.03)
    assert abs(lo + hi) < 0.05


def test_dec2bin():
    np.testing.assert_array_equal(dec2bin(5, 4), [0, 1, 0, 1])
    np.testing.assert_array_equal(dec2bin(0, 3), [0, 0, 0])
    with pytest.raises(ValueError):
        dec2bin(16, 4)
    np.testing.assert_array_equal(
        dec2bin_array([5, 2], 4), [[0, 1, 0, 1], [0, 0, 1, 0]])


def test_str2array():
    np.testing.assert_array_equal(str2array("1 0 1"), [True, False, True])
    np.testing.assert_array_equal(str2array("1,2,3"), [1, 2, 3])
    np.testing.assert_array_equal(str2array("1.5 2.5"), [1.5, 2.5])
    got = str2array("1+2j, 3-4i")
    np.testing.assert_array_equal(got, [1 + 2j, 3 - 4j])
    got2d = str2array("1 0; 0 1")
    assert got2d.shape == (2, 2)


def test_si_format():
    assert si(1e9, "Hz") == "1.0 GHz"
    assert si(2.5e-3, "s") == "2.5 ms"
    # 1.55e-6 falls in the micro band (reference si ranges, utils.py:955-957)
    assert si(1550e-9, "m") == "1.6 μm"
    assert si(15.5e-9, "m") == "15.5 nm"
    assert si(0, "W") == "0.0 W"


def test_norm_nearest():
    np.testing.assert_allclose(norm([1, 2, 4]), [0.25, 0.5, 1.0])
    assert nearest(np.array([1.0, 2.0, 3.0]), 2.2) == 2.0
    assert nearest_index(np.array([1.0, 2.0, 3.0]), 2.2) == 1
    np.testing.assert_array_equal(
        nearest_index(np.array([1.0, 2.0, 3.0]), [0.9, 3.3]), [0, 2])


def test_p_ase_formula():
    G, NF, BW = 20.0, 5.0, 50e9
    lam = 1550e-9
    expected = idb(NF) * h * (c / lam) * (idb(G) - 1) * BW
    assert np.isclose(p_ase(True, lam, G, NF, BW), expected)
    assert p_ase(False) == 0.0


def test_noise_variances_and_threshold():
    S = noise_variances(-20, "ook", ER=np.inf, amplify=True, G=20, NF=5,
                        BW_opt=50e9, BW_el=5e9)
    assert S.shape == (2,)
    assert S[1] > S[0] > 0  # ON-slot noisier (sig-ASE + shot scale with mu)

    th = optimum_threshold(0.0, 1.0, 0.01, 0.01, "ook")
    assert np.isclose(th, 0.5)
    th2 = optimum_threshold(0.0, 1.0, 0.01, 0.04, "ook")
    assert th2 < 0.5  # higher ON variance pushes threshold down


def test_theory_BER_monotonic_and_range():
    P = np.linspace(-30, -10, 5)
    ber = theory_BER(P_avg=P, modulation="ook", BW_el=5e9)
    assert np.all(np.diff(ber) <= 0)
    assert np.all((ber >= 0) & (ber <= 0.5))

    # pick a power where both BERs are well above float underflow so the
    # soft<=hard comparison is meaningful
    bh = theory_BER(P_avg=-42, modulation="ppm", M=4, decision="hard",
                    amplify=True, G=20, NF=5, BW_opt=50e9)
    bs = theory_BER(P_avg=-42, modulation="ppm", M=4, decision="soft",
                    amplify=True, G=20, NF=5, BW_opt=50e9)
    assert 1e-12 < bh < 0.5
    assert bs <= bh  # soft decision outperforms hard


def test_phase_estimator():
    t = np.linspace(0, 1e-6, 2000)
    f = 5e6
    rng = np.random.default_rng(3)
    x = 1.8 * np.cos(2 * np.pi * f * t + 0.7) + rng.normal(0, 0.05, t.size)
    phi, amp = phase_estimator(t, x, f)
    assert np.isclose(phi, 0.7, atol=0.01)
    assert np.isclose(amp, 1.8, atol=0.02)


def test_get_psd_sinusoid():
    """PSD peak of a known sinusoid appears at the right frequency with the
    right height (spectrum scaling: peak ~ (A/2)^2 per side)."""
    fs = 100e9
    f0 = 200 * fs / 2048  # exactly on a Welch bin -> no scalloping loss
    t = np.arange(4096) / fs
    x = 2.0 * np.cos(2 * np.pi * f0 * t)
    f, p = get_psd(x, fs=fs, nperseg=2048)
    ipk = np.argmax(p[f > 0]) + np.sum(f <= 0)
    assert abs(f[ipk] - f0) < fs / 2048 * 2
    assert np.isclose(p[ipk], 1.0, rtol=0.05)  # (A/2)^2 = 1


def test_apply_optimized_gaussian_filter():
    from opticomlib_tpu import apply_optimized_gaussian_filter
    fs = 16e9
    T_bit = 1e-9
    t = np.arange(1600) / fs
    bits = np.tile([0.0, 1, 1, 0, 1, 0, 0, 1, 0, 1], 10)
    x = np.repeat(bits, 16)
    y = apply_optimized_gaussian_filter(t, x, T_bit)
    assert y.shape == x.shape
    # amplitude preserved, transitions smoothed (reduced slew rate)
    assert np.isclose(np.max(np.abs(y)), 1.0, rtol=1e-6)
    assert np.max(np.abs(np.diff(y))) < np.max(np.abs(np.diff(x)))
    with pytest.raises(ValueError):
        apply_optimized_gaussian_filter(t[::-1], x, T_bit)


def test_hier_logger(capsys):
    import logging
    from opticomlib_tpu import HierLogger
    hl = HierLogger("test_hier")
    hl.logger.handlers.clear()
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(message)s"))
    hl.logger.addHandler(handler)
    hl.logger.propagate = False
    hl.setLevel(logging.DEBUG)

    @hl.auto_indent
    def inner():
        hl.debug("inner body")

    @hl.auto_indent
    def outer():
        inner()

    outer()
    err = capsys.readouterr().err
    lines = [l for l in err.splitlines() if l]
    # top-level call flush left, nested call one level in
    assert lines[0].startswith("/> ")
    assert any(l.startswith("|   /> inner") for l in lines)
    assert any(l.startswith("|   |   /> inner body") for l in lines)


# ------------------------------------------------------------- profiling
def test_profiling_hooks():
    """trace/annotate/DeviceTimer are usable on the CPU backend."""
    import tempfile

    import jax.numpy as jnp

    from opticomlib_tpu.utils.profiling import DeviceTimer, annotate, trace

    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            with annotate("smoke"):
                x = jnp.arange(8.0) * 2
    with DeviceTimer() as t:
        y = jnp.arange(64.0) ** 2
        t.sync(y)
    assert t.elapsed is not None and t.elapsed >= 0


def test_profiling_trace_raises_when_tracing_fails():
    """A trace that cannot start raises instead of silently running the
    block untraced (here: a second trace while one is active)."""
    import tempfile

    import jax

    from opticomlib_tpu.utils.profiling import trace

    ran = []
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        with trace(d1):
            with pytest.raises(RuntimeError):
                with trace(d2):
                    ran.append(1)
    assert not ran
    # the outer trace was stopped cleanly: a new one can start
    with tempfile.TemporaryDirectory() as d3:
        with trace(d3):
            jax.numpy.ones(4).block_until_ready()
