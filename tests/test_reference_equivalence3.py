"""Equivalence vs the reference for the analysis utilities and the lab
offline-processing logic (SYNC, GET_EYE_v2)."""
import os
import sys
import types

import numpy as np
import pytest

REF_PATH = "/root/reference"

if not os.path.isdir(os.path.join(REF_PATH, "opticomlib")):
    pytest.skip("reference package not available", allow_module_level=True)


@pytest.fixture(scope="module")
def ref():
    for name in ("pympler", "pympler.asizeof", "pyvisa", "serial",
                 "serial.tools", "serial.tools.list_ports"):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
    def _no_pympler(o):
        raise ImportError("pympler stub (test harness)")
    sys.modules["pympler.asizeof"].asizeof = _no_pympler
    sys.modules["pympler"].asizeof = sys.modules["pympler.asizeof"]
    if REF_PATH not in sys.path:
        sys.path.insert(0, REF_PATH)
    import opticomlib
    import opticomlib.lab
    import opticomlib.utils
    return opticomlib


@pytest.fixture()
def both_gv(ref):
    from opticomlib_tpu import gv as jax_gv

    def setter(**kw):
        ref.gv(**kw)
        jax_gv(**kw)

    yield setter
    ref.gv.default()


# ---------------------------------------------------------------- analysis
def test_conversions_match(ref):
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    vals = np.array([0.5, 1.0, 2.0, 10.0])
    np.testing.assert_allclose(ta.db(vals), ru.db(vals))
    np.testing.assert_allclose(ta.dbm(vals), ru.dbm(vals))
    np.testing.assert_allclose(ta.idb(vals), ru.idb(vals))
    np.testing.assert_allclose(ta.idbm(vals), ru.idbm(vals))
    np.testing.assert_allclose(ta.Q(np.linspace(-3, 6, 13)),
                               ru.Q(np.linspace(-3, 6, 13)))
    np.testing.assert_allclose(ta.gaus(np.linspace(-3, 3, 7), 0.5, 1.2),
                               ru.gaus(np.linspace(-3, 3, 7), 0.5, 1.2))


def test_str2array_and_dec2bin_match(ref):
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    for s in ("1+2j, 3-4i", "0.5 1.5 -2.0"):
        np.testing.assert_array_equal(ta.str2array(s), ru.str2array(s))
    # binary strings: the reference's bool-detection casts every nonempty
    # token to True ("1 0 1" -> all-ones) — a reference bug.  We assert the
    # documented behavior instead (str2array docstring: values parse).
    np.testing.assert_array_equal(np.asarray(ta.str2array("1 0 1; 0 1 0"),
                                             dtype=int),
                                  [[1, 0, 1], [0, 1, 0]])
    for v, d in [(5, 8), (255, 8), (1, 3)]:
        np.testing.assert_array_equal(ta.dec2bin(v, d), ru.dec2bin(v, d))


def test_si_formatting_matches(ref):
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    # 1e12 excluded: the reference prints "1000.0 Ts" at the tera boundary
    # (off-by-one in its prefix table) — ours prints "1.0 Ts".
    for v in (1e9, 2.5e-3, 999.0, 3.3e-7):
        assert ta.si(v) == ru.si(v), v


def test_norm_nearest_shortest_match(ref):
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    rng = np.random.default_rng(0)
    x = rng.normal(size=500)
    np.testing.assert_allclose(ta.norm(x), ru.norm(x))
    arr = np.sort(rng.normal(size=64))
    assert ta.nearest(arr, 0.3) == ru.nearest(arr, 0.3)
    assert ta.nearest_index(arr, 0.3) == ru.nearest_index(arr, 0.3)
    # reference returns a (2, 1) column for 1-D input; same values
    np.testing.assert_allclose(
        np.ravel(ta.shortest_int(x, percent=50)),
        np.ravel(ru.shortest_int(x, percent=50)))


def test_phase_taug_dispersion_match(ref, both_gv):
    both_gv(sps=16, R=1e9)
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    fs = 16e9
    f = np.fft.fftshift(np.fft.fftfreq(256, d=1 / fs))
    H = np.exp(1j * (2e-22 * (2 * np.pi * f) ** 2 + 0.3))
    np.testing.assert_allclose(ta.phase(H), ru.phase(H), atol=1e-9)
    np.testing.assert_allclose(ta.tau_g(H, fs), ru.tau_g(H, fs), rtol=1e-6)
    np.testing.assert_allclose(ta.dispersion(H, fs, 193.4e12),
                               ru.dispersion(H, fs, 193.4e12), rtol=1e-6)


def test_rcos_spectrum_matches(ref):
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    x = np.linspace(-2, 2, 401)
    for beta in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(ta.rcos(x, beta, T=1.0),
                                   ru.rcos(x, beta, T=1.0), atol=1e-12)


def test_phase_estimator_matches(ref, both_gv):
    both_gv(sps=16, R=1e9)
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    rng = np.random.default_rng(4)
    fs, f0, n = 10e9, 1.1e9, 2000
    t = np.arange(n) / fs
    x = 0.8 * np.sin(2 * np.pi * f0 * t + 0.7) + 0.05 * rng.normal(size=n)
    pa = ru.phase_estimator(t, x, f0)
    pb = ta.phase_estimator(t, x, f0)
    a0 = pa[0] if isinstance(pa, tuple) else pa
    b0 = pb[0] if isinstance(pb, tuple) else pb
    assert abs(a0 - b0) < 1e-3


def test_get_psd_matches(ref, both_gv):
    both_gv(sps=16, R=1e9, N=256)
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    rng = np.random.default_rng(5)
    fs = 16e9
    t = np.arange(4096) / fs
    x = np.sin(2 * np.pi * 2e9 * t) + 0.1 * rng.normal(size=t.size)
    fa, Pa = ru.get_psd(x, fs, nperseg=512)
    fb, Pb = ta.get_psd(x, fs, nperseg=512)
    np.testing.assert_allclose(fb, fa)
    np.testing.assert_allclose(Pb, Pa, rtol=1e-6)


def test_optimized_gaussian_filter_matches(ref, both_gv):
    both_gv(sps=32, R=1e9, N=64)
    import opticomlib.utils as ru

    import opticomlib_tpu.utils.analysis as ta
    rng = np.random.default_rng(6)
    x = np.repeat(rng.integers(0, 2, 64).astype(float), 32)
    t = np.arange(x.size) / 32e9
    T_bit = 1e-9
    a = ru.apply_optimized_gaussian_filter(t, x, T_bit)
    b = ta.apply_optimized_gaussian_filter(t, x, T_bit)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-6)


# --------------------------------------------------------------- lab logic
# NOTE: the reference's lab.GET_EYE_v2 is broken against its own current
# typing module (lab.py:212 calls `input.sps()` but `sps` is an int
# property, reference typing.py) — it raises TypeError upstream.  Our
# implementation follows the documented behavior and is covered by
# tests/test_lab.py; that direct comparison is skipped until the reference
# fixes itself.  SYNC works when called with a plain ndarray + explicit sps.
def test_sync_matches(ref, both_gv):
    both_gv(sps=8, R=1e9, N=128)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 128)
    wave = np.tile(np.repeat(bits.astype(float), 8), 3)
    rx = np.roll(wave, 517) + 0.02 * rng.normal(size=wave.size)

    a_sync, a_i = ref.lab.SYNC(rx, bits, sps=8)
    from opticomlib_tpu import lab as lab_jax
    b_sync, b_i = lab_jax.SYNC(rx, bits, sps=8)
    assert a_i == b_i == 517
    np.testing.assert_allclose(np.asarray(b_sync.signal).real,
                               np.asarray(a_sync.signal).real, atol=1e-9)


@pytest.mark.skip(reason="reference lab.GET_EYE_v2 calls .sps() on an int "
                         "property — broken upstream")
def test_get_eye_v2_matches(ref, both_gv):
    both_gv(sps=16, R=1e9, N=256)
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, 256)
    x = np.repeat(bits.astype(float), 16) + 0.05 * rng.normal(size=256 * 16)

    a = ref.lab.GET_EYE_v2(ref.electrical_signal(x), bits)
    from opticomlib_tpu import lab as lab_jax
    b = lab_jax.GET_EYE_v2(x, bits)
    assert abs(b.mu0 - a.mu0) < 0.02
    assert abs(b.mu1 - a.mu1) < 0.02
    assert abs(b.s0 - a.s0) < 0.02
    assert abs(b.s1 - a.s1) < 0.02
    assert abs(b.threshold - a.threshold) < 0.1
