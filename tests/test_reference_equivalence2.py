"""Equivalence vs the reference for the *redesigned* receiver components:
GET_EYE (KMeans/KDE -> vectorized reductions), LPF/BPF (sosfiltfilt ->
zero-phase spectral Bessel), ADC, FBG (solve_ivp -> RK4 scan), EDFA/LASER
deterministic parts, and end-to-end OOK DSP on identical injected noise.

Tolerances are estimation tolerances, not float round-off — these pairs
compute the same physics with different algorithms (documented in
MIGRATION.md "Deliberate behavioral differences").
"""
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
    import opticomlib.devices
    import opticomlib.ook
    return opticomlib


@pytest.fixture()
def both_gv(ref):
    from opticomlib_tpu import gv as jax_gv

    def setter(**kw):
        ref.gv(**kw)
        jax_gv(**kw)

    yield setter
    ref.gv.default()


def _noisy_ook(sps=32, n_bits=512, amp=1.0, sigma=0.08, seed=9):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits)
    x = np.repeat(bits.astype(float), sps) * amp
    x += rng.normal(scale=sigma, size=x.size)
    return bits, x


# ---------------------------------------------------------------- GET_EYE
def test_get_eye_statistics_match(ref, both_gv):
    both_gv(sps=32, R=1e9, N=512)
    _, x = _noisy_ook()
    a = ref.devices.GET_EYE(ref.electrical_signal(x), nslots=256)
    from opticomlib_tpu.devices import GET_EYE as GET_EYE_jax
    b = GET_EYE_jax(x, nslots=256)

    assert abs(b.mu0 - a.mu0) < 0.03
    assert abs(b.mu1 - a.mu1) < 0.03
    assert abs(b.s0 - a.s0) < 0.03
    assert abs(b.s1 - a.s1) < 0.03
    assert abs(b.threshold - a.threshold) < 0.1
    # extinction ratio within 1 dB (the reference yields NaN when noise
    # drives mu0 slightly negative — only comparable when both finite)
    if np.isfinite(a.er) and np.isfinite(b.er):
        assert abs(b.er - a.er) < 1.0
    assert abs(b.eye_h - a.eye_h) < 0.1


# ------------------------------------------------------------------- LPF
def test_lpf_output_matches_on_bandlimited_signal(ref, both_gv):
    """Same 4th-order Bessel zero-phase filtering; sosfiltfilt vs spectral
    |H|^2 must agree away from the circular edges."""
    both_gv(sps=32, R=1e9, N=256)
    rng = np.random.default_rng(5)
    x = rng.normal(size=256 * 32)
    a = ref.devices.LPF(ref.electrical_signal(x), BW=2e9)
    from opticomlib_tpu.devices import LPF as LPF_jax
    b = LPF_jax(x, BW=2e9)
    sa = np.asarray(a.signal).real
    sb = np.asarray(b.signal).real
    m = slice(2000, -2000)  # exclude edge transients (different padding)
    err = np.linalg.norm(sb[m] - sa[m]) / np.linalg.norm(sa[m])
    assert err < 0.02, err


# ------------------------------------------------------------------- ADC
def test_adc_matches(ref, both_gv):
    both_gv(sps=32, R=1e9, N=128)
    rng = np.random.default_rng(6)
    x = rng.normal(size=4096)
    a = ref.devices.ADC(ref.electrical_signal(x), n=6)
    from opticomlib_tpu.devices import ADC as ADC_jax
    b = ADC_jax(x, n=6)
    sa = np.asarray(a.signal).real
    sb = np.asarray(b.signal).real
    # same robust range estimate + same grid -> at most occasional one-level
    # ties; demand 99.9% exact agreement and tiny RMS difference
    agree = np.mean(np.abs(sb - sa) < 1e-9)
    assert agree > 0.999, agree


# ---------------------------------------------------------- EDFA / LASER
def test_edfa_deterministic_gain_matches(ref, both_gv):
    both_gv(sps=16, R=1e9, N=64)
    E = 0.01 * np.ones(1024, complex)
    # BW must stay below gv.fs/2 = 8 GHz for the reference's digital BPF
    a = ref.devices.EDFA(ref.optical_signal(E), G=20, NF=5, BW=5e9)
    from opticomlib_tpu.devices import EDFA as EDFA_jax
    from opticomlib_tpu.signals import OpticalSignal
    b = EDFA_jax(OpticalSignal(E), G=20, NF=5, BW=5e9)
    # deterministic part: field gain 10^(G/20); noise tracks are random
    # draws (different RNGs) — compare the signal track and the ASE power
    np.testing.assert_allclose(np.asarray(b.signal).ravel(),
                               np.asarray(a.signal).ravel(), rtol=1e-6)
    pa = np.mean(np.abs(np.asarray(a.noise)) ** 2)
    pb = np.mean(np.abs(np.asarray(b.noise)) ** 2)
    assert abs(pb - pa) / pa < 0.2, (pa, pb)  # statistical equality


def test_laser_deterministic_matches(ref, both_gv):
    both_gv(sps=16, R=1e9, N=64)
    a = ref.devices.LASER(P0=5)
    from opticomlib_tpu.devices import LASER as LASER_jax
    b = LASER_jax(P0=5)
    np.testing.assert_allclose(np.asarray(b.signal).ravel(),
                               np.asarray(a.signal).ravel(), rtol=1e-6)


# ------------------------------------------------------------------- FBG
def test_fbg_reflectivity_matches(ref, both_gv):
    both_gv(sps=64, R=10e9, N=128, wavelength=1550e-9)
    from opticomlib_tpu.devices import FBG as FBG_jax

    kw = dict(fc=ref.gv.f0, vdneff=1e-4, kL=2.0, apodization="uniform",
              print_params=False, filtfilt=False, retH=True)
    _, Ha = ref.devices.FBG(ref.optical_signal(np.ones(64 * 128, complex)),
                            **kw)
    _, Hb = FBG_jax(__import__("opticomlib_tpu").optical_signal(
        np.ones(64 * 128, complex)), **kw)
    Ha = np.asarray(Ha).ravel()
    Hb = np.asarray(Hb).ravel()
    # reflectivity magnitude profile: same peak and bandwidth
    np.testing.assert_allclose(np.abs(Hb), np.abs(Ha), atol=0.02)


# ------------------------------------------------------- OOK DSP end-to-end
def test_ook_dsp_same_input_same_bits(ref, both_gv):
    """Identical noisy photocurrent into both DSP chains -> identical
    recovered bits and close thresholds."""
    both_gv(sps=32, R=1e9, N=512)
    bits, x = _noisy_ook(sigma=0.12)

    ra = ref.ook.DSP(ref.electrical_signal(x))
    a_bits, _, a_rth = ra
    from opticomlib_tpu.models import ook as ook_jax
    b_bits, _, b_rth = ook_jax.DSP(
        __import__("opticomlib_tpu").electrical_signal(x))

    assert abs(a_rth - b_rth) < 0.1
    np.testing.assert_array_equal(np.asarray(a_bits.data),
                                  np.asarray(b_bits.data))
    # and both equal the transmitted bits at this SNR
    np.testing.assert_array_equal(np.asarray(b_bits.data), bits)
