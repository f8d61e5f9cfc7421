"""The JAX split-step engine against the plain float64 NumPy stepper
(tests/ssfm_reference.py), which shares no code with it.

The float32 engine must land within float32 rounding of the float64
result on the same step schedule: relative L2 error below 1e-4 on these
few-hundred-step runs (the CPU's own error is ~1e-5 here).
"""
import numpy as np
import pytest

import ssfm_reference as ref64
from opticomlib_tpu import gv
from opticomlib_tpu.devices import DBP, FIBER
from opticomlib_tpu.ops import ssfm
from opticomlib_tpu.signals import OpticalSignal

N, SPS, FS = 2**12, 16, 160e9
SPAN = dict(alpha=0.2, beta_2=-21.0, beta_3=0.1, gamma=1.3)
TOL = 1e-4


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, N // SPS)
    A = np.repeat(bits, SPS) * np.sqrt(0.02)
    # smooth edges: a band-limited launch keeps the test about rounding
    A = np.convolve(A, np.hanning(9) / np.hanning(9).sum(), mode="same")
    return A.astype(np.complex64)


def _w():
    return 2 * np.pi * np.fft.fftfreq(N, 1 / FS)


CASES = {
    "fixed_step": (
        lambda A: ssfm.ssfm_propagate(A, _w(), 40.0, h=0.25, **SPAN),
        dict(length=40.0, h=0.25)),
    "adaptive": (
        lambda A: ssfm.ssfm_propagate(A, _w(), 40.0, phi_max=0.005,
                                      **SPAN),
        dict(length=40.0, phi_max=0.005)),
    "o4": (
        lambda A: ssfm.ssfm_scan_o4(A, _w(), 40.0, h=1.0, **SPAN),
        dict(length=40.0, h=1.0, scheme="o4")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ssfm_matches_float64_stepper(field, name):
    run, kw = CASES[name]
    truth, n_steps = ref64.propagate(field, _w(), **SPAN, **kw)
    assert n_steps > 30
    assert ref64.rel_l2(run(field), truth) < TOL


def test_fiber_then_dbp_matches_float64_stepper(field):
    """FIBER -> DBP through the staged devices against the same two
    passes of the stepper (DBP = FIBER with every sign flipped)."""
    gv(sps=SPS, R=FS / SPS, N=N // SPS)
    fwd = FIBER(OpticalSignal(field), length=40.0, h=0.5, **SPAN)
    back = DBP(fwd, length=40.0, h=0.5, **SPAN).to_numpy().ravel()

    flipped = {k: -v for k, v in SPAN.items()}
    a, _ = ref64.propagate(field, _w(), 40.0, h=0.5, **SPAN)
    a, _ = ref64.propagate(a, _w(), 40.0, h=0.5, **flipped)
    assert ref64.rel_l2(back, a) < TOL
    # the round trip undoes the link up to the splitting error
    assert ref64.rel_l2(back, field) < 0.05


def test_stepper_linear_span_is_exact_dispersion(field):
    """With gamma = 0 every scheme is the exact linear operator, whatever
    the step count: a check of the stepper itself."""
    lin = dict(SPAN, gamma=0.0)
    exact, _ = ref64.propagate(field, _w(), 40.0, h=40.0, **lin)
    for kw in (dict(h=0.3), dict(h=3.0, scheme="o4")):
        out, _ = ref64.propagate(field, _w(), 40.0, **lin, **kw)
        assert ref64.rel_l2(out, exact) < 1e-12
