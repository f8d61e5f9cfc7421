"""Plain float64 NumPy split-step reference for the SSFM.

An implementation of the same semantics as :mod:`opticomlib_tpu.ops.ssfm`
that shares no code with it: the symmetric NL-L-NL step with the
nonlinear operator frozen at the step start (the ``reference`` scheme),
fixed-step or ``phi_max``-adaptive, and the 4th-order Yoshida
composition of true Strang steps (``o4``), all in complex128.  The tests
and ``chip_smoke.py`` compare the JAX engine with it.

Units follow the package: ``w`` in rad/s, length and steps in km,
``alpha`` in dB/km, ``beta_2`` in ps^2/km, ``beta_3`` in ps^3/km,
``gamma`` in 1/W/km.
"""
import math

import numpy as np

_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_W0 = 1.0 - 2.0 * _W1


def step_schedule(length, h):
    """``h``-sized steps plus one final remainder (if any)."""
    n_full = int(math.floor(length / h + 1e-9))
    hs = [h] * n_full
    rem = length - n_full * h
    if rem > 1e-9 * max(length, 1.0):
        hs.append(rem)
    return hs or [length]


def _linear(A, w, h, alpha, beta_2, beta_3):
    wps = np.asarray(w, np.float64) * 1e-12
    a = alpha / (10.0 * np.log10(np.e))
    D = -a / 2 + 1j * (beta_2 / 2 * wps**2 + beta_3 / 6 * wps**3)
    return np.fft.ifft(np.fft.fft(A, axis=-1) * np.exp(D * h), axis=-1)


def _kick(A, h, gamma):
    """exp(i * gamma * h * |A|^2) evaluated on ``A``."""
    return np.exp(1j * gamma * h * np.abs(A) ** 2)


def nl_l_nl_step(A, w, h, alpha, beta_2, beta_3, gamma):
    """One step of the ``reference`` scheme: the half kick computed at the
    step start is applied before and after the linear step."""
    half = _kick(A, h / 2, gamma)
    return _linear(A * half, w, h, alpha, beta_2, beta_3) * half


def strang_step(A, w, h, alpha, beta_2, beta_3, gamma):
    """True Strang step: the second half kick uses the field after the
    linear step."""
    A = _linear(A * _kick(A, h / 2, gamma), w, h, alpha, beta_2, beta_3)
    return A * _kick(A, h / 2, gamma)


def o4_step(A, w, h, alpha, beta_2, beta_3, gamma):
    """Yoshida triple jump of Strang steps."""
    for c in (_W1, _W0, _W1):
        A = strang_step(A, w, c * h, alpha, beta_2, beta_3, gamma)
    return A


def propagate(A, w, length, alpha=0.0, beta_2=0.0, beta_3=0.0, gamma=0.0,
              h=None, phi_max=0.01, scheme="reference"):
    """Propagate ``A`` (last axis = time) through ``length`` km.

    ``scheme="reference"`` with ``h=None`` steps adaptively: each step is
    ``phi_max / (|gamma| max|A|^2)``, taken from the field at its start
    and clipped to the remaining length.  Otherwise the steps are
    :func:`step_schedule`.  Returns ``(A_out, n_steps)``.
    """
    A = np.asarray(A, np.complex128)
    args = (alpha, beta_2, beta_3, gamma)
    if scheme == "o4":
        if h is None:
            raise ValueError("the o4 reference needs a fixed step h")
        hs = step_schedule(length, h)
        for hk in hs:
            A = o4_step(A, w, hk, *args)
        return A, len(hs)
    if scheme != "reference":
        raise ValueError(f"unknown scheme {scheme!r}")
    if h is not None:
        hs = step_schedule(length, h)
        for hk in hs:
            A = nl_l_nl_step(A, w, hk, *args)
        return A, len(hs)
    z, n = 0.0, 0
    while z < length:
        peak = abs(gamma) * float(np.max(np.abs(A) ** 2))
        hk = length - z if peak == 0 else min(phi_max / peak, length - z)
        A = nl_l_nl_step(A, w, hk, *args)
        z += hk
        n += 1
    return A, n


def rel_l2(a, b):
    """Relative L2 error of ``a`` against ``b``."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
