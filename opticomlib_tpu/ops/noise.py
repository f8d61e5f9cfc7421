"""Device-side keyed noise kernels (jitted, planar float32 outputs).

Replaces the reference's host-side ``np.random.normal`` draws
(reference devices.py:485-506 LASER, 930-936 EDFA, 1521-1527 PD) with
``jax.random`` generation **on the accelerator**: at 2^24-2^26 samples the
host Gaussian generation plus host->device transfer would dominate a fused
chain.  All entry points return float32 real arrays, so results cross the
program boundary on any backend (no complex transfers).

The same functions are used in two ways:

* standalone devices call the jitted wrappers and pull the result to host
  (``np.asarray``) to combine with their NumPy signal math;
* the fused link program calls the ``*_inside`` bodies directly within its
  own jit, so noise never leaves the device.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["gaussian", "wiener_phase", "ase_draws",
           "gaussian_inside", "wiener_phase_inside"]


def gaussian_inside(key, shape, sigma):
    """``sigma * N(0,1)`` draws, float32 — for use inside an enclosing jit."""
    return jnp.float32(sigma) * jax.random.normal(key, shape,
                                                  dtype=jnp.float32)


def wiener_phase_inside(key, n, sigma_step):
    """Wiener (random-walk) phase: cumulative sum of N(0, sigma_step^2)
    increments — the reference LASER phase-noise model
    (devices.py:485-490: ``cumsum(normal(0, sqrt(2*pi*lw*dt), n))``)."""
    steps = gaussian_inside(key, (n,), sigma_step)
    return jnp.cumsum(steps)


@partial(jax.jit, static_argnames=("shape",))
def _gaussian(key, shape, sigma):
    return gaussian_inside(key, shape, sigma)


@partial(jax.jit, static_argnames=("n",))
def _wiener(key, n, sigma_step):
    return wiener_phase_inside(key, n, sigma_step)


def gaussian(key, shape, sigma) -> np.ndarray:
    """Host ndarray of ``sigma * N(0,1)`` draws generated on the default
    device."""
    if isinstance(shape, int):
        shape = (shape,)
    return np.asarray(_gaussian(key, tuple(shape), float(sigma)))


def wiener_phase(key, n: int, sigma_step: float) -> np.ndarray:
    """Host ndarray Wiener phase walk generated on the default device."""
    return np.asarray(_wiener(key, int(n), float(sigma_step)))


def ase_power(G_dB: float, NF_dB: float, f0: float, fs: float) -> float:
    """Total EDFA ASE noise power ``idb(NF)·h·f0·(G−1)·fs`` [W].

    The one place the amplifier noise physics lives (reference
    devices.py:930-936); :func:`ase_sigma` derives the per-quadrature
    standard deviation from it.  Used by ``devices.EDFA``, the fused
    link's ``_stage_plan`` and ``parallel.span_pipeline`` so the three
    paths cannot drift apart.
    """
    from scipy.constants import h as h_planck
    G_lin = 10.0 ** (G_dB / 10.0)
    if G_lin < 1.0:
        # the reference's formula would yield negative power (NaN sigma);
        # fail loudly instead.  G = 0 dB is allowed and gives P_ase = 0.
        raise ValueError("ASE requires gain >= 0 dB (got negative power)")
    return 10.0 ** (NF_dB / 10.0) * h_planck * f0 * (G_lin - 1.0) * fs


def ase_sigma(G_dB: float, NF_dB: float, f0: float, fs: float) -> float:
    """Per-quadrature ASE standard deviation: ``P_ase`` split over 2
    polarizations × (re, im) quadratures → ``sqrt(P_ase/4)``."""
    return float(np.sqrt(ase_power(G_dB, NF_dB, f0, fs) / 4.0))


def ase_draws(key, n: int, P_ase: float) -> np.ndarray:
    """EDFA ASE field noise: complex Gaussian in 2 polarizations.

    Reference devices.py:930-936: total ASE power ``P_ase`` split over
    2 polarizations x (re, im) quadratures -> 4 independent
    ``N(0, P_ase/4)`` draws per sample.  Returns a (2, n) complex128 host
    array (complex formed on host — planar boundary).
    """
    d = gaussian(key, (4, n), np.sqrt(P_ase / 4))
    return d[:2].astype(np.float64) + 1j * d[2:].astype(np.float64)
