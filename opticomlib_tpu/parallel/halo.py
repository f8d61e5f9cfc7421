"""Halo-exchange primitives and halo-width derivation for the sharded SSFM.

The dispersion operator ``exp(i*beta2/2*w^2*h)`` is an all-pass chirp whose
*group delay* is bounded on a band-limited signal:

    tau(w) = (beta2*h) * w  + (beta3*h)/2 * w^2,   |w| <= pi*fs

so after one linear step of size ``h`` no signal energy moves further than

    T_max = |beta2*h| * pi*fs  +  |beta3*h|/2 * (pi*fs)^2      [seconds]

from its original position (stationary-phase bound).  That makes blockwise
overlap-save exact up to spectral-leakage terms: each device processes its
block plus ``H = ceil(T_max * fs) * safety`` halo samples gathered from its
ring neighbors, applies the operator with a local FFT, and discards the
halos.  Ring (wrap-around) neighbors reproduce the *circular* boundary
semantics of the reference's single-FFT linear step
(reference devices.py:1179), so the sharded result converges to the
single-device result as the halo grows.

Halo exchange is ``jax.lax.ppermute`` over the 'time' mesh axis — XLA lowers
it to device-to-device transfers between neighbors (no host involvement).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["halo_width", "exchange_halos", "pad_block_operator"]


def halo_width(h_km: float, beta2: float, beta3: float, fs: float,
               safety: float = 4.0, minimum: int = 8) -> int:
    """Number of halo samples needed per side for one linear step of
    ``h_km`` km (beta2 [ps^2/km], beta3 [ps^3/km], fs [Hz])."""
    fs_thz = fs * 1e-12  # samples per ps
    w_max = math.pi * fs_thz  # rad/ps at band edge
    t_max_ps = (abs(beta2 * h_km) * w_max
                + abs(beta3 * h_km) / 2 * w_max**2)
    return max(minimum, int(math.ceil(t_max_ps * fs_thz * safety)))


def exchange_halos(x, H: int, axis_name: str):
    """Gather ``H`` trailing samples from the left ring neighbor and ``H``
    leading samples from the right ring neighbor of the sharded last axis.

    Returns the padded block ``[left_halo | x | right_halo]``.
    Must be called inside ``shard_map`` with ``axis_name`` bound.
    """
    n_dev = jax.lax.axis_size(axis_name)
    # what we *send*: our trailing H samples travel right, leading H travel
    # left; perm pairs are (source, destination)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    left_halo = jax.lax.ppermute(x[..., -H:], axis_name, right_perm)
    right_halo = jax.lax.ppermute(x[..., :H], axis_name, left_perm)
    return jnp.concatenate([left_halo, x, right_halo], axis=-1)


def pad_block_operator(block_len: int, H: int, fs: float, alpha_db_km: float,
                       beta2: float, beta3: float) -> np.ndarray:
    """Linear operator D(w) sampled on the padded-block FFT grid
    (length ``block_len + 2H``), natural FFT order, complex64."""
    from ..ops.ssfm import linear_operator

    n = block_len + 2 * H
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    return linear_operator(w, alpha_db_km, beta2, beta3)
