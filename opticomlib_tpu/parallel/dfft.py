"""Exact distributed FFT over a sharded sample axis (pencil / 4-step
decomposition).

The sharded SSFM needs a *global* spectral multiply per linear step.  The
overlap-save path (:mod:`opticomlib_tpu.parallel.halo`) is approximate —
its error decays only ~1/H^2 because the dispersion operator's band-edge
discontinuity rings in the time domain.  This module implements the exact
alternative from SURVEY.md §7.5: Bailey's four-step FFT across the device
mesh, using two ``all_to_all`` collectives per transform (XLA lowers them to
NCCL all-to-all exchanges between the GPUs).

Decomposition (N = P * B, device p holds the contiguous block
``x[p*B : (p+1)*B]``; C = B / P):

  X[k1 + P*k2] = sum_{n2} e^{-2πi k1 n2 / N} e^{-2πi k2 n2 / B}
                   * sum_{n1} x[n1*B + n2] e^{-2πi n1 k1 / P}

so the chain is: all_to_all transpose (bring all n1 local for a slice of
n2) -> P-point DFT over the device axis as a tiny matmul -> twiddle
-> all_to_all transpose -> local B-point FFT.  The spectrum comes out in
the *strided* layout: device q holds ``X[q + P*k2]`` for k2 in [0, B).
That layout is perfectly fine for SSFM — the linear operator is simply
sampled at the strided frequencies (:func:`strided_w_grid`) — and the
inverse transform undoes the permutation, returning natural block layout.

Constraint: B must be divisible by P (i.e. N divisible by P^2).

No counterpart exists in the reference (single-process global NumPy/CuPy
FFT, reference opticomlib/devices.py:1179); this is the new-capability
layer.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["pencil_fft", "pencil_ifft", "strided_w_grid", "strided_k_local"]

_2PI = 2.0 * np.pi


def _dft_matrix(P: int, sign: float) -> jnp.ndarray:
    k = np.arange(P)
    W = np.exp(sign * 2j * np.pi * np.outer(k, k) / P)
    return jnp.asarray(W.astype(np.complex64))


def strided_k_local(q, P: int, B: int):
    """Global FFT bin indices held by device ``q`` after :func:`pencil_fft`:
    ``k = q + P*k2``, k2 in [0, B)."""
    return q + P * jnp.arange(B)


def strided_w_grid(q, P: int, B: int, fs: float):
    """Angular frequencies [rad/s] of the local spectrum slice on device
    ``q`` (fftfreq convention: bins >= N/2 wrap to negative)."""
    N = P * B
    k = strided_k_local(q, P, B)
    f = jnp.where(k < N - N // 2, k, k - N) / N * fs
    return _2PI * f


def pencil_fft(x, axis_name: str):
    """Distributed FFT of a block-sharded 1-D (last-axis) signal.

    Must be called inside ``shard_map`` with ``axis_name`` bound over P
    devices.  ``x``: local block, shape (..., B) with B % P == 0.  Returns
    the local strided spectrum slice, shape (..., B): element k2 is global
    bin ``q + P*k2``.
    """
    P = jax.lax.axis_size(axis_name)
    q = jax.lax.axis_index(axis_name)
    B = x.shape[-1]
    C = B // P
    N = P * B
    lead = x.shape[:-1]

    # 1) transpose: bring all n1 (device axis) local for n2 = q*C + c
    z = x.reshape(lead + (P, C))
    z = jax.lax.all_to_all(z, axis_name, split_axis=x.ndim - 1,
                           concat_axis=x.ndim - 1, tiled=True)
    # z[..., n1, c] = x_global[n1*B + q*C + c]

    # 2) P-point DFT over the n1 axis (tiny matmul; HIGHEST keeps the
    # GPU from running it in TF32, which would cost ~3 decimal digits)
    W1 = _dft_matrix(P, sign=-1.0)
    y = jnp.einsum("kn,...nc->...kc", W1, z,
                   precision=jax.lax.Precision.HIGHEST)

    # 3) twiddle e^{-2πi k1 n2 / N}, n2 = q*C + c
    k1 = jnp.arange(P, dtype=jnp.float32)[:, None]
    n2 = (q * C + jnp.arange(C, dtype=jnp.float32))[None, :]
    tw = jnp.exp((-2j * jnp.pi / N) * (k1 * n2)).astype(jnp.complex64)
    y = y * tw

    # 4) transpose: bring all n2 local for k1 = q
    y = jax.lax.all_to_all(y, axis_name, split_axis=x.ndim - 1,
                           concat_axis=x.ndim - 1, tiled=True)
    # y[..., p, c] corresponds to n2 = p*C + c, k1 = q
    y = y.reshape(lead + (B,))

    # 5) local B-point FFT over n2 -> X[q + P*k2]
    return jnp.fft.fft(y, axis=-1)


def pencil_ifft(X, axis_name: str):
    """Inverse of :func:`pencil_fft`: strided spectrum slice back to the
    natural block layout."""
    P = jax.lax.axis_size(axis_name)
    q = jax.lax.axis_index(axis_name)
    B = X.shape[-1]
    C = B // P
    N = P * B
    lead = X.shape[:-1]

    # 5') local inverse FFT over k2
    u = jnp.fft.ifft(X, axis=-1)  # u[n2], k1 = q

    # 3') conjugate twiddle e^{+2πi k1 n2 / N} with k1 = q
    n2 = jnp.arange(B, dtype=jnp.float32)
    tw = jnp.exp((2j * jnp.pi / N) * (q * n2)).astype(jnp.complex64)
    u = u * tw

    # 4') transpose: redistribute n2 slices, gather all k1
    u = u.reshape(lead + (P, C))
    u = jax.lax.all_to_all(u, axis_name, split_axis=X.ndim - 1,
                           concat_axis=X.ndim - 1, tiled=True)
    # u[..., k1, c], local n2 = q*C + c

    # 2') inverse P-point DFT over k1
    Wi = _dft_matrix(P, sign=+1.0) / P
    r = jnp.einsum("nk,...kc->...nc", Wi, u,
                   precision=jax.lax.Precision.HIGHEST)
    # r[..., n1, c] = x[n1*B + q*C + c]

    # 1') transpose back to contiguous blocks
    r = jax.lax.all_to_all(r, axis_name, split_axis=X.ndim - 1,
                           concat_axis=X.ndim - 1, tiled=True)
    return r.reshape(lead + (B,))
