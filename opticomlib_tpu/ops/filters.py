"""Zero-phase Bessel filtering as a spectral multiply.

The reference applies 4th-order Bessel IIR filters with
``scipy.signal.sosfiltfilt`` (forward-backward, zero phase) for its LPF/BPF
devices (reference opticomlib/devices.py:1286-1375 and 788-826).  IIR
recursions are sequential and map badly onto data-parallel hardware; but
*filtfilt is zero-phase by construction* — its transfer function is exactly
``|H(w)|^2`` of the designed filter.  So the data-parallel equivalent is an
FFT-domain multiply by the (real, nonnegative) squared magnitude response:

    y = ifft( fft(x) * |H_bessel(w)|^2 )

which is numerically the same operator up to boundary handling (sosfiltfilt
pads with reflected edges; we use circular convolution, appropriate for the
periodic PRBS frames this framework simulates — tests bound the mismatch).

The response is designed once on the host with scipy (identical
``sg.bessel(..., norm='mag')`` design as the reference, so cutoff behavior
matches exactly) and cached per (order, BW, fs, nfft).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal as sg

__all__ = [
    "bessel_filtfilt_response", "apply_freq_response", "bessel_lpf",
    "bessel_sos_response",
]


@lru_cache(maxsize=256)
def bessel_sos_response(n: int, BW: float, fs: float,
                        nfft: int) -> np.ndarray:
    """One-pass frequency response H(w) of the reference's Bessel design
    (``sg.bessel(N=n, Wn=BW, btype='low', fs=fs, norm='mag')``) sampled at
    the ``nfft`` FFT bin frequencies (natural FFT order).  complex128."""
    if BW < 0.5 * fs:
        sos = sg.bessel(N=n, Wn=BW, btype="low", fs=fs, output="sos",
                        norm="mag")
        _, H = sg.sosfreqz(sos, worN=nfft, fs=fs, whole=True)
        return H
    # Cutoff at/above Nyquist: the bilinear design is undefined (the
    # reference's sosfiltfilt would raise here).  Sample the *analog*
    # Bessel prototype response instead — same magnitude semantics,
    # valid for any BW.
    b, a = sg.bessel(N=n, Wn=2 * np.pi * BW, btype="low", analog=True,
                     output="ba", norm="mag")
    w = 2 * np.pi * fs * np.fft.fftfreq(nfft)
    _, H = sg.freqs(b, a, worN=w)
    return H


@lru_cache(maxsize=256)
def bessel_filtfilt_response(n: int, BW: float, fs: float,
                             nfft: int) -> np.ndarray:
    """Zero-phase (filtfilt-equivalent) response ``|H(w)|^2`` as float32."""
    H = bessel_sos_response(n, BW, fs, nfft)
    return (np.abs(H) ** 2).astype(np.float32)


def apply_freq_response(x, H):
    """Multiply the spectrum of ``x`` (last axis) by response ``H`` (natural
    FFT order) and return to time domain.  Real input -> real output.
    Dispatches to jnp when ``x`` is a jax array, NumPy (float64) otherwise."""
    xp = jnp if isinstance(x, jax.Array) else np
    x = xp.asarray(x)
    H = xp.asarray(H if xp is jnp else np.asarray(H, dtype=np.float64)
                   if not np.iscomplexobj(H) else H)
    was_real = not np.iscomplexobj(x)
    y = xp.fft.ifft(xp.fft.fft(x, axis=-1) * H, axis=-1)
    return y.real if was_real else y


def bessel_lpf(x, BW: float, fs: float, n: int = 4):
    """Zero-phase Bessel low-pass of the last axis of ``x``.

    Equivalent operator to the reference's
    ``sg.sosfiltfilt(sg.bessel(n, BW, norm='mag'), x)`` (devices.py:1363-1368)
    up to boundary handling."""
    nfft = int(np.shape(x)[-1])
    H2 = bessel_filtfilt_response(n, float(BW), float(fs), nfft)
    return apply_freq_response(x, H2)
