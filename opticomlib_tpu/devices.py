"""Device library: the TX -> channel -> RX simulation chain.

JAX re-implementation of the reference device layer
(reference: opticomlib/devices.py).  Every device keeps the reference's
call signature, parameter semantics, and physics; the numerics run through
:mod:`opticomlib_tpu.ops` (JAX/XLA on the default device for the FFT-heavy
paths, NumPy on host for cheap metadata work).  Per-device wall-clock is recorded on the
returned object as ``execution_time`` for parity with the reference's
tic/toc instrumentation (reference devices.py:133/178 et al.).

Device inventory (reference file:line):
  PRBS    devices.py:63-182     LFSR bit source (vectorized here, see
                                ops/prbs.py for the trinomial-doubling trick)
  DAC     devices.py:185-350    upsample + pulse shaping
  LASER   devices.py:353-510    CW laser w/ phase noise (Wiener) + RIN
  PM      devices.py:513-617    phase modulator
  MZM     devices.py:620-785    Mach-Zehnder modulator (finite ER, chirp)
  BPF     devices.py:788-826    optical band-pass (Bessel, zero-phase)
  EDFA    devices.py:829-942    flat-gain amplifier + ASE (2 pols)
  DM      devices.py:945-1035   pure dispersive medium
  FIBER   devices.py:1038-1206  split-step Fourier NLSE (see ops/ssfm.py)
  DBP     devices.py:1209-1283  digital back-propagation (= FIBER w/ flipped
                                signs)
  LPF     devices.py:1286-1375  electrical low-pass (Bessel, zero-phase)
  PD      devices.py:1378-1555  PIN photodetector w/ thermal/shot/ASE noise
  ADC     devices.py:1558-1632  resampling + uniform quantization
  GET_EYE devices.py:1635-1868  eye metrology (see ops/eyeana.py)
  SAMPLER devices.py:1871-1891  1-sample-per-slot downsampler
  FBG     devices.py:1894-2322  fiber Bragg grating (coupled-mode RK4 here,
                                vectorized over frequency, vs solve_ivp)
"""
from __future__ import annotations

import warnings
from typing import Literal, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal as sg
from scipy.constants import c, e, h, k as kB, pi

from . import rng
from .eyediag import Eye, eye
from .ops import eyeana, filters, noise as noise_ops, prbs as prbs_ops, \
    pulses, ssfm
from .params import gv
from .signals import (
    NULL, Array_Like, BinarySequence, ComplexNumber, ElectricalSignal,
    OpticalSignal, RealNumber, _has_noise,
    binary_sequence, electrical_signal, optical_signal,
)
from .utils.analysis import idb, idbm, shortest_int, si, tic, toc
from .utils.analysis import db, dispersion as _dispersion_of, tau_g as _tau_g
from .utils.analysis import rcos as _rcos_spectrum

__all__ = [
    "PRBS", "DAC", "LASER", "PM", "MZM", "BPF", "EDFA", "DM", "FIBER",
    "DBP", "LPF", "PD", "ADC", "GET_EYE", "SAMPLER", "FBG",
    "animated_fiber_propagation", "animated_fiber_propagation_with_phase",
]


# ---------------------------------------------------------------------------
# PRBS (reference devices.py:63-182)
# ---------------------------------------------------------------------------
def PRBS(order: int, len: Optional[int] = None, seed: Optional[int] = None,
         return_seed: bool = False):
    """Pseudorandom binary sequence generator (orders 7/9/11/15/20/23/31).

    Bit-exact with the reference LFSR (golden vectors:
    reference tests/devices_test.py:55-69) but generated with the
    O(log n)-step trinomial-squaring scheme of :func:`ops.prbs.prbs`
    instead of a per-bit Python loop (reference devices.py:170-175).

    Parameters
    ----------
    order : int
        LFSR register length; one of {7, 9, 11, 15, 20, 23, 31}.  The
        sequence period is ``2**order - 1``.
    len : int, optional
        Number of bits to emit (default: one full period).  Longer
        requests wrap around the period.
    seed : int, optional
        Initial register state (non-zero, < 2**order); default is the
        all-ones state the reference uses.
    return_seed : bool, optional
        Also return the final register state, to continue the stream in
        a later call (``PRBS(order, len, seed=state)``).

    Returns
    -------
    BinarySequence, or (BinarySequence, int) when ``return_seed``.

    Examples
    --------
    >>> PRBS(order=7, len=8).data
    array([1, 1, 1, 1, 1, 1, 1, 0], dtype=uint8)
    """
    tic()
    bits, state = prbs_ops.prbs(order, length=len, seed=seed)
    output = BinarySequence(bits)
    output.execution_time = toc()
    if return_seed:
        return output, state
    return output


# ---------------------------------------------------------------------------
# DAC (reference devices.py:185-350)
# ---------------------------------------------------------------------------
def DAC(input, pulse_shape: str = "nrz", coupling: str = "DC",
        Vpp: Optional[float] = 1.0, offset: Optional[float] = 0.0,
        h=None, BW: Optional[float] = None, **kwargs) -> ElectricalSignal:
    """Digital-to-analog converter: bits -> pulse-shaped electrical signal
    sampled at ``gv.fs`` (upsample x ``gv.sps`` + FIR shaping via FFT
    convolution on the accelerator; reference devices.py:185-350).

    Parameters
    ----------
    input : bits (str/list/ndarray/BinarySequence)
        The symbol/slot sequence to shape.
    pulse_shape : {'nrz', 'gaussian', 'rcos'}
        FIR prototype: rectangular, (super-)Gaussian (``T`` FWHM slots,
        order ``m``, chirp ``c``), or raised-cosine (``beta`` roll-off,
        ``rcos_type`` 'normal'|'sqrt') — see :mod:`opticomlib_tpu.ops.
        pulses` for the shape definitions.
    coupling : {'DC', 'AC'}
        'AC' removes the waveform mean after scaling.
    Vpp, offset : float
        Peak-to-peak scale and DC offset applied after shaping.
    h : array_like, optional
        Custom FIR taps — overrides ``pulse_shape``.
    BW : float, optional
        Post-shaping electrical bandwidth: a zero-phase Bessel low-pass
        (same operator as :func:`LPF`).
    **kwargs
        Shape parameters (``T``, ``m``, ``c``, ``beta``, ``rcos_type``).

    Returns
    -------
    ElectricalSignal
        ``len(input) * gv.sps`` samples; ``execution_time`` attached.

    Notes
    -----
    The convolution runs as an FFT product padded to the next 5-smooth
    length (:func:`opticomlib_tpu.ops.pulses.fft_convolve_same`).  For
    the fully fused TX path use
    :func:`opticomlib_tpu.link.build_link`, which folds this shaping
    into the one-program chain as a circular spectral multiply.
    """
    tic()
    SHAPES = ["nrz", "gaussian", "rcos"]

    seq = BinarySequence(input)
    bits = seq.size
    sps = gv.sps
    data = seq.to_numpy()

    if h is not None:
        x = pulses.upfir(data, np.asarray(h), up=sps)
    elif pulse_shape.lower() not in SHAPES:
        raise ValueError(
            f"The parameter `pulse_shape` must be one of the following values {SHAPES}")
    elif pulse_shape.lower() == "nrz":
        T = kwargs.get("T", 1)
        if not isinstance(T, (int, np.integer)) or isinstance(T, bool):
            raise TypeError("The parameter `T` must be an integer.")
        if T <= 0:
            raise ValueError("The parameter `T` must be greater than 0.")
        if T > 2 * sps:
            raise ValueError("The parameter `T` must be less than 2*sps.")
        span = max(4, bits - 4)
        x = pulses.upfir(data, pulses.nrz_pulse(span=span, sps=sps, T=T), up=sps)
    elif pulse_shape.lower() == "gaussian":
        c_ = kwargs.get("c", 0.0)
        m = kwargs.get("m", 1)
        T = kwargs.get("T", 1)
        if not isinstance(c_, RealNumber) or isinstance(c_, bool):
            raise TypeError("The parameter `c` must be a real number.")
        if not isinstance(m, (int, np.integer)) or isinstance(m, bool):
            raise TypeError("The parameter `m` must be an integer.")
        if not isinstance(T, (int, np.integer)) or isinstance(T, bool):
            raise TypeError("The parameter `T` must be an integer.")
        if m <= 0:
            raise ValueError("The parameter `m` must be greater than 0.")
        if T <= 0:
            raise ValueError("The parameter `T` must be greater than 0.")
        if T > 2 * sps:
            raise ValueError("The parameter `T` must be less than 2*sps.")
        span = max(4, bits - 4)
        hp = pulses.gauss_pulse(span=span, sps=sps, T=T, m=m, c=c_)
        if c_ == 0:
            hp = hp.real
        x = pulses.upfir(data, hp, up=sps)
    else:  # rcos
        beta = kwargs.get("beta", 0.25)
        rcos_type = kwargs.get("rcos_type", "normal")
        span = max(4, bits - 4)
        hp = pulses.rcos_pulse(beta=beta, span=span, sps=sps, shape=rcos_type)
        x = pulses.upfir(data, hp, up=sps)

    if Vpp is not None:
        if not isinstance(Vpp, RealNumber) or isinstance(Vpp, bool):
            raise TypeError("The parameter `Vpp` must be a scalar value.")
        if Vpp <= 0 or Vpp > 48:
            raise ValueError(
                "The parameter `Vpp` must be in the range (0, 48] Volts.")
        x = x * Vpp

    if offset is not None:
        if not isinstance(offset, RealNumber) or isinstance(offset, bool):
            raise TypeError("The parameter `offset` must be a scalar value.")
        if np.abs(offset) > 48:
            raise ValueError(
                "The parameter `offset` must be in the range [-48, 48] Volts.")
        x = x + offset

    if coupling.upper() == "AC":
        x = x - np.mean(np.asarray(x))
    elif coupling.upper() != "DC":
        raise ValueError("The parameter `coupling` must be either 'AC' or 'DC'.")

    output = ElectricalSignal(np.asarray(x))
    if BW is not None:
        output = LPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# LASER (reference devices.py:353-510)
# ---------------------------------------------------------------------------
def LASER(P0, lw: Optional[float] = None, rin: Optional[float] = None,
          df: Optional[float] = None, key=None) -> OpticalSignal:
    """CW laser complex envelope with Wiener phase noise (variance
    ``2*pi*lw*dt`` per step, reference devices.py:485-490), Gaussian RIN
    (variance ``idb(rin)*fs``, devices.py:492-500), and frequency offset.

    Parameters
    ----------
    P0 : float
        Average optical power [dBm]; the field amplitude is
        ``sqrt(idbm(P0))``.
    lw : float, optional
        Lorentzian linewidth [Hz] -> random-walk phase with per-sample
        increments N(0, ``2*pi*lw*dt``).
    rin : float, optional
        Relative intensity noise [dB/Hz]; amplitude modulated by
        ``sqrt(1 + N(0, idb(rin)*fs))``.
    df : float, optional
        Carrier frequency offset [Hz]: multiplies ``exp(j*2*pi*df*t)``
        on ``gv.t``.
    key : jax key or int, optional
        Optional ``jax.random`` key or int seed for **device-side,
        reproducible** noise (see :mod:`opticomlib_tpu.rng`); also drawn
        implicitly from the global stream after ``gv(seed=...)``.
        Without a key the reference's legacy host NumPy RNG is used.

    Returns
    -------
    OpticalSignal
        ``gv.N * gv.sps`` complex samples, single polarization.
    """
    tic()
    t = gv.t
    out = np.ones_like(t) * np.sqrt(idbm(P0))

    key = rng.resolve(key)
    if key is not None:
        k_ph, k_rin = jax.random.split(key)

    if lw is not None:
        # lw == 0 still consumes t.size draws (zero-variance walk), keeping
        # the legacy np.random stream aligned with the reference
        # (devices.py:487-491 gates on `lw is not None`, not on lw > 0)
        sigma = np.sqrt(2 * pi * lw * gv.dt)
        if key is not None:
            phase_noise = noise_ops.wiener_phase(k_ph, t.size, sigma)
        else:
            phase_noise = np.cumsum(np.random.normal(0, sigma, t.size))
        if lw > 0:
            out = out * np.exp(1j * phase_noise)

    if rin is not None:
        sigma = np.sqrt(idb(rin) * gv.fs)
        if key is not None:
            rin_noise = noise_ops.gaussian(k_rin, t.size, sigma)
        else:
            rin_noise = np.random.normal(0, sigma, t.size)
        if rin_noise.min() < -1:
            raise ValueError(
                "Noise power is to high, try decrease RIN parameter.")
        out = out * np.sqrt(1 + rin_noise)

    if df is not None:
        if np.abs(df) > gv.fs / 2:
            raise ValueError(
                "The laser frequency is out of the Nyquist range. "
                "Try increase the sampling frequency.")
        out = out * np.exp(1j * 2 * pi * df * t)

    output = OpticalSignal(out)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# PM (reference devices.py:513-617)
# ---------------------------------------------------------------------------
def PM(op_input: OpticalSignal, el_input, Vpi: float = 5.0) -> OpticalSignal:
    """Optical phase modulator: ``E * exp(j*pi*u(t)/Vpi)``
    (reference devices.py:513-617).  ``el_input`` may be a scalar
    (static phase) or a waveform; the optical noise track is rotated by
    the same phase.  In the fused link select it with
    ``LinkSpec(modulator="pm")``."""
    tic()
    if not isinstance(op_input, OpticalSignal):
        raise TypeError("`op_input` must be of type 'optical_signal'.")
    if isinstance(el_input, RealNumber):
        u = float(el_input)
    else:
        el = ElectricalSignal(el_input) if not isinstance(
            el_input, ElectricalSignal) else el_input
        u = el.to_numpy().real
        if u.ndim > 1:
            raise ValueError("`el_input` must be a scalar or 1D-array.")

    ph = np.exp(1j * pi * u / Vpi)
    noi = op_input.noise * ph if _has_noise(op_input.noise) else NULL
    output = OpticalSignal(op_input.signal * ph, noi, n_pol=op_input.n_pol)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# MZM (reference devices.py:620-785)
# ---------------------------------------------------------------------------
def MZM(op_input: OpticalSignal, el_input, bias: float = 0.0,
        Vpi: float = 5.0, loss_dB: float = 0.0, ER_dB: float = 26.0,
        pol: str = "x", BW: Optional[float] = None) -> OpticalSignal:
    """Mach-Zehnder modulator, push-pull with finite extinction ratio:

    ``h(t) = sqrt(loss) * [cos(g) + j*(eta/2)*sin(g)]``,
    ``g = pi*(u + bias)/(2*Vpi)``, ``eta = 2*10**(-ER/20)``
    (reference devices.py:762-768).

    Parameters
    ----------
    op_input : OpticalSignal
        Carrier field.
    el_input : ElectricalSignal / array / scalar
        Drive voltage u(t); the noise track (if any) modulates too.
    bias, Vpi : float
        DC bias [V] and half-wave voltage [V].  Quadrature operation:
        ``bias = -Vpi/2`` with a ``[0, Vpi]`` drive swing.
    loss_dB, ER_dB : float
        Insertion loss and extinction ratio [dB]; min/max output power
        is ``P0 - ER - loss`` / ``P0 - loss`` (the physics invariant
        reference tests/devices_test.py:126-128 checks).
    pol : {'x', 'y'}
        With a 2-pol input, the unmodulated polarization is zeroed.
    BW : float, optional
        Output optical bandwidth (zero-phase Bessel, :func:`BPF`).
    """
    tic()
    if not isinstance(op_input, OpticalSignal):
        raise TypeError("`op_input` must be of type 'optical_signal'.")
    el = ElectricalSignal(el_input) if not isinstance(
        el_input, ElectricalSignal) else el_input
    if el.ndim > 1:
        raise ValueError("`el_input` must be a scalar or 1D-array.")
    if el.size not in (1, op_input.size):
        raise ValueError(
            "`el_input` must be a scalar or an array of the same length as "
            "`op_input`.")
    if pol not in ("x", "y"):
        raise ValueError(
            "The parameter `pol` must be one of the following values ('x', 'y').")

    loss = idb(-loss_dB)
    eta = 2 * idb(-ER_dB) ** 0.5

    u = el.to_numpy().real  # drive voltage = signal + noise
    g_t = pi / 2 / Vpi * (u + bias)
    h_t = loss**0.5 * (np.cos(g_t) + 1j * eta / 2 * np.sin(g_t))

    # bilinear signal/noise product with the (noiseless) field transfer h(t)
    output = op_input * h_t
    output = OpticalSignal(output.signal, output.noise, n_pol=op_input.n_pol)

    if output.n_pol == 2:
        kill = 1 if pol == "x" else 0
        sig = np.array(output.signal, copy=True)
        sig[kill] = 0
        output.signal = sig
        if _has_noise(output.noise):
            noi = np.array(output.noise, copy=True)
            noi[kill] = 0
            output.noise = noi

    if BW is not None:
        output = BPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# BPF (reference devices.py:788-826)
# ---------------------------------------------------------------------------
def BPF(input: OpticalSignal, BW: float, n: int = 4) -> OpticalSignal:
    """Optical band-pass filter (baseband low-pass equivalent): n-th order
    Bessel, zero-phase.  Implemented as an FFT-domain multiply by the
    filtfilt-equivalent ``|H|^2`` response (see ops/filters.py) instead of
    the reference's sequential ``sosfiltfilt`` (devices.py:818-822)."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type (optical_signal).")
    H2 = filters.bessel_filtfilt_response(n, float(BW / 2), float(gv.fs),
                                          int(np.shape(input.signal)[-1]))
    H2 = np.asarray(H2, dtype=np.float64)
    sig = filters.apply_freq_response(input.signal, H2)
    noi = (filters.apply_freq_response(input.noise, H2)
           if _has_noise(input.noise) else NULL)
    output = OpticalSignal(sig, noi, n_pol=input.n_pol)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# EDFA (reference devices.py:829-942)
# ---------------------------------------------------------------------------
def EDFA(input: OpticalSignal, G: float, NF: float,
         BW: Optional[float] = None, key=None) -> OpticalSignal:
    """Flat-gain amplifier: field gain ``sqrt(G)`` plus ASE noise of power
    ``NF*h*f0*(G-1)*fs`` split over two polarizations x (re, im)
    (reference devices.py:930-936).

    Parameters
    ----------
    input : OpticalSignal
        Field to amplify; the output always carries 2 polarizations
        (the orthogonal-pol ASE contributes direct-detected power and
        ASE-ASE beat noise at the PD).
    G, NF : float
        Gain and noise figure [dB].
    BW : float, optional
        Output optical band-pass (zero-phase Bessel, :func:`BPF`;
        reference devices.py:938-941).
    key : jax key or int, optional
        Key/seed for device-side reproducible ASE
        (see :mod:`opticomlib_tpu.rng`); legacy NumPy RNG otherwise.

    Returns
    -------
    OpticalSignal
        2-pol field; ASE rides the ``.noise`` track so the PD can split
        signal-ASE / ASE-ASE beats algebraically.
    """
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")

    output = OpticalSignal(signal=input.signal, noise=input.noise,
                           n_pol=2) * np.sqrt(idb(G))
    output = OpticalSignal(output.signal, output.noise, n_pol=2)

    if input.n_pol == 1:
        sig = np.array(output.signal, copy=True)
        sig[1] = 0
        output.signal = sig
        if _has_noise(output.noise):
            noi = np.array(output.noise, copy=True)
            noi[1] = 0
            output.noise = noi

    P_ase = noise_ops.ase_power(G, NF, gv.f0, gv.fs)
    key = rng.resolve(key)
    if key is not None:
        ase = noise_ops.ase_draws(key, input.size, P_ase)
    else:
        ase = np.sqrt(P_ase / 4) * np.random.randn(4, input.size)
        ase = ase[:2] + 1j * ase[2:]

    noi = output.noise + ase if _has_noise(output.noise) else ase
    output = OpticalSignal(output.signal, noi, n_pol=2)

    if BW is not None:
        output = BPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# DM (reference devices.py:945-1035)
# ---------------------------------------------------------------------------
def DM(input: OpticalSignal, D: float, retH: bool = False):
    """Pure dispersive medium: frequency-domain phase
    ``H = exp(j*w^2*D/2)`` with ``D`` in [ps^2] (reference devices.py:1027).

    ``D = -beta_2 * length`` exactly compensates a linear fiber span;
    ``retH`` also returns the (fftshifted) response for inspection.
    In the fused link this device is the ``DMSpec`` stage."""
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")

    w = input.w() * 1e-12  # rad/ps
    H = np.exp(1j * w**2 * D / 2)

    sig = filters.apply_freq_response(input.signal, H)
    noi = (filters.apply_freq_response(input.noise, H)
           if _has_noise(input.noise) else NULL)
    output = OpticalSignal(sig, noi, n_pol=input.n_pol)
    output.execution_time = toc()
    if retH:
        return output, np.fft.fftshift(H)
    return output


# ---------------------------------------------------------------------------
# FIBER / DBP (reference devices.py:1038-1283)
# ---------------------------------------------------------------------------
def FIBER(input: OpticalSignal, length: float, alpha: float = 0.0,
          beta_2: float = 0.0, beta_3: float = 0.0, gamma: float = 0.0,
          phi_max: float = 0.01, h: Optional[float] = None,
          show_progress: bool = False, return_steps: bool = False,
          method: str = "reference", tol: float = 1e-5,
          mesh=None, shard_method: str = "pencil"):
    """Optical fiber: split-step Fourier NLSE with adaptive step bounded by
    the max nonlinear phase rotation (Sinkin 2003), or fixed step ``h``.

    The propagation loop runs fully on-device inside jit
    (see :mod:`opticomlib_tpu.ops.ssfm`) — the reference's CuPy backend
    switch (devices.py:1114-1134) is replaced by XLA compilation.
    ``show_progress=True`` renders a tqdm bar fed by an async per-step
    ``jax.debug.callback`` (parity with reference devices.py:1164-1170);
    the callback is only compiled in when requested, so the default path
    pays nothing.

    ``method`` selects the splitting scheme (beyond-parity option):

    * ``"reference"`` (default) — the reference's scheme
      (devices.py:1172-1196): symmetric step with the nonlinear operator
      frozen at step start, ``phi_max``-adaptive or fixed ``h``.
    * ``"o4"`` — 4th-order Yoshida composition: fixed step when ``h`` is
      given (~50x lower splitting error at equal ``h``), **self-tuning**
      when ``h=None`` (step-doubling local-error control targeting
      relative local error ``tol`` per step — no calibration needed; see
      :func:`opticomlib_tpu.ops.ssfm.ssfm_o4_auto`).
    * ``"local_error"`` — Sinkin local-error adaptive stepping with
      Richardson extrapolation; target relative local error ``tol``.

    ``mesh``: optional :class:`jax.sharding.Mesh` with a ``'time'`` axis
    (and optionally ``'wdm'``) — the waveform's sample axis is sharded
    across the mesh and propagated by the multi-device solver
    (:func:`opticomlib_tpu.parallel.fiber.ssfm_sharded`), adaptive
    (``h=None``, per-step all-reduce(max)) or fixed-step.  All three
    ``method`` schemes work on the mesh (round 5): the higher-order
    schemes run on the pencil-FFT path with their error norms
    all-reduced so every device agrees on the step sequence.
    ``shard_method`` selects ``'pencil'`` (exact distributed FFT),
    ``'overlap'`` (halo exchange; cheaper interconnect, approximate), or
    ``'auto'`` (pick by the measured ``2H/block`` crossover — see
    :func:`opticomlib_tpu.parallel.fiber.resolve_shard_method`).  A
    ``jax.Array`` signal payload stays device-resident across chained
    mesh stages (no host round-trips).

    Parameters
    ----------
    input : OpticalSignal
        Field envelope A(t); 1 or 2 polarizations (last axis = time).
    length : float
        Span length [km].
    alpha : float
        Attenuation [dB/km] (power); the field decays ``exp(-a/2 z)``
        with ``a = alpha / (10 log10 e)``.
    beta_2, beta_3 : float
        GVD [ps^2/km] and dispersion slope [ps^3/km].
    gamma : float
        Kerr nonlinearity [1/W/km].
    phi_max : float
        Adaptive-step bound: the per-step nonlinear phase rotation
        ``gamma * max|A|^2 * h`` never exceeds this [rad].
    h : float, optional
        Fixed step [km]; ``None`` -> adaptive (the default).
    return_steps : bool
        Capture and return the whole (z, A(z)) trajectory instead
        (host-stepped; reference devices.py:1149-1202).

    Returns
    -------
    OpticalSignal (or ``(z, A_z)`` arrays when ``return_steps``).

    Notes
    -----
    Step count scales as ``gamma * maxP * length / phi_max``; each step
    costs two full-length complex FFTs plus fused pointwise work.  For
    checkpoint/resume of very long spans see
    :func:`opticomlib_tpu.runtime.ssfm_propagate_resumable` (host path)
    and ``ssfm_sharded(ckpt_dir=...)`` (mesh path).
    """
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")
    if method not in ("reference", "o4", "local_error"):
        raise ValueError(
            "`method` must be 'reference', 'o4' or 'local_error'.")

    if mesh is not None:
        if return_steps:
            raise ValueError("mesh= does not support return_steps")
        from .parallel.fiber import shard_waveform, ssfm_sharded

        # keep the waveform DEVICE-RESIDENT across staged mesh calls: a
        # jax.Array payload (e.g. the previous FIBER(mesh=) output) goes
        # straight back to the sharded solver — no host round-trip per
        # stage (round-2 gathered to NumPy on both sides)
        if isinstance(input.signal, jax.Array) and not _has_noise(
                input.noise):
            A = input.signal
        else:
            A = input.to_numpy().astype(np.complex64)
        wdm_axis = ("wdm" if "wdm" in mesh.shape and A.ndim == 2
                    and np.shape(A)[0] % mesh.shape["wdm"] == 0 else None)
        out = ssfm_sharded(
            shard_waveform(A, mesh, wdm_axis), mesh, fs=gv.fs,
            length=float(length),
            alpha=float(alpha), beta_2=float(beta_2), beta_3=float(beta_3),
            gamma=float(gamma), h=None if h is None else float(h),
            phi_max=float(phi_max), method=shard_method, wdm_axis=wdm_axis,
            scheme=method, tol=float(tol))
        output = OpticalSignal(out, n_pol=input.n_pol)
        output.execution_time = toc()
        return output

    A = input.to_numpy().astype(np.complex64)
    w = input.w()

    if method == "o4":
        if return_steps:
            raise ValueError("return_steps is only available with "
                             "method='reference'.")
        if h is None:
            result = ssfm.ssfm_o4_auto(
                A, w, float(length), alpha=float(alpha),
                beta_2=float(beta_2), beta_3=float(beta_3),
                gamma=float(gamma), tol=float(tol))
        else:
            result = ssfm.ssfm_scan_o4(
                A, w, float(length), alpha=float(alpha),
                beta_2=float(beta_2), beta_3=float(beta_3),
                gamma=float(gamma), h=float(h))
    elif method == "local_error":
        if return_steps:
            raise ValueError("return_steps is only available with "
                             "method='reference'.")
        result, _ = ssfm.ssfm_local_error(
            A, w, float(length), alpha=float(alpha),
            beta_2=float(beta_2), beta_3=float(beta_3),
            gamma=float(gamma), tol=float(tol),
            h0=None if h is None else float(h))
    else:
        progress = show_progress and not return_steps

        def _run():
            return ssfm.ssfm_propagate(
                A, w, length=float(length), alpha=float(alpha),
                beta_2=float(beta_2), beta_3=float(beta_3),
                gamma=float(gamma), phi_max=float(phi_max),
                h=None if h is None else float(h),
                return_steps=return_steps, progress=progress)
        if progress:
            with ssfm.progress_bar():
                result = _run()
        else:
            result = _run()

    if return_steps:
        toc()  # balance the timer stack (no result object to annotate)
        return result  # (z, A_z)

    output = OpticalSignal(np.asarray(result), n_pol=input.n_pol)
    output.execution_time = toc()
    return output


def DBP(input: OpticalSignal, length: float, alpha: float = 0.0,
        beta_2: float = 0.0, beta_3: float = 0.0, gamma: float = 0.0,
        phi_max: float = 0.01, h: Optional[float] = None,
        show_progress: bool = False, return_steps: bool = False,
        method: str = "reference", tol: float = 1e-5):
    """Digital back-propagation: FIBER with all operator signs inverted
    (alpha -> -alpha, beta -> -beta, gamma -> -gamma; reference
    devices.py:1280-1283) — the receiver-side equalizer that undoes a
    span's dispersion and Kerr rotation.  ``DBP(FIBER(x)) ~= x`` to the
    splitting error (tested; see also the fused ``DBPSpec`` stage and
    docs/performance.md's long-haul accuracy study)."""
    return FIBER(input, length=length, alpha=-alpha, beta_2=-beta_2,
                 beta_3=-beta_3, gamma=-gamma, phi_max=phi_max, h=h,
                 show_progress=show_progress, return_steps=return_steps,
                 method=method, tol=tol)


# ---------------------------------------------------------------------------
# LPF (reference devices.py:1286-1375)
# ---------------------------------------------------------------------------
def LPF(input, BW: float, n: int = 4, fs: Optional[float] = None,
        retH: bool = False):
    """Electrical low-pass: n-th order Bessel, zero-phase, real output.
    FFT-domain filtfilt-equivalent (see ops/filters.py).

    Parameters
    ----------
    input : ElectricalSignal / array
        1-D waveform; signal and noise tracks are filtered alike.
    BW : float
        Cutoff frequency [Hz] (magnitude-normalized Bessel design, the
        reference's ``norm='mag'``; reference devices.py:1286-1375).
    n : int
        Filter order.
    fs : float, optional
        Sampling rate override (default ``gv.fs``).
    retH : bool
        Also return the one-pass response H(w) on the fftshifted grid
        (for :func:`opticomlib_tpu.bode`).
    """
    tic()
    if not isinstance(input, ElectricalSignal):
        input = ElectricalSignal(input)
    if input.ndim != 1:
        raise ValueError("`input` must be a 1D-array.")
    if not fs:
        fs = gv.fs

    nfft = int(np.shape(input.signal)[-1])
    H2 = np.asarray(filters.bessel_filtfilt_response(n, float(BW), float(fs),
                                                     nfft), dtype=np.float64)
    sig = np.asarray(filters.apply_freq_response(input.signal, H2)).real
    noi = (np.asarray(filters.apply_freq_response(input.noise, H2)).real
           if _has_noise(input.noise) else NULL)
    output = ElectricalSignal(sig, noi)

    if retH:
        H = filters.bessel_sos_response(n, float(BW), float(fs), input.size)
        output.execution_time = toc()
        return output, np.fft.fftshift(H)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# PD (reference devices.py:1378-1555)
# ---------------------------------------------------------------------------
def PD(input: OpticalSignal, BW: float, r: float = 1.0, T: float = 300.0,
       R_load: float = 50.0, include_noise: str = "all",
       i_dark: float = 10e-9, Fn: float = 0, key=None) -> ElectricalSignal:
    """PIN photodetector.

    ``i = r*|E|^2`` summed over polarizations; the signal-ASE and ASE-ASE
    beat terms fall out *algebraically* from the signal/noise bilinear
    product (reference devices.py:1460-1517); thermal noise
    ``4*kB*T*Fn*Df/R_L`` and shot noise ``2*e*(i_mean+i_dark)*Df`` are drawn
    as Gaussians (devices.py:1521-1527); output is the voltage ``i*R_L``
    low-pass filtered to ``BW``.

    Parameters
    ----------
    input : OpticalSignal
        Incident field (1 or 2 polarizations; both are detected).
    BW : float
        Electrical bandwidth [Hz] — the noise-equivalent bandwidth of
        the draws and the cutoff of the output Bessel low-pass.
    r : float
        Responsivity [A/W], in (0, 1].
    T, R_load, Fn : float
        Temperature [K], load resistance [ohm], and electrical noise
        figure [dB] for the thermal term.
    include_noise : str
        Any combination of {'ase', 'thermal', 'shot'} joined by '-',
        'all', or 'none' — selects which noise contributions survive
        (reference devices.py:1484-1512 menu).
    i_dark : float
        Dark current [A], folded into the shot term and the DC level.
    key : jax key or int, optional
        Key/seed for device-side reproducible thermal/shot noise
        (see :mod:`opticomlib_tpu.rng`); legacy NumPy RNG otherwise.

    Returns
    -------
    ElectricalSignal
        Filtered voltage; the deterministic part rides ``.signal`` and
        the noise track rides ``.noise`` (so eye/BER analytics can
        split them).
    """
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")
    if not isinstance(r, RealNumber) or isinstance(r, bool):
        raise TypeError("`r` must be a scalar value.")
    if r <= 0 or r > 1:
        raise ValueError("`r` must be in the range (0,1]")
    if not isinstance(T, RealNumber) or isinstance(T, bool):
        raise TypeError("`T` must be a scalar value.")
    if T < 0:
        raise ValueError("`T` must be a positive value.")
    if not isinstance(R_load, RealNumber) or isinstance(R_load, bool):
        raise TypeError("`R_load` must be a scalar value.")
    if R_load < 0:
        raise ValueError("`R_load` must be a positive value.")
    if not isinstance(include_noise, str):
        raise TypeError("`include_noise` must be a string.")

    i_ph = (input * input.conj()).real * r
    if input.n_pol == 2:
        i_ph = i_ph.sum(axis=0)

    include_noise = include_noise.lower()
    valid = {"ase-only", "thermal-only", "shot-only", "ase-thermal",
             "ase-shot", "thermal-shot", "all", "none"}
    if include_noise not in valid:
        raise ValueError(
            "The argument `include_noise` must be one of the following: "
            "'ase-only','thermal-only','shot-only','ase-thermal','ase-shot',"
            "'thermal-shot','all', 'none'.")

    key = rng.resolve(key)
    if key is not None:
        k_T, k_N = jax.random.split(key)

    i_T = i_N = None
    if "thermal" in include_noise or include_noise == "all":
        S_T = 4 * kB * T * gv.fs / 2 * idb(Fn) / R_load
        if key is not None:
            i_T = noise_ops.gaussian(k_T, input.size, S_T**0.5)
        else:
            i_T = np.random.normal(0, S_T**0.5, input.size)
    if "shot" in include_noise or include_noise == "all":
        mean_i = float(np.mean(np.asarray(i_ph.to_numpy()).real))
        S_N = 2 * e * (mean_i + i_dark) * gv.fs / 2
        if key is not None:
            i_N = noise_ops.gaussian(k_N, input.size, S_N**0.5)
        else:
            i_N = np.random.normal(0, S_N**0.5, input.size)

    ase = np.asarray(i_ph.noise).real if _has_noise(i_ph.noise) else 0.0

    if include_noise == "ase-only":
        i_noise = ase + i_dark
    elif include_noise == "thermal-only":
        i_noise = i_T + i_dark
    elif include_noise == "shot-only":
        i_noise = i_N + i_dark
    elif include_noise == "ase-shot":
        i_noise = ase + i_N + i_dark
    elif include_noise == "ase-thermal":
        i_noise = ase + i_T + i_dark
    elif include_noise == "thermal-shot":
        i_noise = i_T + i_N + i_dark
    elif include_noise == "all":
        i_noise = ase + i_N + i_T + i_dark
    else:  # none
        i_noise = None

    if i_noise is None:
        noi = NULL
    else:
        noi = np.broadcast_to(np.asarray(i_noise, dtype=float) * R_load,
                              (input.size,)).copy()

    output = ElectricalSignal(np.asarray(i_ph.signal).real * R_load, noi)
    output = LPF(output, BW)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# ADC (reference devices.py:1558-1632)
# ---------------------------------------------------------------------------
def ADC(input, fs: Optional[float] = None, n: int = 8,
        otype: str = "v") -> ElectricalSignal:
    """Analog-to-digital converter: optional FFT resampling to ``fs`` then
    uniform ``n``-bit quantization over the robust 99.99% shortest-interval
    range (reference devices.py:1616-1627).

    Parameters
    ----------
    input : ElectricalSignal / array
        Waveform to digitize (real part is quantized).
    fs : float, optional
        Resample to this rate first (``scipy.signal.resample``
        semantics via :func:`ops.pulses.resample_fft`).
    n : int
        Bits of resolution (2**n uniform codes across the robust
        range; out-of-range samples extrapolate like the reference —
        no clipping).
    otype : {'v', 'n'}
        Output as reconstructed volts or as integer code numbers.
    """
    tic()
    if not isinstance(input, ElectricalSignal):
        input = ElectricalSignal(input)
    signal = np.asarray(input.signal)

    if fs is not None:
        signal = np.asarray(
            pulses.resample_fft(signal, int(input.size * fs / input.fs)))

    V_min, V_max = shortest_int(signal.real, 99.99)
    dig = np.round((signal.real - V_min) / (V_max - V_min) * (2**n - 1)
                   ).astype(int)
    if otype == "v":
        dig = dig / (2**n - 1) * (V_max - V_min) + V_min
    elif otype != "n":
        raise ValueError("`otype` must be 'v' or 'n'.")

    output = ElectricalSignal(dig)
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# GET_EYE (reference devices.py:1635-1868)
# ---------------------------------------------------------------------------
def GET_EYE(input, nslots: int = 4096,
            sps_resamp: Optional[int] = None,
            engine: Literal["auto", "host", "device"] = "auto") -> Eye:
    """Blind eye-diagram metrology.

    Statistical kernels are vectorized reductions (ops/eyeana.py) replacing
    the reference's sklearn KMeans / scipy gaussian_kde; outputs carry the
    same field names/meanings within estimation tolerance.

    ``engine`` selects where the reductions run: ``"host"`` is the NumPy
    pipeline; ``"device"`` runs the jitted twin
    (:func:`opticomlib_tpu.ops.eyeana.eye_metrics_jax`) on the accelerator —
    only scalars and the rendering traces come back to the host.  ``"auto"``
    picks the device when the signal payload is already a ``jax.Array``
    (e.g. the output of a fused link program), the host otherwise.

    Parameters
    ----------
    input : ElectricalSignal / ndarray / jax.Array
        Waveform at ``gv.sps`` samples per slot.
    nslots : int
        Maximum number of slots fed to the estimator (the reference
        default analysis window; reference devices.py:1731-1740).
    sps_resamp : int, optional
        FFT-resample each trace to this many samples/slot before
        estimation (finer crossing/threshold localization).

    Returns
    -------
    Eye
        Estimated parameters — level means/sigmas (``mu0/mu1/s0/s1``),
        crossing times (``t_left/t_right/t_opt``), extinction ratio
        ``er`` [dB], eye opening ``eye_h``, KDE-minimum decision
        ``threshold`` — plus the rendering traces for
        :meth:`Eye.plot`.  Pipeline: amplitude split -> shortest-50%
        intervals -> crossing-band clustering -> +/-5% window stats ->
        KDE threshold (same stages as reference devices.py:1635-1868).
    """
    tic()
    if isinstance(input, np.ndarray) and input.ndim > 2:
        raise ValueError("The input must be a 1D or 2D array.")
    if not isinstance(input, ElectricalSignal) \
            and not isinstance(input, jax.Array):
        input = ElectricalSignal(np.asarray(input))
    if isinstance(input, jax.Array):
        input = ElectricalSignal(input)

    sps = input.sps
    on_device = isinstance(input.signal, jax.Array)
    use_device = engine == "device" or (engine == "auto" and on_device)

    if use_device:
        samples = input.signal if input.noise is NULL \
            else input.signal + input.noise
        samples = jnp.real(jnp.asarray(samples))
        if samples.ndim == 2:
            samples = samples.sum(axis=0)
        metrics = dict(eyeana.eye_metrics_jit(
            samples, sps=sps, nslots=nslots, sps_resamp=sps_resamp))
        # scalars to host floats; traces stay as arrays (tiny: <=nslots*sps)
        for k, v in metrics.items():
            if isinstance(v, jax.Array) and v.ndim == 0:
                metrics[k] = v.item()
            elif isinstance(v, jax.Array):
                metrics[k] = np.asarray(v)
        for k in ("threshold", "y_left", "y_right"):
            if metrics.get(k) is not None and np.isnan(metrics[k]):
                metrics[k] = None
    else:
        samples = np.asarray(input.to_numpy()).real
        if samples.ndim == 2:
            samples = samples.sum(axis=0)
        metrics = eyeana.eye_metrics(samples, sps=sps, nslots=nslots,
                                     sps_resamp=sps_resamp)
    metrics["dt"] = input.dt
    metrics["execution_time"] = toc()
    return Eye(metrics)


# ---------------------------------------------------------------------------
# SAMPLER (reference devices.py:1871-1891)
# ---------------------------------------------------------------------------
def SAMPLER(input: ElectricalSignal, instant: int) -> ElectricalSignal:
    """Downsample to 1 sample/slot: ``input[instant::gv.sps]``
    (reference devices.py:1871-1891).  ``instant`` is the intra-slot
    sampling phase in samples — receivers use the eye's optimum
    ``i = (t_opt + 0.5) * sps`` or simply ``sps // 2``."""
    tic()
    output = ElectricalSignal(input)[instant::gv.sps]
    output.execution_time = toc()
    return output


# ---------------------------------------------------------------------------
# FBG (reference devices.py:1894-2322)
# ---------------------------------------------------------------------------
def _fbg_apodization(apodization):
    if apodization == "rcos":
        return lambda z: _rcos_spectrum(z, alpha=1, T=2)
    if apodization == "gaussian":
        return lambda z: np.exp(-4 * np.log(2) * (3 * z) ** 2)
    if apodization == "parabolic":
        return lambda z: 1 - (2 * z) ** 2
    if apodization == "uniform":
        return None
    if callable(apodization):
        return apodization
    if isinstance(apodization, str):
        warnings.warn(
            "Apodization function not recognized. Using uniform apodization.")
        return None
    raise ValueError("Apodization must be a string or a function.")


def _fbg_resolve_geometry(neff, v, landa_D, fc, kL, L, N, dneff, vdneff):
    """Parameter-combination resolver (reference devices.py:2099-2176)."""
    if fc:
        if dneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `fc` and `dneff` are specified, `L`, `kL` or `N` "
                    "must be specified.")
            landa_D = 1 / (1 + dneff / neff) * c / fc
            vdneff = dneff * v
            if kL:
                L = kL / (pi * dneff * v / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        elif vdneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `fc` and `vdneff` are specified, `L`, `kL` or `N` "
                    "must be specified.")
            landa_D = c / fc
            dneff = 0
            if kL:
                L = kL / (pi * vdneff / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        else:
            raise ValueError(
                "If `fc` is specified, `dneff` or `vdneff` must be specified.")
    elif landa_D:
        if dneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `landa_D` and `dneff` are specified, `L`, `kL` or "
                    "`N` must be specified.")
            vdneff = dneff * v
            if kL:
                L = kL / (pi * vdneff / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        elif vdneff:
            if not (L or kL or N):
                raise ValueError(
                    "If `landa_D` and `vdneff` are specified, `L`, `kL` or "
                    "`N` must be specified.")
            dneff = 0
            if kL:
                L = kL / (pi * vdneff / landa_D)
            elif N:
                L = N * landa_D / (2 * neff)
        elif kL:
            if not (L or N):
                raise ValueError(
                    "If `landa_D` and `kL` are specified, `L` or `N` must "
                    "be specified.")
            if N:
                L = N * landa_D / (2 * neff)
            vdneff = kL * landa_D / (pi * L)
            dneff = vdneff / v
        else:
            raise ValueError(
                "If `landa_D` is specified, `dneff`, 'vdneff' or `kL` must "
                "be specified.")
    else:
        raise ValueError("Either `fc` or `landa_D` must be specified.")
    return landa_D, L, dneff, vdneff


def _fbg_rk4(delta, s, k, F, apo_func, n_steps: int):
    """Integrate the coupled-mode ODEs R' = i(shat R + k S),
    S' = -i(shat S + k R) from z=+1/2 to z=-1/2 with fixed-step RK4,
    vectorized over all frequency bins (replaces reference's solve_ivp RK45,
    devices.py:2197-2255).  Runs as a jitted lax.scan.
    """
    delta = jnp.asarray(delta, dtype=jnp.complex64)
    s = jnp.asarray(s, dtype=jnp.complex64)
    k = jnp.asarray(k, dtype=jnp.complex64)
    dz = -1.0 / n_steps  # integrate backwards: +1/2 -> -1/2

    if apo_func is not None:
        zs_host = 0.5 + dz * np.arange(n_steps)
        # apodization profile sampled at the 4 RK4 stage positions
        p0 = np.asarray(apo_func(zs_host), dtype=np.float32)
        p1 = np.asarray(apo_func(zs_host + dz / 2), dtype=np.float32)
        p2 = np.asarray(apo_func(zs_host + dz), dtype=np.float32)
    else:
        p0 = p1 = p2 = np.ones(n_steps, dtype=np.float32)
    zs = np.asarray(0.5 + dz * np.arange(n_steps), dtype=np.float32)

    def deriv(R, S, z, p):
        shat = delta + s * p - F * z
        kk = k * p
        dR = 1j * (shat * R + kk * S)
        dS = -1j * (shat * S + kk * R)
        return dR, dS

    def step(carry, inputs):
        R, S = carry
        z, pa, pb, pc = inputs
        k1R, k1S = deriv(R, S, z, pa)
        k2R, k2S = deriv(R + dz / 2 * k1R, S + dz / 2 * k1S, z + dz / 2, pb)
        k3R, k3S = deriv(R + dz / 2 * k2R, S + dz / 2 * k2S, z + dz / 2, pb)
        k4R, k4S = deriv(R + dz * k3R, S + dz * k3S, z + dz, pc)
        R = R + dz / 6 * (k1R + 2 * k2R + 2 * k3R + k4R)
        S = S + dz / 6 * (k1S + 2 * k2S + 2 * k3S + k4S)
        return (R, S), None

    R0 = jnp.ones_like(delta)
    S0 = jnp.zeros_like(delta)
    (R, S), _ = jax.lax.scan(
        step, (R0, S0),
        (jnp.asarray(zs), jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2)))
    return np.asarray(R), np.asarray(S)


def FBG(input: OpticalSignal, neff: float = 1.45, v: float = 1.0,
        landa_D: Optional[float] = None, fc: Optional[float] = None,
        kL: Optional[float] = None, L: Optional[float] = None,
        N: Optional[int] = None, dneff: Optional[float] = None,
        vdneff: Optional[float] = None,
        apodization="uniform", F: float = 0,
        print_params: bool = True, filtfilt: bool = True,
        retH: bool = False):
    """Fiber Bragg grating reflectivity via coupled-mode theory.

    The z-integration is a fixed-step RK4 ``lax.scan`` vectorized over every
    frequency bin (all bins advance in lockstep on the VPU) instead of the
    reference's ``solve_ivp`` RK45 host loop (devices.py:2197-2255).  The
    step count is chosen from the maximum detuning so the fastest phase
    rotation is resolved.

    Parameters
    ----------
    input : OpticalSignal
        Field to reflect off the grating.
    neff, v : float
        Effective index and fringe visibility.
    landa_D / fc : float
        Design wavelength [m] or center frequency [Hz] (give one).
    kL / dneff / vdneff : float
        Coupling strength — give exactly one of the normalized coupling
        ``kL``, the index modulation ``dneff``, or ``v*dneff``
        (the reference's parameter-resolution tree,
        devices.py:2099-2176).
    L / N : float / int
        Grating length [m] or number of periods (give one).
    apodization : str or callable
        'uniform' | 'rcos' | 'gaussian' | 'parabolic', or a custom
        profile ``f(z)`` on z in [-1/2, 1/2].
    F : float
        Linear chirp parameter.
    filtfilt : bool
        Remove the group-delay slope (zero-phase response) like the
        reference's ``filtfilt`` pass (devices.py:2308-2311).
    retH : bool
        Also return the (fftshifted) reflection response H(w).

    Returns
    -------
    OpticalSignal (and H when ``retH``); prints the resolved design
    (period, N, L, BW, peak reflectivity, loss, D at center) when
    ``print_params``.
    """
    tic()
    if not isinstance(input, OpticalSignal):
        raise TypeError("`input` must be of type 'optical_signal'.")

    landa_D, L, dneff, vdneff = _fbg_resolve_geometry(
        neff, v, landa_D, fc, kL, L, N, dneff, vdneff)

    lam_D = landa_D
    Lam = lam_D / (2 * neff)                    # grating period
    lam_c = (1 + dneff / neff) * lam_D          # center wavelength
    fc = c / lam_c

    lam = 2 * pi * c / (input.w(shift=True) + 2 * pi * gv.f0)
    dlam = lam[1] - lam[0]

    N = int(L / Lam)
    kL = pi / lam_D * vdneff * L

    delta = 2 * pi * neff * (1 / lam - 1 / lam_D) * L
    s = 2 * pi * dneff / lam * L
    k = pi * vdneff / lam * L

    apo_func = _fbg_apodization(apodization)

    # resolve the fastest phase rotation: |shat| <= |delta|+|s|+|F|/2 per
    # unit z; RK4 needs several steps per radian.
    rate = float(np.max(np.abs(delta) + np.abs(s)) + abs(F) / 2 + np.max(np.abs(k)))
    n_steps = int(min(max(512, 4 * rate), 200_000))
    R, S = _fbg_rk4(delta, s, k, F, apo_func, n_steps)

    H = S / R
    y = np.abs(H)
    ic = int(np.argmin(np.abs(lam - c / fc)))

    peaks, _ = sg.find_peaks(y)
    H_max = y[ic]

    if (y > 0.5).all():
        warnings.warn(
            "Bandwidth of the grating is too large for current sampling "
            "rate (`fs`). Consider increasing `fs`.")
        bw_str = f' - Δf = >{si(gv.fs, "Hz")} (Δλ = >{si(gv.fs * c / fc**2, "m")})'
    elif len(peaks):
        r = sg.peak_widths(y, peaks)
        BW_lam = r[0].max() * dlam
        BW_f = fc**2 * BW_lam / c
        bw_str = f' - Δf = {si(BW_f, "Hz")} (Δλ = {si(BW_lam, "m")})'
    else:
        warnings.warn("No peaks found in the reflectivity of the grating.")
        bw_str = " - Δf = -- GHz (Δλ = -- nm)"

    D = _dispersion_of(H, gv.fs, fc)[ic]

    if print_params:
        print("\n*** Fiber Bragg Grating Features ***")
        print(f' - Λ = {si(Lam, "m")}')
        print(f" - N = {N}")
        print(f' - L = {si(L, "m")}')
        print(f' - λc = {si(c / fc, "m", 4)}')
        print(bw_str)
        print(f" - ρo = {y.max():.2f}")
        print(f" - loss = {-db(max(H_max, 1e-30)**2):.1f} dB")
        print(f" - vδneff = {vdneff:.1e}")
        print(f" - kL = {kL:.1f}")
        print(f" - D(λc) = {D:.1f} ps/nm")
        if F:
            print(f" - F = {F:.1f}")
            print(f' - ΔΛ = {si(np.abs(Lam * F / (2 * pi * N)), "m")}')
        print("************************************\n")

    if filtfilt:  # remove the bulk group delay so pulses stay centered
        H = H * np.exp(-1j * input.w(shift=True) * _tau_g(H, gv.fs)[ic] * 1e-12)

    H_fft = np.fft.ifftshift(H)
    sig = filters.apply_freq_response(input.signal, H_fft)
    noi = (filters.apply_freq_response(input.noise, H_fft)
           if _has_noise(input.noise) else NULL)
    output = OpticalSignal(sig, noi, n_pol=input.n_pol)

    output.execution_time = toc()
    if retH:
        return output, H
    return output


# ---------------------------------------------------------------------------
# fiber propagation animation (reference devices.py:2326-2563)
# ---------------------------------------------------------------------------
def animated_fiber_propagation(input: OpticalSignal, M: int, length: float,
                               alpha: float = 0.0, beta_2: float = 0.0,
                               beta_3: float = 0.0, gamma: float = 0.0,
                               phi_max: float = 0.01,
                               h: Optional[float] = None,
                               interval: int = 100,
                               show: bool = True):  # pragma: no cover
    """Matplotlib animation of |A(z, t)| along the fiber, built from the
    SSFM trajectory capture (``return_steps`` hook)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    z, A_z = FIBER(input, length=length, alpha=alpha, beta_2=beta_2,
                   beta_3=beta_3, gamma=gamma, phi_max=phi_max, h=h,
                   return_steps=True)
    mag = np.abs(A_z if A_z.ndim == 2 else A_z.sum(axis=1))
    t = gv.t * 1e9

    fig, ax = plt.subplots()
    (line,) = ax.plot(t, mag[0])
    ax.set_xlabel("t [ns]")
    ax.set_ylabel("|A(z,t)|")
    ax.set_ylim(0, float(mag.max()) * 1.1)

    def update(i):
        line.set_ydata(mag[i])
        ax.set_title(f"z = {z[i]:.2f} km")
        return (line,)

    anim = FuncAnimation(fig, update, frames=len(z), interval=interval,
                         blit=False)
    if show:
        plt.show()
    return anim


def animated_fiber_propagation_with_phase(
        input: OpticalSignal, length: float, alpha: float = 0.0,
        beta_2: float = 0.0, beta_3: float = 0.0, gamma: float = 0.0,
        phi_max: float = 0.05, h: Optional[float] = None,
        interval: int = 100, show: bool = True):  # pragma: no cover
    """Animation of |A(z,t)|, instantaneous phase and chirp along the fiber
    (reference devices.py:2461-2563).  The loss is compensated out of the
    displayed field (``A * exp(alpha*z/2)``) so amplitude changes shown are
    purely dispersive/nonlinear, and the phase is unwrapped and referenced
    to the pulse center, as in the reference."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    z, A_z = FIBER(input, length=length, alpha=alpha, beta_2=beta_2,
                   beta_3=beta_3, gamma=gamma, phi_max=phi_max, h=h,
                   return_steps=True)
    A_z = A_z if A_z.ndim == 2 else A_z.sum(axis=1)
    alpha_lin = alpha / 4.342944819032518
    A_z = A_z * np.exp(alpha_lin * z[:, None] / 2)  # undo loss for display

    ic = int(np.argmax(np.abs(A_z[0])))
    mag = np.abs(A_z)
    ph = np.unwrap(np.angle(A_z), axis=-1)
    ph = ph - ph[:, ic:ic + 1] + np.angle(A_z)[:, ic:ic + 1]
    # instantaneous frequency deviation (chirp) [rad/ps]
    om = -np.gradient(ph, gv.dt * 1e12, axis=-1)

    t = gv.t * gv.R
    t = t - t.max() / 2

    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, sharex=True, figsize=(8, 8))
    (l1,) = ax1.plot(t, mag[0])
    (l2,) = ax2.plot(t, ph[0])
    (l3,) = ax3.plot(t, om[0])
    ax1.set_ylabel("|A(z,t)|")
    ax2.set_ylabel("phase [rad]")
    ax3.set_ylabel("chirp [rad/ps]")
    ax3.set_xlabel("t/T")
    ax1.set_ylim(0, float(mag.max()) * 1.1)
    ax2.set_ylim(float(ph.min()), float(ph.max()))
    ax3.set_ylim(float(np.percentile(om, 1)), float(np.percentile(om, 99)))

    def update(i):
        l1.set_ydata(mag[i])
        l2.set_ydata(ph[i])
        l3.set_ydata(om[i])
        ax1.set_title(f"z = {z[i]:.2f} km")
        return l1, l2, l3

    anim = FuncAnimation(fig, update, frames=len(z), interval=interval,
                         blit=False)
    if show:
        plt.show()
    return anim
