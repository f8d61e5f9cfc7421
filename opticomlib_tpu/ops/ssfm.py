"""Split-step Fourier NLSE propagation engine (the framework's hot kernel).

JAX re-design of the reference's ``FIBER`` solver
(reference: opticomlib/devices.py:1038-1206): symmetric NL-L-NL scheme with
the nonlinear operator frozen at the step start, adaptive step size limited
by the maximum nonlinear phase rotation (Sinkin et al. 2003, as in the
reference, devices.py:1156/1193-1196).

Differences from the reference (CuPy/NumPy host loop):

* the whole propagation loop lives **inside** ``jax.jit`` as a
  ``lax.while_loop`` (adaptive) or ``lax.scan`` (fixed step schedule) —
  zero host<->device synchronization per step, vs one device round-trip per
  step in the reference's Python ``while`` loop;
* ``complex64`` math throughout, matching the reference's dtype choice
  (devices.py:1137-1147);
* the per-step global ``max|A|^2`` reduction is a plain ``jnp.max`` — on a
  sharded array XLA lowers it to an all-reduce(max) over the mesh, which is
  exactly the collective the adaptive scheme requires.

**Planar jit boundaries.** Every jitted entry point takes and returns
*planar* float32 (re, im) pairs and forms ``complex64`` internally with
``jax.lax.complex``.  This is a design choice, not a requirement of the
device: ``complex64`` arrays cross ``jit`` and host<->device boundaries
intact on the GPU and the CPU (``chip_smoke.py`` checks it).

Step count scales as ``gamma * maxP * L / phi_max``; each step costs two
complex FFTs of the full window plus a handful of fused pointwise ops.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["linear_operator", "dispersion_phase", "ssfm_propagate",
           "adaptive_h0",
           "ssfm_step_schedule", "dispersive_step", "ssfm_scan_o4",
           "ssfm_local_error", "progress_bar", "ssfm_while_inside",
           "ssfm_scan_inside", "ssfm_o4_scan_inside", "ssfm_o4_auto",
           "ssfm_o4_auto_inside", "ssfm_local_error_inside"]

_LOG10E_X10 = 4.342944819032518  # 10*log10(e): dB/km -> 1/km divisor


# ----------------------------------------------------------------------
# progress reporting (reference devices.py:1164-1170 tqdm bar).  The jitted
# loops emit an async ``jax.debug.callback`` per step when compiled with
# ``progress=True``; the callback dispatches to a module-level handler so the
# compiled program stays cacheable across calls.  Zero cost when disabled
# (static flag -> callback not traced in).
# ----------------------------------------------------------------------
_progress_handler = None


def _progress_tick(z, length):  # pragma: no cover - host-side I/O
    if _progress_handler is not None:
        _progress_handler(float(z), float(length))


class progress_bar:
    """Context manager installing a tqdm progress handler for SSFM loops
    compiled with ``progress=True`` (used by ``FIBER(show_progress=True)``)."""

    def __enter__(self):  # pragma: no cover - host-side I/O
        global _progress_handler
        from tqdm import tqdm
        self._bar = tqdm(total=100.0, unit="%",
                         bar_format="{l_bar}{bar}| {n:.1f}/{total}% "
                                    "[{elapsed}, {postfix}]")
        self._bar.set_postfix(step=0)
        self._n = 0

        def update(z, length):
            self._n += 1
            pct = min(100.0, 100.0 * z / max(length, 1e-30))
            self._bar.n = round(pct, 1)
            self._bar.set_postfix(step=self._n)
            self._bar.refresh()

        _progress_handler = update
        return self

    def __exit__(self, *exc):  # pragma: no cover - host-side I/O
        global _progress_handler
        _progress_handler = None
        self._bar.n = self._bar.total
        self._bar.refresh()
        self._bar.close()
        return False


def linear_operator(w_rad_s: np.ndarray, alpha_db_km: float, beta2: float,
                    beta3: float) -> np.ndarray:
    """Frequency-domain linear operator D(w) [1/km], natural FFT order.

    ``D = -alpha/2 + i*beta2/2*w^2 + i*beta3/6*w^3`` with w in rad/ps,
    alpha in 1/km (from dB/km), beta2 [ps^2/km], beta3 [ps^3/km]
    (reference devices.py:1137-1145).
    """
    w = np.asarray(w_rad_s, dtype=np.float64) * 1e-12  # rad/ps
    alpha = alpha_db_km / _LOG10E_X10
    D = -alpha / 2 + 1j * beta2 / 2 * w**2 + 1j * beta3 / 6 * w**3
    return D.astype(np.complex64)


def dispersion_phase(w_rad_s: np.ndarray, beta2: float,
                     beta3: float) -> np.ndarray:
    """Real dispersion phase rate ``phi(w) = beta2/2*w^2 + beta3/6*w^3``
    [rad/km], w in rad/ps, natural FFT order.

    This is ``imag(linear_operator(...))``; the engine keeps dispersion as a
    real phase and the loss as a *scalar* so the per-step linear factor is
    ``exp(-alpha/2*h) * (cos(phi*h) + i sin(phi*h))`` — one scalar exp plus
    cos/sin, instead of an elementwise complex exp (which XLA lowers to a
    full vector exp *and* cos/sin).
    """
    w = np.asarray(w_rad_s, dtype=np.float64) * 1e-12  # rad/ps
    phi = beta2 / 2 * w**2 + beta3 / 6 * w**3
    return phi.astype(np.float32)


def alpha_per_km(alpha_db_km: float) -> float:
    """Attenuation coefficient 1/km from dB/km (reference devices.py:1137)."""
    return float(alpha_db_km) / _LOG10E_X10


def _lin_factor(phi_w, alpha, h):
    """Linear-step multiplier exp(-alpha/2*h) * exp(i*phi_w*h)."""
    th = phi_w * h
    loss = jnp.exp(jnp.float32(-0.5) * alpha * h)
    return jax.lax.complex(jnp.cos(th), jnp.sin(th)) * loss


def _nl_l_nl_step(A, phi_w, alpha, h, gamma, E=None):
    """One symmetric NL-L-NL split step (nonlinear operator frozen at step
    start, as in reference devices.py:1172-1196).  Pass a precomputed
    linear factor ``E`` to skip the cos/sin when ``h`` is loop-constant."""
    phi = (gamma * (h / 2)) * (A.real * A.real + A.imag * A.imag)
    half_nl = jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
    A = A * half_nl
    if E is None:
        E = _lin_factor(phi_w, alpha, h)
    A = jnp.fft.ifft(jnp.fft.fft(A, axis=-1) * E, axis=-1)
    return A * half_nl


def ssfm_while_inside(A, phi_w, length, gamma, phi_max, h0, alpha,
                      adaptive: bool, progress: bool = False,
                      reduce_max=None, linear_step=None, h_max=None):
    """Adaptive/fixed while_loop SSFM body — complex in/out, for use
    *inside* an enclosing jit (the fused link program, shard_map bodies).

    ``reduce_max``: optional collective applied to the local ``max|A|^2``
    (e.g. ``lambda m: jax.lax.pmax(m, 'time')`` inside shard_map) — the
    all-reduce(max) the adaptive criterion needs on a sharded waveform.

    ``linear_step``: optional ``(A, h) -> A`` override for the linear
    substep — the sharded solvers plug in the pencil-FFT or overlap-save
    halo transform here (``phi_w`` may then be None).  The default is the
    single-FFT step ``ifft(fft(A) * exp((iφ(ω)-α/2)h))``.

    ``h_max``: optional hard cap on the adaptive step (the overlap-save
    solver caps h at the size its halo width was derived for).

    Returns ``(A, n_steps)``.
    """
    alpha = jnp.float32(alpha)
    length = jnp.float32(length)
    gamma = jnp.float32(gamma)
    phi_max = jnp.float32(phi_max)
    h0 = jnp.float32(h0)

    # Minimum step: float32 z-accumulation stalls when h < ulp(z), so clamp
    # steps to >~ length*2^-23; the bounded overshoot (<1e-7 of the span) is
    # physically negligible and the loop is guaranteed to terminate.
    h_floor = length * jnp.float32(1.5e-7)
    max_steps = jnp.int32(400_000)  # runaway backstop: far above any real
    # config (~1e4 steps at extreme power), but small enough that a bug
    # that stalls z-advance ends the program in minutes, not hours

    def cond(carry):
        _, z, _, steps = carry
        return jnp.logical_and(z < length, steps < max_steps)

    def body(carry):
        A, z, h, steps = carry
        z = z + h
        if linear_step is None:
            A = _nl_l_nl_step(A, phi_w, alpha, h, gamma)
        else:
            # same frozen-operator symmetric step, custom linear transform
            phi = (gamma * (h / 2)) * (A.real * A.real + A.imag * A.imag)
            half_nl = jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
            A = linear_step(A * half_nl, h) * half_nl
        if adaptive:
            maxP = jnp.max(A.real * A.real + A.imag * A.imag)
            if reduce_max is not None:
                maxP = reduce_max(maxP)
            h_next = phi_max / (jnp.abs(gamma) * maxP)
        else:
            h_next = h0
        if h_max is not None:
            h_next = jnp.minimum(h_next, jnp.float32(h_max))
        h_next = jnp.minimum(h_next, length - z)
        h_next = jnp.maximum(h_next, h_floor)
        if progress:
            jax.debug.callback(_progress_tick, z, length)
        return (A, z, h_next.astype(jnp.float32), steps + 1)

    h_init = jnp.minimum(h0, length)
    if h_max is not None:
        h_init = jnp.minimum(h_init, jnp.float32(h_max))
    A, z, h, steps = jax.lax.while_loop(
        cond, body, (A, jnp.float32(0.0), h_init, jnp.int32(0)))
    return A, steps


@partial(jax.jit, static_argnames=("adaptive", "progress"))
def _ssfm_loop(Are, Aim, phi_w, length, gamma, phi_max, h0, alpha,
               adaptive: bool, progress: bool = False):
    """while_loop SSFM on planar inputs: returns (re, im, n_steps)."""
    A, steps = ssfm_while_inside(jax.lax.complex(Are, Aim), phi_w, length,
                                 gamma, phi_max, h0, alpha,
                                 adaptive=adaptive, progress=progress)
    return A.real, A.imag, steps


def ssfm_scan_inside(A, phi_w, hs, gamma, alpha, progress: bool = False):
    """Fixed-schedule SSFM scan body — complex in/out, for use *inside* an
    enclosing jit.  The linear factor for the schedule's leading step size
    is precomputed once outside the scan; only off-schedule steps (the
    final remainder, at most one) pay the cos/sin recompute — a
    ``lax.cond`` selects per step."""
    alpha = jnp.float32(alpha)
    gamma = jnp.float32(gamma)
    h0 = hs[0]
    E0 = _lin_factor(phi_w, alpha, h0)
    length = jnp.sum(hs)

    def step(carry, h):
        A, z = carry
        E = jax.lax.cond(h == h0, lambda: E0,
                         lambda: _lin_factor(phi_w, alpha, h))
        A = _nl_l_nl_step(A, phi_w, alpha, h, gamma, E=E)
        z = z + h
        if progress:
            jax.debug.callback(_progress_tick, z, length)
        return (A, z), None

    (A, _), _ = jax.lax.scan(step, (A, jnp.float32(0.0)), hs)
    return A


@partial(jax.jit, static_argnames=("progress",))
def _ssfm_scan(Are, Aim, phi_w, hs, gamma, alpha, progress: bool = False):
    """Fixed-schedule SSFM via lax.scan on planar inputs."""
    A = ssfm_scan_inside(jax.lax.complex(Are, Aim), phi_w, hs, gamma, alpha,
                         progress=progress)
    return A.real, A.imag


def adaptive_h0(phi_max: float, gamma: float, maxP: float,
                length: float) -> float:
    """Initial adaptive step ``phi_max / (|gamma|·maxP)`` capped at the span
    length.  A dark input (``maxP == 0``) gives the full span in one step —
    the reference reaches the same result via NumPy's inf-on-divide-by-zero
    followed by ``min(·, length)`` (devices.py:1156-1160)."""
    denom = abs(gamma) * maxP
    if denom == 0:
        return float(length)
    return min(phi_max / denom, float(length))


def ssfm_step_schedule(length: float, h: float) -> np.ndarray:
    """Fixed step schedule: ``h``-sized steps plus a final remainder,
    replicating the reference's ``min(h, length - z)`` clipping in fixed-step
    mode (devices.py:1196)."""
    n_full = int(math.floor(length / h + 1e-9))
    rem = length - n_full * h
    hs = [h] * n_full
    if rem > 1e-9 * max(length, 1.0):
        hs.append(rem)
    if not hs:
        hs = [length]
    return np.asarray(hs, dtype=np.float32)


# ----------------------------------------------------------------------
# higher-order schemes (beyond reference parity: fewer FFTs per unit
# accuracy than the reference's 2nd-order phi_max-adaptive stepping)
# ----------------------------------------------------------------------

def _strang_step(A, phi_w, alpha, h, gamma, E=None, spectral=None):
    """True Strang split step: the second nonlinear half uses the field
    *after* the linear substep (genuinely 2nd-order).  The reference's step
    (:func:`_nl_l_nl_step`) reuses the rotation factors frozen at the step
    start (devices.py:1172-1196) — cheaper per step, but its splitting
    error degrades toward 1st order when the per-step dispersion is strong,
    which would defeat the higher-order compositions below.

    ``spectral``: optional ``(A, E) -> A`` override for the spectral
    multiply (the sharded solvers plug in the pencil-FFT transform)."""
    phi = (gamma * (h / 2)) * (A.real * A.real + A.imag * A.imag)
    A = A * jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
    if E is None:
        E = _lin_factor(phi_w, alpha, h)
    if spectral is None:
        A = jnp.fft.ifft(jnp.fft.fft(A, axis=-1) * E, axis=-1)
    else:
        A = spectral(A, E)
    phi = (gamma * (h / 2)) * (A.real * A.real + A.imag * A.imag)
    return A * jax.lax.complex(jnp.cos(phi), jnp.sin(phi))


# Yoshida (1990) triple-jump composition: S4(h) = S2(w1 h) S2(w0 h) S2(w1 h)
# with w1 = 1/(2 - 2^(1/3)), w0 = 1 - 2 w1 (negative midstep).  Local error
# O(h^5) vs O(h^3) for the plain symmetric step.
_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_W0 = 1.0 - 2.0 * _W1


def ssfm_o4_scan_inside(A, phi_w, hs, gamma, alpha, spectral=None):
    """Fixed-schedule 4th-order (Yoshida) SSFM scan body — complex
    in/out, for use *inside* an enclosing jit (the fused link programs).
    ``spectral``: optional ``(A, E) -> A`` override for the spectral
    multiply (the sharded link plugs in the pencil-FFT transform);
    default is the local single-FFT ``ifft(fft(A) * E)``."""
    alpha = jnp.float32(alpha)
    gamma = jnp.float32(gamma)
    hs = jnp.asarray(hs)
    h0 = hs[0]
    E1_0 = _lin_factor(phi_w, alpha, h0 * jnp.float32(_W1))
    E0_0 = _lin_factor(phi_w, alpha, h0 * jnp.float32(_W0))

    if spectral is None:
        def spectral(A, E):
            return jnp.fft.ifft(jnp.fft.fft(A, axis=-1) * E, axis=-1)

    def strang(A, h, E):
        phi = (gamma * (h / 2)) * (A.real * A.real + A.imag * A.imag)
        A = A * jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
        A = spectral(A, E)
        phi = (gamma * (h / 2)) * (A.real * A.real + A.imag * A.imag)
        return A * jax.lax.complex(jnp.cos(phi), jnp.sin(phi))

    def step(A, h):
        E1 = jax.lax.cond(h == h0, lambda: E1_0, lambda: _lin_factor(
            phi_w, alpha, h * jnp.float32(_W1)))
        E0 = jax.lax.cond(h == h0, lambda: E0_0, lambda: _lin_factor(
            phi_w, alpha, h * jnp.float32(_W0)))
        A = strang(A, h * jnp.float32(_W1), E1)
        A = strang(A, h * jnp.float32(_W0), E0)
        A = strang(A, h * jnp.float32(_W1), E1)
        return A, None

    A, _ = jax.lax.scan(step, A, hs)
    return A


def _o4_step(A, phi_w, alpha, h, gamma, spectral=None):
    """One 4th-order Yoshida step S4(h) = S2(w1 h) S2(w0 h) S2(w1 h)."""
    A = _strang_step(A, phi_w, alpha, h * jnp.float32(_W1), gamma,
                     spectral=spectral)
    A = _strang_step(A, phi_w, alpha, h * jnp.float32(_W0), gamma,
                     spectral=spectral)
    return _strang_step(A, phi_w, alpha, h * jnp.float32(_W1), gamma,
                        spectral=spectral)


def ssfm_o4_auto_inside(A, phi_w, length, gamma, tol, h0, alpha,
                        reduce_sum=None, spectral=None):
    """Self-tuning 4th-order SSFM body — complex in/out, for use *inside*
    an enclosing jit (the fused link's ``FiberSpec(method='o4', h=None)``
    stages).

    Composes the Yoshida S4 stepper with the Sinkin-style local-error
    step controller (step doubling): each attempted step advances with
    one coarse S4(h) and two fine S4(h/2) steps, estimates the relative
    local error ``delta = ||u_f - u_c|| / ||u_f||``, Richardson-combines
    to 5th order ``(16 u_f - u_c)/15``, and controls the step with the
    4th-order exponent (factor ``2^(1/5)``):

      delta > 2 tol        -> discard, halve h
      tol < delta <= 2 tol -> accept, h /= 2^(1/5)
      delta < tol/2        -> accept, h *= 2^(1/5)

    This removes the manual per-config ``h`` calibration the fixed-step
    o4 scheme needed (round-4 verdict): ``tol`` is a physical target
    (relative local error per step), and h settles near the largest step
    meeting it.  Nine FFT pairs per attempted step — worth it only when
    the target accuracy is tight enough that the reference scheme would
    need many more 1-FFT-pair steps (see docs/performance.md).

    ``reduce_sum``: optional collective applied to the local squared-norm
    partial sums (e.g. ``lax.psum`` inside shard_map), making the error
    control global on a sharded waveform.  Returns
    ``(A, n_attempted_steps)``.
    """
    alpha = jnp.float32(alpha)
    gamma = jnp.float32(gamma)

    def attempt(A, h):
        u_c = _o4_step(A, phi_w, alpha, h, gamma, spectral=spectral)
        u_f = _o4_step(_o4_step(A, phi_w, alpha, h / 2, gamma,
                                spectral=spectral),
                       phi_w, alpha, h / 2, gamma, spectral=spectral)
        return u_c, u_f

    return _step_doubling_controller(
        A, length, h0, tol, attempt, rich_num=16.0, rich_den=15.0,
        grow=2.0 ** (1.0 / 5.0), reduce_sum=reduce_sum)


def _step_doubling_controller(A, length, h0, tol, attempt, rich_num,
                              rich_den, grow, reduce_sum=None):
    """Shared step-doubling local-error controller for the self-tuning
    schemes (o4-auto and local_error differ only in their stepper, the
    Richardson coefficients and the growth exponent).

    ``attempt(A, h) -> (u_c, u_f)``: one coarse step and two fine
    half-steps; relative local error ``delta = ||u_f - u_c||/||u_f||``;
    the accepted solution is ``(rich_num*u_f - u_c)/rich_den``:

      delta > 2 tol        -> discard, halve h
      tol < delta <= 2 tol -> accept, h /= grow
      delta < tol/2        -> accept, h *= grow

    **Saturation guard** (round-5 + review fix): when ``tol`` sits
    below the float32 noise floor of the step-doubling estimate, delta
    stops responding to h entirely — an unguarded controller halves h
    to h_floor and hits the max_steps backstop mid-span, silently
    returning a partial propagation.  The guard counts only
    *non-improving* consecutive rejections (a genuinely-too-coarse
    first step keeps improving ~2^order per halving and must NOT trip
    it — with the default h0 = length/10 on a long dispersive span the
    first cascade is long but productive): after ``max_rejects``
    plateau halvings the estimate is declared saturated, h is restored
    to where the plateau began, and rejection is disabled for the rest
    of the span (fixed-step at the finest step the estimate resolves —
    the achievable-accuracy result).
    """
    length = jnp.float32(length)
    tol = jnp.float32(tol)
    grow = jnp.float32(grow)
    rich_num = jnp.float32(rich_num)
    rich_den = jnp.float32(rich_den)

    h_floor = length * jnp.float32(1.5e-7)
    max_steps = jnp.int32(400_000)
    max_rejects = 8
    restore = jnp.float32(2.0 ** max_rejects)
    max_rejects = jnp.int32(max_rejects)
    # a halving of a converging order-p scheme cuts delta ~2^p (p>=3);
    # anything failing to improve by 30% is plateau noise
    improve_factor = jnp.float32(0.7)

    def cond(carry):
        _, z, _, steps, _, _, _ = carry
        return jnp.logical_and(z < length, steps < max_steps)

    def body(carry):
        A, z, h, steps, rejects, saturated, delta_prev = carry
        h = jnp.minimum(h, length - z)
        u_c, u_f = attempt(A, h)
        diff = u_f - u_c
        err2 = jnp.sum(diff.real**2 + diff.imag**2)
        ref2 = jnp.sum(u_f.real**2 + u_f.imag**2)
        if reduce_sum is not None:
            err2 = reduce_sum(err2)
            ref2 = reduce_sum(ref2)
        delta = jnp.sqrt(err2) / jnp.maximum(jnp.sqrt(ref2),
                                             jnp.float32(1e-30))

        trip = jnp.logical_and(rejects >= max_rejects,
                               jnp.logical_not(saturated))
        accept = (delta <= 2 * tol) | (h <= h_floor) | saturated | trip
        A_new = (rich_num * u_f - u_c) / rich_den
        A = jnp.where(accept, A_new, A)
        z = jnp.where(accept, z + h, z)
        improving = delta < delta_prev * improve_factor
        rejects = jnp.where(accept, jnp.int32(0),
                            jnp.where(improving, jnp.int32(1),
                                      rejects + 1))
        delta_prev = jnp.where(accept, jnp.float32(jnp.inf), delta)
        saturated = saturated | trip

        h_next = jnp.where(
            accept,
            jnp.where(trip, h * restore,          # undo plateau halvings
                      jnp.where(saturated, h,     # fixed-step mode
                                jnp.where(delta > tol, h / grow,
                                          jnp.where(delta < tol / 2,
                                                    h * grow, h)))),
            h / 2)
        h_next = jnp.clip(h_next, h_floor, length)
        return (A, z, h_next.astype(jnp.float32), steps + 1, rejects,
                saturated, delta_prev)

    A, z, h, steps, _, _, _ = jax.lax.while_loop(
        cond, body, (A, jnp.float32(0.0), jnp.float32(h0), jnp.int32(0),
                     jnp.int32(0), jnp.bool_(False), jnp.float32(jnp.inf)))
    return A, steps


@jax.jit
def _ssfm_o4_auto_loop(Are, Aim, phi_w, length, gamma, tol, h0, alpha):
    A, steps = ssfm_o4_auto_inside(jax.lax.complex(Are, Aim), phi_w,
                                   length, gamma, tol, h0, alpha)
    return A.real, A.imag, steps


def ssfm_o4_auto(A, w_rad_s, length, alpha=0.0, beta_2=0.0, beta_3=0.0,
                 gamma=0.0, tol=1e-5, h0=None):
    """Self-tuning **4th-order** split-step propagation: Yoshida S4 steps
    under step-doubling local-error control (see
    :func:`ssfm_o4_auto_inside`).  This is what ``FIBER(method='o4')``
    runs when no fixed ``h`` is given — no calibration script needed.
    ``tol`` is the target relative local error per step (keep
    >= ~1e-6: below that the float32 error estimate saturates).
    """
    A_host = np.asarray(A, dtype=np.complex64)
    Are, Aim = _split(A_host)
    phi_w = dispersion_phase(w_rad_s, beta_2, beta_3)
    if h0 is None:
        h0 = length / 10.0
    re, im, _ = _ssfm_o4_auto_loop(
        Are, Aim, phi_w, jnp.float32(length), jnp.float32(gamma),
        jnp.float32(tol), jnp.float32(min(h0, length)),
        jnp.float32(alpha_per_km(alpha)))
    return np.asarray(re) + 1j * np.asarray(im)


@jax.jit
def _ssfm_scan_o4(Are, Aim, phi_w, hs, gamma, alpha):
    A = ssfm_o4_scan_inside(jax.lax.complex(Are, Aim), phi_w, hs,
                            gamma, alpha)
    return A.real, A.imag


def ssfm_scan_o4(A, w_rad_s, length, alpha=0.0, beta_2=0.0, beta_3=0.0,
                 gamma=0.0, h=1.0):
    """Fixed-step **4th-order** split-step propagation (Yoshida triple-jump
    composition of symmetric steps).

    Three FFT pairs per step but local error O(h^5): at equal accuracy the
    step count drops by ~(h4/h2) ≈ accuracy^(-1/6) vs the 2nd-order scheme,
    a net FFT saving whenever the tolerance is tight.  No reference
    equivalent (the reference offers only the 2nd-order scheme,
    devices.py:1172-1196).
    """
    A_host = np.asarray(A, dtype=np.complex64)
    Are, Aim = _split(A_host)
    phi_w = dispersion_phase(w_rad_s, beta_2, beta_3)
    hs = jnp.asarray(ssfm_step_schedule(length, h))
    re, im = _ssfm_scan_o4(Are, Aim, phi_w, hs, gamma, alpha_per_km(alpha))
    return np.asarray(re) + 1j * np.asarray(im)


def ssfm_local_error_inside(A, phi_w, length, gamma, tol, h0, alpha,
                            reduce_sum=None, spectral=None):
    """Sinkin et al. (2003) local-error method body — complex in/out, for
    use *inside* an enclosing jit (``FiberSpec(method='local_error')``
    stages of the fused link): advance with one coarse step S2(h) and two
    fine steps S2(h/2)^2, combine by local Richardson extrapolation
    ``(4 u_f - u_c)/3`` (3rd-order solution), and control the step from
    the relative local error delta = ||u_f - u_c|| / ||u_f||:

      delta > 2 tol        -> discard, halve h
      tol < delta <= 2 tol -> accept, h /= 2^(1/3)
      delta < tol/2        -> accept, h *= 2^(1/3)

    Three FFT pairs per attempted step; h settles near the largest value
    meeting the target accuracy — typically far fewer total FFTs than the
    phi_max criterion at equal output error.

    ``reduce_sum``: optional collective applied to the local squared-norm
    partial sums (e.g. ``lambda s: jax.lax.psum(s, 'time')`` inside
    shard_map) so the error control sees the GLOBAL norm on a sharded
    waveform.  Returns ``(A, n_attempted_steps)``.

    Shares the step controller (including the saturation guard) with
    :func:`ssfm_o4_auto_inside` — see
    :func:`_step_doubling_controller`.
    """
    alpha = jnp.float32(alpha)
    gamma = jnp.float32(gamma)

    def attempt(A, h):
        u_c = _strang_step(A, phi_w, alpha, h, gamma, spectral=spectral)
        u_f = _strang_step(_strang_step(A, phi_w, alpha, h / 2, gamma,
                                        spectral=spectral),
                           phi_w, alpha, h / 2, gamma, spectral=spectral)
        return u_c, u_f

    return _step_doubling_controller(
        A, length, h0, tol, attempt, rich_num=4.0, rich_den=3.0,
        grow=2.0 ** (1.0 / 3.0), reduce_sum=reduce_sum)


@jax.jit
def _ssfm_local_error_loop(Are, Aim, phi_w, length, gamma, tol, h0, alpha):
    A, steps = ssfm_local_error_inside(jax.lax.complex(Are, Aim), phi_w,
                                       length, gamma, tol, h0, alpha)
    return A.real, A.imag, steps


def ssfm_local_error(A, w_rad_s, length, alpha=0.0, beta_2=0.0, beta_3=0.0,
                     gamma=0.0, tol=1e-5, h0=None):
    """Adaptive split-step propagation with **local-error step control**
    (Sinkin et al., JLT 2003) and per-step Richardson extrapolation to 3rd
    order.  ``tol`` is the target relative local error per step.

    Keep ``tol >= ~1e-5``: the per-step error estimate bottoms out at the
    float32 noise floor, so tighter tolerances only shrink the step (and
    multiply the FFT count) without improving the result.

    Returns (A_out, n_attempted_steps)."""
    A_host = np.asarray(A, dtype=np.complex64)
    Are, Aim = _split(A_host)
    phi_w = dispersion_phase(w_rad_s, beta_2, beta_3)
    if h0 is None:
        h0 = length / 10.0
    re, im, steps = _ssfm_local_error_loop(
        Are, Aim, phi_w, length, gamma, tol, min(h0, length),
        alpha_per_km(alpha))
    return np.asarray(re) + 1j * np.asarray(im), int(steps)


def dispersive_step(A, D, h):
    """Pure linear step: ``ifft(fft(A) * exp(D*h))`` (used by DM and the
    gamma==0 shortcut, reference devices.py:1027-1029 and 1156).  Complex
    in/out — call only inside jit or on CPU."""
    return jnp.fft.ifft(jnp.fft.fft(A, axis=-1) * jnp.exp(D * h), axis=-1)


def _split(A) -> Tuple[np.ndarray, np.ndarray]:
    A = np.asarray(A, dtype=np.complex64)
    return (np.ascontiguousarray(A.real, dtype=np.float32),
            np.ascontiguousarray(A.imag, dtype=np.float32))


def ssfm_propagate(
    A,
    w_rad_s: np.ndarray,
    length: float,
    alpha: float = 0.0,
    beta_2: float = 0.0,
    beta_3: float = 0.0,
    gamma: float = 0.0,
    phi_max: float = 0.01,
    h: Optional[float] = None,
    return_steps: bool = False,
    planar_in: Optional[Tuple] = None,
    progress: bool = False,
):
    """Propagate field ``A`` (complex, last axis = time) through ``length``
    km of fiber.  Drop-in behavioral equivalent of reference
    devices.py:1038-1206.

    ``A`` is a *host* complex array (or pass ``planar_in=(re, im)`` device
    float32 arrays and ``A=None`` to keep everything on-device).  Returns a
    host complex64 ndarray, or the planar jax array pair when ``planar_in``
    was used, or ``(z, A_z)`` trajectory arrays when ``return_steps=True``.
    """
    if planar_in is not None:
        Are, Aim = planar_in
        A_host = None
    else:
        A_host = np.asarray(A, dtype=np.complex64)
        Are, Aim = _split(A_host)
    phi_w = dispersion_phase(w_rad_s, beta_2, beta_3)
    a_km = alpha_per_km(alpha)

    # NOTE reference parity quirk (devices.py:1154-1160): a dispersion-free
    # span takes ONE full-span step even when gamma != 0 and alpha != 0 —
    # the upstream initial-step rule freezes the NL operator at the input
    # power, overstating the SPM phase on a lossy span (vs the gamma*P0*Leff
    # integral).  Pass an explicit ``h`` (or method="o4"/"local_error") for
    # an accurate dispersion-free nonlinear propagation.
    linear_only = (beta_2 == 0 and beta_3 == 0) or gamma == 0

    def _out(re, im):
        if planar_in is not None:
            return re, im
        return np.asarray(re) + 1j * np.asarray(im)

    if return_steps:
        if A_host is None:
            raise ValueError("return_steps requires a host input array")
        return _ssfm_trajectory(A_host, phi_w, a_km, length, gamma, phi_max,
                                h, linear_only)

    if h is not None:
        hs = jnp.asarray(ssfm_step_schedule(length, h))
        re, im = _ssfm_scan(Are, Aim, phi_w, hs, gamma, a_km,
                            progress=progress)
        return _out(re, im)

    if linear_only:
        # single step over the whole span (reference h0 = length)
        hs = jnp.asarray([length], dtype=jnp.float32)
        re, im = _ssfm_scan(Are, Aim, phi_w, hs, gamma, a_km,
                            progress=progress)
        return _out(re, im)

    # adaptive: initial step from the input peak power (host probe when the
    # input came from host; jitted probe for device-resident planar input)
    if A_host is not None:
        maxP0 = float(np.max(A_host.real**2 + A_host.imag**2))
    else:
        maxP0 = float(_planar_max_power(Are, Aim))
    h0 = adaptive_h0(phi_max, gamma, maxP0, length)
    re, im, _ = _ssfm_loop(Are, Aim, phi_w, length, gamma, phi_max, h0,
                           a_km, adaptive=True, progress=progress)
    return _out(re, im)


@jax.jit
def _planar_max_power(re, im):
    return jnp.max(re * re + im * im)


def _ssfm_trajectory(A_np, phi_w, a_km, length, gamma, phi_max, h,
                     linear_only):
    """Host-stepped variant capturing (z, A(z)) — a state-capture /
    checkpoint hook (reference devices.py:1149-1202 ``return_steps``).
    Planar at every program boundary."""

    @jax.jit
    def step_jit(re, im, pw, h_, g):
        A = _nl_l_nl_step(jax.lax.complex(re, im), pw, jnp.float32(a_km),
                          h_, g)
        return A.real, A.imag

    def _max_power(A_np):
        return float(np.max(A_np.real**2 + A_np.imag**2))

    re, im = _split(A_np)
    z_list = [0.0]
    A_list = [A_np]
    z = 0.0
    if linear_only and h is None:
        h_ = float(length)
    elif h is None:
        h_ = adaptive_h0(phi_max, gamma, _max_power(A_np), length)
    else:
        h_ = min(float(h), length)

    while z < length:
        z += h_
        re, im = step_jit(re, im, jnp.asarray(phi_w), jnp.float32(h_),
                          jnp.float32(gamma))
        A_np = np.asarray(re) + 1j * np.asarray(im)
        z_list.append(z)
        A_list.append(A_np)
        if h is None and not linear_only:
            h_ = adaptive_h0(phi_max, gamma, _max_power(A_np),
                             float('inf'))
        h_ = min(h_, length - z)
        if h_ <= 0:
            break
    return np.asarray(z_list), np.asarray(A_list)
