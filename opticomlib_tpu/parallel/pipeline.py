"""Span-pipeline parallelism: each device owns one fiber span (+EDFA).

The pipeline-parallel analogue for optical links (SURVEY §2.6: the per-span
FIBER+EDFA chain of reference examples/ook_transmission_fiber_simulation.py
is the PP axis).  Device ``d`` holds span ``d`` of an ``S``-span link; a
batch of ``B`` waveforms (WDM channels, Monte-Carlo shots, parameter
sweeps) streams through as microbatches:

  tick t:  device d propagates microbatch ``m = t - d`` through its span,
           then ``ppermute``s the field to device ``d+1``.

After ``B + S - 1`` ticks every microbatch has traversed every span;
steady-state utilization is ``B / (B + S - 1)``.

**Memory is O(B/S · n) per device** (round 2; the round-1 version
replicated the full (B, n) batch on every device).  The batch is sharded
over the 'span' axis — device ``d`` owns microbatches ``[d·C, (d+1)·C)``
with ``C = B/S`` — and two distributed ring buffers stream it:

* the **feed ring** rotates one microbatch toward device 0 per tick, so
  stage 0's fresh input (microbatch ``t`` at tick ``t``) is always at its
  local front slot.  Only one (n,)-sized ``ppermute`` per tick crosses a
  device boundary; the C-slot local buffer is addressed circularly
  (physical slot ``t mod C``), so nothing is locally copied either.
* the **output ring** rotates identically; the last stage writes finished
  microbatch ``m`` into the (constant-virtual-position) slot chosen such
  that after the remaining rotations every output lands exactly at its
  owner — device ``m // C``, slot ``m mod C`` — with no gather/psum.
  A cheap drain phase (rotations only, no span compute) finishes the
  placement after the last output is produced.

Each active microbatch lives wholly on one device at a time (no
intra-span sharding), so the span step is the plain single-device
fixed-step SSFM scan — pipeline parallelism composes orthogonally with
the 'time'-sharded solver in :mod:`opticomlib_tpu.parallel.fiber`.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.noise import gaussian_inside
from ..ops.ssfm import (alpha_per_km, dispersion_phase, ssfm_scan_inside,
                        ssfm_step_schedule, ssfm_while_inside)

__all__ = ["make_span_mesh", "span_pipeline", "span_pipeline_stages",
           "pipeline_stages_core"]


def make_span_mesh(n_spans: int, devices=None) -> Mesh:
    """1-D ('span',) mesh with one device per fiber span."""
    devices = devices if devices is not None else jax.devices()
    if n_spans > len(devices):
        raise ValueError(f"{n_spans} spans need {n_spans} devices, "
                         f"have {len(devices)}")
    return Mesh(np.asarray(devices[:n_spans]), axis_names=("span",))


def span_pipeline(
    A_batch,
    mesh: Mesh,
    fs: float,
    span_length: float,
    alpha: float = 0.0,
    beta_2: float = 0.0,
    beta_3: float = 0.0,
    gamma: float = 0.0,
    h: Optional[float] = 1.0,
    phi_max: float = 0.05,
    gain_db: Optional[float] = None,
    NF: Optional[float] = None,
    f0: Optional[float] = None,
    seed: int = 0,
    span_axis: str = "span",
):
    """Propagate ``B`` waveforms through ``S = mesh.shape[span_axis]``
    identical spans (SSFM + EDFA gain, optionally with keyed ASE),
    pipelined.

    Parameters
    ----------
    A_batch : (B, n) complex array
        Microbatches; ``B`` must be a multiple of ``S`` (each device owns
        ``B/S`` of them — no replication).
    h : float, optional
        Fixed SSFM step [km]; ``None`` -> phi_max-adaptive stepping
        (reference devices.py:1156/1193-1196).  Each active microbatch
        lives wholly on one device, so the adaptive ``max|A|^2`` is a
        local reduction — no collectives.
    gain_db : float, optional
        Per-span EDFA field gain in dB; defaults to ``alpha * span_length``
        (transparent link).
    NF : float, optional
        EDFA noise figure [dB].  When set, each span's gain is followed by
        a keyed ASE draw of power ``idb(NF)*h*f0*(G-1)*fs`` on the carried
        polarization (the EDFA math of the fused link; the orthogonal-pol
        ASE power is not representable in a 1-pol batch — use the fused
        2-pol link for direct-detection ASE-ASE studies).  The key for
        (microbatch ``m``, span ``d``) is
        ``fold_in(fold_in(PRNGKey(seed), m), d)`` — a pure function of the
        logical position, NOT of the pipeline schedule, so the result is
        bit-identical to the sequential span-by-span chain with the same
        keys (tested on an 8-device mesh in tests/test_parallel.py).
    f0 : float, optional
        Optical carrier frequency [Hz] for the ASE power (default:
        c/1550 nm).

    Returns
    -------
    (B, n) complex jax.Array sharded over ``span_axis`` (device ``d``
    holds rows ``[d·B/S, (d+1)·B/S)``) — every microbatch after all S
    spans, identical to applying the spans sequentially on one device
    (tested to float32 round-off in tests/test_parallel.py).
    """
    A_batch = jnp.asarray(A_batch, dtype=jnp.complex64)
    B, n = A_batch.shape
    S = mesh.shape[span_axis]
    if B % S:
        raise ValueError(
            f"batch size {B} must be a multiple of the span count {S} "
            "(each device owns B/S microbatches)")
    C = B // S
    if gain_db is None:
        gain_db = alpha * span_length
    g_field = jnp.float32(10.0 ** (gain_db / 20.0))

    sigma_ase = 0.0
    if NF is not None:
        from scipy.constants import c as c_light

        from ..ops.noise import ase_sigma
        if f0 is None:
            f0 = c_light / 1550e-9
        sigma_ase = ase_sigma(gain_db, NF, f0, fs)
    base_key = jax.random.PRNGKey(seed)

    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    phi_w = jnp.asarray(dispersion_phase(w, beta_2, beta_3))
    a_km = jnp.float32(alpha_per_km(alpha))
    adaptive = h is None and gamma != 0 and (beta_2 != 0 or beta_3 != 0)
    if h is None and not adaptive:
        h = span_length  # linear-only: one step (reference h0 = length)
    hs = (None if adaptive
          else jnp.asarray(ssfm_step_schedule(span_length, h)))
    gamma_f = jnp.float32(gamma)

    def span_step(x, k):
        """One full span: SSFM (fixed scan or phi_max-adaptive while) +
        flat gain + optional keyed ASE (frozen-operator symmetric step,
        reference devices.py:1172-1196)."""
        if adaptive:
            maxP = jnp.maximum(jnp.max(x.real**2 + x.imag**2),
                               jnp.float32(1e-30))
            h0 = jnp.minimum(jnp.float32(phi_max)
                             / (jnp.abs(gamma_f) * maxP),
                             jnp.float32(span_length))
            x, _ = ssfm_while_inside(x, phi_w, span_length, gamma_f,
                                     phi_max, h0, a_km, adaptive=True)
        else:
            x = ssfm_scan_inside(x, phi_w, hs, gamma_f, a_km)
        x = x * g_field
        if sigma_ase:
            d = gaussian_inside(k, (2, n), sigma_ase)
            x = x + jax.lax.complex(d[0], d[1])
        return x

    # ---- schedule bookkeeping (see module docstring) ----
    T1 = B + S - 1                      # compute ticks (last write at T1-1)
    # outputs written (before the tick's rotation) at tick t rotate
    # (T2 - t) positions; landing at virtual position m for every m
    # requires the constant write position w = (T2 - S + 1) mod B to lie
    # in device S-1's virtual range [(S-1)C, B)
    T2 = T1
    while ((T2 - S + 1) % B) < (S - 1) * C:
        T2 += 1
    j0 = ((T2 - S + 1) % B) - (S - 1) * C   # write slot offset, in [0, C)
    n_drain = T2 - T1                        # rotation-only ticks

    ring_left = [(i, (i - 1) % S) for i in range(S)]
    chain_right = [(i, i + 1) for i in range(S - 1)]

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(span_axis, None),),
             out_specs=P(span_axis, None), check_vma=False)
    def run(feed0):
        d = jax.lax.axis_index(span_axis)
        is_first = d == 0
        is_last = d == S - 1

        def rotate(buf, slot):
            """Send physical ``slot`` (the ring front) to the left
            neighbor; the just-vacated slot becomes the back, filled by
            the right neighbor's front."""
            front = jax.lax.dynamic_slice(buf, (slot, 0), (1, n))[0]
            recv = jax.lax.ppermute(front, span_axis, ring_left)
            return jax.lax.dynamic_update_slice(buf, recv[None], (slot, 0))

        def tick(t, carry):
            feed, out, pipe = carry
            fslot = jnp.mod(t, C)
            front = jax.lax.dynamic_slice(feed, (fslot, 0), (1, n))[0]
            x_in = jnp.where(is_first, front, pipe)

            m = t - d
            active = jnp.logical_and(m >= 0, m < B)
            # ASE key is a pure function of the logical (microbatch, span)
            # position — schedule-independent, so pipeline == sequential
            k_md = jax.random.fold_in(
                jax.random.fold_in(base_key, jnp.maximum(m, 0)), d)
            y = span_step(x_in, k_md)
            y = jnp.where(active, y, jnp.zeros_like(y))

            # deposit finished microbatch into the output ring (write
            # happens before this tick's rotation)
            oslot = jnp.mod(j0 + t, C)
            write = jnp.logical_and(active, is_last)
            cur = jax.lax.dynamic_slice(out, (oslot, 0), (1, n))[0]
            out = jax.lax.dynamic_update_slice(
                out, jnp.where(write, y, cur)[None], (oslot, 0))

            feed = rotate(feed, fslot)
            out = rotate(out, jnp.mod(t, C))
            pipe = jax.lax.ppermute(y, span_axis, chain_right)
            return feed, out, pipe

        def drain(t, out):
            return rotate(out, jnp.mod(t, C))

        out0 = jnp.zeros((C, n), jnp.complex64)
        pipe0 = jnp.zeros((n,), jnp.complex64)
        feed, out, _ = jax.lax.fori_loop(0, T1, tick, (feed0, out0, pipe0))
        out = jax.lax.fori_loop(T1, T2, drain, out)
        # physical slot p holds virtual position (p - T2) mod C after the
        # final rotation — undo the circular offset locally
        return jnp.roll(out, -(T2 % C), axis=0)

    A_batch = jax.device_put(A_batch,
                             NamedSharding(mesh, P(span_axis, None)))
    return run(A_batch)


# ---------------------------------------------------------------------------
# Heterogeneous stage-block pipelining (round 4): the full LinkSpec stage
# vocabulary — FIBER(+EDFA) spans, DBP with undo-gain, DM, attenuators,
# RepeatSpec blocks — distributed over the 'span' mesh axis, with 2-pol
# keyed ASE.  This is what makes config 4's 20x80 km FIBER+EDFA / DBP
# chain a *pipelineable public capability* instead of a same-span-only
# primitive.
# ---------------------------------------------------------------------------

def _flatten_stage_specs(stages):
    """Expand RepeatSpec blocks into a flat stage list."""
    from ..link import RepeatSpec

    flat = []
    for st in stages:
        if isinstance(st, RepeatSpec):
            for _ in range(st.n):
                flat.extend(st.stages)
        else:
            flat.append(st)
    return flat


def _stage_segments(stages, fs, f0, n):
    """Lower a flat LinkSpec stage tuple to per-segment parameter vectors.

    A *segment* is one pipeline work unit: ``x *= pre; SSFM(length,
    scheme); x *= gain; x += keyed 2-pol ASE; x = |H|^2 filter`` — every
    piece optional.  Every supported stage maps onto it:

    * ``FiberSpec`` (+ an immediately following ``EDFASpec`` merged in)
      — the classic span; ``DBPSpec`` folds its sign flip and undo-gain
      into (beta, gamma, alpha, pre); ``method`` selects the per-segment
      scheme code (reference / o4 fixed / o4 self-tuning / local_error);
    * a standalone ``EDFASpec`` — zero-length segment (gain/ASE, plus
      its optional ``BW`` output filter as an |H|^2 bank entry);
    * ``DMSpec`` — linear-only unit segment with ``beta_2*length = D``;
    * ``BPFSpec`` — zero-length segment applying only its |H|^2 entry.

    Returns (params dict of float64 np arrays, any_ase flag,
    h2_bank (R, n) float32 array of zero-phase responses —
    ``params['h2_idx'] >= 0`` indexes into it).
    """
    from scipy.constants import c as c_light

    from ..link import (BPFSpec, DBPSpec, DMSpec, EDFASpec, FiberSpec)
    from ..ops import filters
    from ..ops.noise import ase_sigma
    from ..ops.ssfm import alpha_per_km

    if f0 is None:
        f0 = c_light / 1550e-9

    flat = _flatten_stage_specs(stages)
    cols = {k: [] for k in ("pre", "length", "h", "phi_max", "alpha",
                            "beta_2", "beta_3", "gamma", "gain",
                            "sigma_ase", "scheme", "tol", "h2_idx")}
    h2_bank = []      # per-stage zero-phase |H|^2 responses (EDFA BW/BPF)
    h2_cache = {}

    def _h2(order: int, BW_lp: float) -> int:
        """Register a |H|^2 response in the bank, deduplicated."""
        key = (int(order), float(BW_lp))
        if key not in h2_cache:
            h2_cache[key] = len(h2_bank)
            h2_bank.append(np.asarray(filters.bessel_filtfilt_response(
                int(order), float(BW_lp), float(fs), int(n)),
                dtype=np.float32))
        return h2_cache[key]

    def push(pre=1.0, length=0.0, h=0.0, phi_max=0.05, alpha=0.0,
             beta_2=0.0, beta_3=0.0, gamma=0.0, gain=1.0, sigma_ase=0.0,
             scheme=0.0, tol=1e-5, h2_idx=-1.0):
        for k, v in locals().items():
            if k in cols:
                cols[k].append(float(v))

    def edfa_vals(st):
        if st.NF is not None and st.G < 0:
            # mirror the fused builder's build-time check (link.py
            # _stage_plan): a negative-gain ASE draw would NaN sigma
            raise ValueError("EDFASpec with ASE (NF set) needs G >= 0 dB")
        gain = 10.0 ** (st.G / 20.0)
        sig = ase_sigma(st.G, st.NF, f0, fs) if st.NF is not None else 0.0
        return gain, sig

    def scheme_code(st) -> float:
        # 0 = reference (fixed h or phi_max-adaptive), 1 = o4 fixed h,
        # 2 = o4 self-tuning, 3 = local_error (matches _SEG_SCHEMES)
        if st.method == "o4":
            return 1.0 if st.h is not None else 2.0
        if st.method == "local_error":
            return 3.0
        return 0.0

    i = 0
    while i < len(flat):
        st = flat[i]
        if isinstance(st, FiberSpec):            # incl. DBPSpec
            sgn = -1.0 if isinstance(st, DBPSpec) else 1.0
            pre = 1.0
            if isinstance(st, DBPSpec) and st.undo_gain_dB:
                pre = 10.0 ** (-st.undo_gain_dB / 20.0)
            gain, sig = 1.0, 0.0
            h2 = -1.0
            if i + 1 < len(flat) and isinstance(flat[i + 1], EDFASpec):
                nxt = flat[i + 1]
                gain, sig = edfa_vals(nxt)
                if nxt.BW is not None:
                    # optical BPF: full bandwidth BW -> low-pass BW/2
                    # (reference devices.py:938-941 via 818-822)
                    h2 = float(_h2(nxt.filt_order, nxt.BW / 2))
                i += 1
            push(pre=pre, length=st.length,
                 h=(0.0 if st.h is None else st.h), phi_max=st.phi_max,
                 alpha=sgn * alpha_per_km(st.alpha),
                 beta_2=sgn * st.beta_2, beta_3=sgn * st.beta_3,
                 gamma=sgn * st.gamma, gain=gain, sigma_ase=sig,
                 scheme=scheme_code(st), tol=st.tol, h2_idx=h2)
        elif isinstance(st, EDFASpec):
            gain, sig = edfa_vals(st)
            h2 = (float(_h2(st.filt_order, st.BW / 2))
                  if st.BW is not None else -1.0)
            push(gain=gain, sigma_ase=sig, h2_idx=h2)
        elif isinstance(st, DMSpec):
            # H = exp(j w_ps^2 D/2) == a 1 km linear-only span with
            # beta_2 = D (fiber linear phase (beta_2/2) w_ps^2 * h)
            push(length=1.0, h=1.0, beta_2=st.D)
        elif isinstance(st, BPFSpec):
            # zero-length segment applying only the |H|^2 response
            # (reference devices.py:788-826: low-pass cutoff BW/2)
            push(h2_idx=float(_h2(st.n, st.BW / 2)))
        else:
            raise ValueError(f"unsupported pipeline stage {st!r}")
        i += 1

    params = {k: np.asarray(v, np.float64) for k, v in cols.items()}
    bank = (np.stack(h2_bank) if h2_bank
            else np.zeros((0, n), np.float32))
    return params, bool(np.any(params["sigma_ase"] > 0)), bank


def _segment_ssfm(x, w2, w3, length, alpha, beta_2, beta_3, gamma,
                  h_fixed, phi_max):
    """Unified fixed/adaptive SSFM over one segment, all physics as
    traced scalars (so one trace serves every segment of a heterogeneous
    pipeline).  ``h_fixed == 0`` selects the reference phi_max-adaptive
    criterion (devices.py:1156/1193-1196); the step math is the same
    frozen-operator symmetric NL-L-NL step as the fused link
    (:func:`opticomlib_tpu.ops.ssfm._nl_l_nl_step`), so a fixed-step
    pipeline segment is bit-identical to the fused program's scan."""
    phi_w = (beta_2 * jnp.float32(0.5)) * w2 + \
        (beta_3 * jnp.float32(1.0 / 6.0)) * w3
    tiny = jnp.float32(1e-30)
    h_floor = jnp.maximum(length, jnp.float32(1.0)) * jnp.float32(1.5e-7)
    max_steps = jnp.int32(400_000)

    def cond(c):
        _, z, steps = c
        return jnp.logical_and(z < length, steps < max_steps)

    def body(c):
        x, z, steps = c
        maxP = jnp.max(x.real * x.real + x.imag * x.imag)
        h_ad = jnp.minimum(phi_max / jnp.maximum(jnp.abs(gamma) * maxP,
                                                 tiny), length)
        h = jnp.where(h_fixed > 0, h_fixed, h_ad)
        h = jnp.minimum(h, length - z)
        h = jnp.maximum(h, h_floor)
        phi = (gamma * (h / 2)) * (x.real * x.real + x.imag * x.imag)
        half_nl = jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
        x = x * half_nl
        th = phi_w * h
        E = jax.lax.complex(jnp.cos(th), jnp.sin(th)) * jnp.exp(
            jnp.float32(-0.5) * alpha * h)
        x = jnp.fft.ifft(jnp.fft.fft(x, axis=-1) * E, axis=-1)
        return x * half_nl, z + h, steps + 1

    x, _, _ = jax.lax.while_loop(
        cond, body, (x, jnp.float32(0.0), jnp.int32(0)))
    return x


def _segment_ssfm_o4(x, w2, w3, length, alpha, beta_2, beta_3, gamma,
                     h_fixed):
    """4th-order (Yoshida) fixed-step variant of :func:`_segment_ssfm`
    (``FiberSpec(method='o4')`` segments; h is always > 0 — validated
    at spec construction)."""
    from ..ops.ssfm import _W0, _W1, _strang_step

    phi_w = (beta_2 * jnp.float32(0.5)) * w2 + \
        (beta_3 * jnp.float32(1.0 / 6.0)) * w3
    h_floor = jnp.maximum(length, jnp.float32(1.0)) * jnp.float32(1.5e-7)
    max_steps = jnp.int32(400_000)
    w1 = jnp.float32(_W1)
    w0 = jnp.float32(_W0)

    def cond(c):
        _, z, steps = c
        return jnp.logical_and(z < length, steps < max_steps)

    def body(c):
        x, z, steps = c
        h = jnp.maximum(jnp.minimum(h_fixed, length - z), h_floor)
        for wgt in (w1, w0, w1):
            x = _strang_step(x, phi_w, alpha, h * wgt, gamma)
        return x, z + h, steps + 1

    x, _, _ = jax.lax.while_loop(
        cond, body, (x, jnp.float32(0.0), jnp.int32(0)))
    return x


def _segment_phi_w(w2, w3, beta_2, beta_3):
    return (beta_2 * jnp.float32(0.5)) * w2 + \
        (beta_3 * jnp.float32(1.0 / 6.0)) * w3


def _segment_ssfm_o4_auto(x, w2, w3, length, alpha, beta_2, beta_3,
                          gamma, tol):
    """Self-tuning Yoshida S4 segment (``FiberSpec(method='o4',
    h=None)``): the step-doubling controller of
    :func:`opticomlib_tpu.ops.ssfm.ssfm_o4_auto_inside` with all physics
    as traced scalars, so one trace serves every such segment."""
    from ..ops.ssfm import ssfm_o4_auto_inside

    phi_w = _segment_phi_w(w2, w3, beta_2, beta_3)
    x, _ = ssfm_o4_auto_inside(x, phi_w, length, gamma, tol,
                               length / 10.0, alpha)
    return x


def _segment_ssfm_local_error(x, w2, w3, length, alpha, beta_2, beta_3,
                              gamma, tol):
    """Sinkin local-error segment (``FiberSpec(method='local_error')``),
    traced-scalar variant (see :func:`opticomlib_tpu.ops.ssfm.
    ssfm_local_error_inside`)."""
    from ..ops.ssfm import ssfm_local_error_inside

    phi_w = _segment_phi_w(w2, w3, beta_2, beta_3)
    x, _ = ssfm_local_error_inside(x, phi_w, length, gamma, tol,
                                   length / 10.0, alpha)
    return x


def span_pipeline_stages(
    A_batch,
    mesh: Mesh,
    fs: float,
    stages,
    f0: Optional[float] = None,
    seed: int = 0,
    span_axis: str = "span",
):
    """Pipeline a batch of ``B`` waveforms through a **heterogeneous**
    LinkSpec stage chain distributed over the 'span' mesh axis.

    ``stages``: the :class:`opticomlib_tpu.link.LinkSpec` channel-stage
    vocabulary — ``FiberSpec``/``DBPSpec`` (optionally followed by an
    ``EDFASpec`` merged into the same segment), standalone ``EDFASpec``,
    ``DMSpec``, and ``RepeatSpec`` blocks (expanded).  The flattened
    segment count must be a multiple of the mesh's span count ``S``;
    device ``d`` owns segments ``[d*K, (d+1)*K)`` and executes them
    back-to-back as one pipeline stage (config 4's 20x FIBER+EDFA +
    20x DBP chain on 8 devices -> 5 segments per device).

    2-pol keyed ASE: when any segment amplifies with ``NF`` set, the
    batch is promoted to (B, 2, n) at entry and each segment's ASE is
    drawn with ``fold_in(fold_in(PRNGKey(seed), m), s)`` — a pure
    function of (microbatch ``m``, segment ``s``), NOT of the pipeline
    schedule, so the result is bit-identical to the sequential
    segment-by-segment chain (tested in tests/test_parallel.py).

    Returns a (B, n) — or (B, 2, n) when ASE promoted — complex
    jax.Array sharded over ``span_axis`` (device ``d`` holds rows
    ``[d*B/S, (d+1)*B/S)``).
    """
    A_batch = jnp.asarray(A_batch, dtype=jnp.complex64)
    if A_batch.ndim != 2:
        raise ValueError("A_batch must be (B, n)")
    B, n = A_batch.shape
    run, any_ase, pol_shape = pipeline_stages_core(
        mesh, fs, stages, n=n, B=B, f0=f0, span_axis=span_axis)
    if any_ase:
        A_batch = jnp.stack([A_batch, jnp.zeros_like(A_batch)], axis=1)
    A_batch = jax.device_put(
        A_batch, NamedSharding(mesh, P(span_axis,
                                       *(None,) * len(pol_shape))))
    return jax.jit(run)(A_batch, jnp.uint32(seed))


def pipeline_stages_core(mesh: Mesh, fs: float, stages, n: int, B: int,
                         f0: Optional[float] = None,
                         span_axis: str = "span"):
    """Build the (unjitted) shard_map'd pipeline runner for
    :func:`span_pipeline_stages` — factored out so the fused link can
    embed the pipeline inside ITS one jitted program
    (:class:`opticomlib_tpu.link_pipeline.PipelinedLinkProgram`).

    Returns ``(run, any_ase, pol_shape)``: ``run(batch, seed_u32)`` maps
    a (B,) + pol_shape complex batch sharded ``P(span_axis, None, ...)``
    to the propagated batch with the same sharding.  The ASE seed is a
    **traced** uint32 argument (not baked into the trace), so seed-sweep
    Monte Carlo runs reuse one compiled program.
    """
    S = mesh.shape[span_axis]
    if B % S:
        raise ValueError(
            f"batch size {B} must be a multiple of the span count {S}")
    C = B // S

    params, any_ase, h2_bank = _stage_segments(stages, fs, f0, n)
    n_seg = params["length"].size
    if n_seg == 0:
        raise ValueError("stages resolve to zero pipeline segments")
    if n_seg % S:
        raise ValueError(
            f"{n_seg} segments not a multiple of the span count {S}; "
            "pad with RepeatSpec/identity stages or change the mesh")
    K = n_seg // S

    pvec = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    scheme_vec = jnp.asarray(params["scheme"], jnp.int32)
    h2_idx_vec = jnp.asarray(params["h2_idx"], jnp.int32)
    has_h2 = h2_bank.shape[0] > 0
    h2_bank_j = jnp.asarray(h2_bank) if has_h2 else None

    w_ps = 2 * np.pi * np.fft.fftfreq(n) * fs * 1e-12  # rad/ps
    w2 = jnp.asarray((w_ps ** 2).astype(np.float32))
    w3 = jnp.asarray((w_ps ** 3).astype(np.float32))

    pol_shape = (2, n) if any_ase else (n,)

    def stage_step(x, m, d, base_key):
        """All K local segments, back to back (one pipeline stage)."""
        def seg(j, x):
            s = d * K + j
            x = x * pvec["pre"][s]
            args = (w2, w3, pvec["length"][s], pvec["alpha"][s],
                    pvec["beta_2"][s], pvec["beta_3"][s],
                    pvec["gamma"][s])
            x = jax.lax.switch(
                scheme_vec[s],
                [lambda x: _segment_ssfm(x, *args, pvec["h"][s],
                                         pvec["phi_max"][s]),
                 lambda x: _segment_ssfm_o4(x, *args, pvec["h"][s]),
                 lambda x: _segment_ssfm_o4_auto(x, *args,
                                                 pvec["tol"][s]),
                 lambda x: _segment_ssfm_local_error(x, *args,
                                                     pvec["tol"][s])],
                x)
            x = x * pvec["gain"][s]
            if any_ase:
                k_ms = jax.random.fold_in(
                    jax.random.fold_in(base_key, jnp.maximum(m, 0)), s)
                dr = gaussian_inside(k_ms, (4, n), 1.0)
                x = x + pvec["sigma_ase"][s] * jax.lax.complex(dr[:2],
                                                               dr[2:])
            if has_h2:
                # per-stage zero-phase |H|^2 (EDFA BW / BPF stages),
                # applied after gain+ASE exactly like the fused builder.
                # lax.cond (not compute+where) so segments WITHOUT a
                # response skip the FFT pair entirely (review fix)
                idx = h2_idx_vec[s]
                x = jax.lax.cond(
                    idx >= 0,
                    lambda x: jnp.fft.ifft(
                        jnp.fft.fft(x, axis=-1)
                        * jnp.take(h2_bank_j, jnp.maximum(idx, 0),
                                   axis=0), axis=-1),
                    lambda x: x, x)
            return x

        return jax.lax.fori_loop(0, K, seg, x)

    # ---- schedule bookkeeping: identical to span_pipeline ----
    T1 = B + S - 1
    T2 = T1
    while ((T2 - S + 1) % B) < (S - 1) * C:
        T2 += 1
    j0 = ((T2 - S + 1) % B) - (S - 1) * C
    n_drain = T2 - T1  # noqa: F841  (documentation of the drain length)

    ring_left = [(i, (i - 1) % S) for i in range(S)]
    chain_right = [(i, i + 1) for i in range(S - 1)]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(span_axis, *(None,) * len(pol_shape)), P()),
             out_specs=P(span_axis, *(None,) * len(pol_shape)),
             check_vma=False)
    def run(feed0, seed_u32):
        d = jax.lax.axis_index(span_axis)
        is_first = d == 0
        is_last = d == S - 1
        base_key = jax.random.PRNGKey(seed_u32)

        def rotate(buf, slot):
            front = jax.lax.dynamic_slice(
                buf, (slot,) + (0,) * len(pol_shape), (1,) + pol_shape)[0]
            recv = jax.lax.ppermute(front, span_axis, ring_left)
            return jax.lax.dynamic_update_slice(
                buf, recv[None], (slot,) + (0,) * len(pol_shape))

        def tick(t, carry):
            feed, out, pipe = carry
            fslot = jnp.mod(t, C)
            front = jax.lax.dynamic_slice(
                feed, (fslot,) + (0,) * len(pol_shape),
                (1,) + pol_shape)[0]
            x_in = jnp.where(is_first, front, pipe)

            m = t - d
            active = jnp.logical_and(m >= 0, m < B)
            y = stage_step(x_in, m, d, base_key)
            y = jnp.where(active, y, jnp.zeros_like(y))

            oslot = jnp.mod(j0 + t, C)
            write = jnp.logical_and(active, is_last)
            cur = jax.lax.dynamic_slice(
                out, (oslot,) + (0,) * len(pol_shape), (1,) + pol_shape)[0]
            out = jax.lax.dynamic_update_slice(
                out, jnp.where(write, y, cur)[None],
                (oslot,) + (0,) * len(pol_shape))

            feed = rotate(feed, fslot)
            out = rotate(out, jnp.mod(t, C))
            pipe = jax.lax.ppermute(y, span_axis, chain_right)
            return feed, out, pipe

        def drain(t, out):
            return rotate(out, jnp.mod(t, C))

        out0 = jnp.zeros((C,) + pol_shape, jnp.complex64)
        pipe0 = jnp.zeros(pol_shape, jnp.complex64)
        feed, out, _ = jax.lax.fori_loop(0, T1, tick, (feed0, out0, pipe0))
        out = jax.lax.fori_loop(T1, T2, drain, out)
        return jnp.roll(out, -(T2 % C), axis=0)

    return run, any_ase, pol_shape
