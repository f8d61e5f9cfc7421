"""Sharded fused link: the whole TX -> channel -> RX chain as ONE XLA
program over a ``('wdm', 'time')`` device mesh, waveform device-resident
end to end.

This is the north-star shape (BASELINE.md): the fused program of
:mod:`opticomlib_tpu.link` composed with the sharded runtime of
:mod:`opticomlib_tpu.parallel` —

* the **time (sample) axis** is sharded over the ``'time'`` mesh axis;
  every full-length spectral operation (DAC pulse shaping, SSFM linear
  steps, DM/BPF multiplies, the PD's electrical low-pass) runs through
  the exact distributed pencil FFT (:mod:`opticomlib_tpu.parallel.dfft`,
  two ``all_to_all`` per transform);
* the **WDM channel axis** rides the ``'wdm'`` mesh axis data-parallel;
* the receiver (eye metrology on a small gathered window, threshold
  scan, slicer, error count) runs after the ``shard_map`` core inside
  the same ``jit`` — XLA partitions the reductions, and only scalars
  leave the device.

Entry point: ``build_link(spec, n_bits, mesh=...)``
(:func:`opticomlib_tpu.link.build_link` dispatches here when ``mesh`` is
given).  Reference staged equivalent:
examples/ook_transmission_fiber_simulation.py:27-67 (single process).

Design notes:

* **Spectral constants in strided layout.**  After ``pencil_fft``,
  device ``q`` of ``P`` holds spectrum bins ``q + P*k2``.  Host-designed
  responses (pulse spectrum, Bessel ``|H|^2``) are permuted once with
  ``H.reshape(B, P).T`` and sharded over ``'time'``, so the in-graph
  multiply needs no reordering.  Dispersion phases are evaluated
  in-graph on the strided grid (``strided_w_grid``) — exact, no
  communication, nothing stored.
* **Noise is block-local.**  Each device draws its slice with
  ``fold_in(stage_key, time_index)`` — zero extra memory and
  schedule-independent, but a *different stream* from the unsharded
  program (which draws length-n arrays).  A seed is bit-reproducible
  across runs of the same mesh; noiseless sharded == unsharded to
  float32 round-off (tested); noisy runs agree statistically.  The
  laser's Wiener phase random walk needs a global prefix — each device
  cumsums its local increments and adds the ``all_gather``-ed sum of the
  preceding blocks.
* **Adaptive stepping** (``FiberSpec(h=None)``) uses the reference
  phi_max criterion per channel: a masked multi-channel
  ``lax.while_loop`` whose per-channel ``max|A|^2`` is an
  all-reduce(max) over the ``'time'`` axis (SURVEY §2.6), finished
  channels frozen until all are done.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from scipy.constants import e, k as kB, pi

from .link import (EDFASpec, FiberSpec, LinkSpec, RepeatSpec,
                   _ook_rx_ingraph, _ppm_hard_rx_ingraph, _pulse_taps,
                   _circular_zero_phase_spectrum, _stage_plan, _warn_rin)
from .ops import filters, ssfm
from .ops.noise import gaussian_inside
from .params import SimParams
from .parallel.dfft import pencil_fft, pencil_ifft, strided_w_grid
from .utils.analysis import idb, idbm

__all__ = ["ShardedLinkProgram"]


def _strided_permute(H: np.ndarray, P_: int) -> np.ndarray:
    """Permute a natural-FFT-order response of length ``n = P*B`` into the
    pencil strided layout: the ``q``-th contiguous block of the result is
    ``H[q + P*k2]`` for ``k2 in [0, B)`` — exactly device ``q``'s local
    spectrum slice after ``pencil_fft``."""
    n = H.shape[-1]
    B = n // P_
    return np.ascontiguousarray(H.reshape(B, P_).T).reshape(n)


def _split_v(streams):
    """Vectorized key split: (lc, 2) -> ((lc, 2), (lc, 2))."""
    pair = jax.vmap(jax.random.split)(streams)
    return pair[:, 0], pair[:, 1]


def _fold_v(keys, data):
    """Vectorized fold_in of a scalar into (lc, 2) keys."""
    return jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)


def _draw_v(keys, shape, sigma):
    """Per-channel local draws: keys (lc, 2) -> (lc,) + shape float32."""
    return jax.vmap(lambda k: gaussian_inside(k, shape, sigma))(keys)


def blockwise_cumsum(x, axis_name: str):
    """Global cumulative sum along the last axis of a block-sharded
    ``x`` (lc, block), inside ``shard_map`` over ``axis_name``: the local
    cumsum plus the sums of the blocks before this one, all-gathered and
    added as a masked sum (exact in float32, where a matmul may run in
    TF32 on a GPU)."""
    q = jax.lax.axis_index(axis_name)
    n_blocks = jax.lax.axis_size(axis_name)
    totals = jax.lax.all_gather(x.sum(-1), axis_name)   # (P, lc)
    before = (jnp.arange(n_blocks) < q)[:, None]
    prefix = jnp.sum(jnp.where(before, totals, 0.0), axis=0)
    return jnp.cumsum(x, axis=-1) + prefix[:, None]


class ShardedLinkProgram:
    """A fused link compiled over a device mesh.  Same surface as
    :class:`opticomlib_tpu.link.LinkProgram` where it applies:
    :meth:`dsp` (fully-fused OOK receiver, scalars-only readback),
    :meth:`dsp_wdm` (per-channel receivers over the 'wdm' axis),
    :meth:`run` (waveform readback — gathers to host, intended for small
    n), and :attr:`fn` (jittable ``(bits, seeds, consts) -> (v, slots)``
    with the shard_map core inside).
    """

    def __init__(self, spec: LinkSpec, n_bits: int, params: SimParams,
                 mesh: Mesh, time_axis: str = "time",
                 wdm_axis: Optional[str] = "wdm",
                 return_field: bool = False):
        self.spec = spec
        self.n_bits = int(n_bits)
        self.params = params
        self.mesh = mesh
        self.time_axis = time_axis
        if wdm_axis is not None and wdm_axis not in mesh.axis_names:
            wdm_axis = None
        self.wdm_axis = wdm_axis
        self.return_field = return_field

        sps = params.sps
        n = self.n_bits * sps
        self.n = n
        fs = params.fs
        P_t = mesh.shape[time_axis]
        self.n_time = P_t
        self.n_wdm = mesh.shape[wdm_axis] if wdm_axis else 1
        if self.n_bits % P_t:
            raise ValueError(f"n_bits {n_bits} not divisible by the "
                             f"'{time_axis}' mesh size {P_t}")
        block = n // P_t
        if block % P_t:
            raise ValueError(
                f"pencil FFT needs n divisible by n_time^2: n={n}, "
                f"n_time={P_t} (block {block} % {P_t} != 0)")
        if block % sps:
            raise ValueError("block must hold whole slots")
        self.block = block

        # ---- host-side constants (strided layout, sharded over time) ----
        consts = {}
        hp = _pulse_taps(spec, sps)
        Hp = _strided_permute(_circular_zero_phase_spectrum(hp, n), P_t)
        consts["Hp_re"] = Hp.real.astype(np.float32)
        consts["Hp_im"] = Hp.imag.astype(np.float32)
        # (a chirped/complex pulse needs no special case here: the MZM
        # drive is real, and Re{ifft} commutes with the AC-mean removal)

        consts["H2_pd"] = _strided_permute(np.asarray(
            filters.bessel_filtfilt_response(
                spec.lpf_order, float(spec.pd_BW), fs, n),
            dtype=np.float32), P_t)

        _h2_cache = {}

        def _bpf_const(order: int, BW: float) -> str:
            key = (order, float(BW))
            if key not in _h2_cache:
                name = f"H2_bpf_{len(_h2_cache)}"
                consts[name] = _strided_permute(np.asarray(
                    filters.bessel_filtfilt_response(
                        order, float(BW) / 2, fs, n), np.float32), P_t)
                _h2_cache[key] = name
            return _h2_cache[key]

        stage_consts = _stage_plan(
            spec.stages, params.f0, fs,
            fiber_extra=lambda st: {},   # phi evaluated in-graph on the
            # strided grid (strided_w_grid) — nothing registered
            dm_const=lambda st: {"D": float(st.D)},
            bpf_name=_bpf_const)

        # laser scalars (same derivations as the unsharded program)
        dt = 1.0 / fs
        P0_amp = float(np.sqrt(idbm(spec.P0)))
        sigma_ph = (float(np.sqrt(2 * pi * spec.lw * dt))
                    if spec.lw and spec.lw > 0 else 0.0)
        sigma_rin = (float(np.sqrt(idb(spec.rin) * fs))
                     if spec.rin is not None else 0.0)
        # same build-time RIN validity check as the unsharded builder
        # (expected minimum of n draws crossing -1 would NaN sqrt in-graph)
        if sigma_rin * math.sqrt(2 * math.log(max(n, 2))) >= 1.0:
            raise ValueError(
                "Noise power is to high, try decrease RIN parameter.")
        has_df = bool(spec.df)
        if has_df:
            # mod-2pi in float64 BEFORE the float32 cast (same hazard note
            # as the unsharded builder: raw phase ~1e7 rad at long windows
            # where float32 ulp is whole radians); time-domain const, so a
            # plain contiguous P(time) shard gives device q its samples
            t_axis = np.linspace(0.0, n / fs, n, endpoint=True)
            consts["df_phase"] = np.mod(
                2 * pi * spec.df * t_axis, 2 * pi).astype(np.float32)

        loss_amp = float(idb(-spec.loss_dB) ** 0.5)
        eta_half = float(idb(-spec.ER_dB) ** 0.5)
        g_scale = float(pi / 2 / spec.Vpi)
        is_pm = spec.modulator.lower() == "pm"
        ac = spec.coupling.strip().upper() == "AC"
        S_T = (4 * kB * spec.pd_T * fs / 2 * idb(spec.pd_Fn)
               / spec.pd_R_load if spec.include_thermal else 0.0)
        instant = (spec.sampler_instant if spec.sampler_instant is not None
                   else sps // 2)
        stages = spec.stages
        return_field_flag = return_field

        t_ax, w_ax = time_axis, wdm_axis

        # ------------------------------------------------------------------
        # the shard_map core: (lc, bits_block) -> (lc, block) waveforms
        # ------------------------------------------------------------------
        def _pmax_t(x):
            return jax.lax.pmax(x, t_ax)

        def _pmean_t(x):
            return jax.lax.pmean(x, t_ax)

        def _phi_strided(q, beta_2, beta_3):
            """Dispersion phase [rad/km] on this device's strided bins."""
            w = strided_w_grid(q, P_t, block, fs) * 1e-12  # rad/ps
            return (beta_2 / 2 * w**2 + beta_3 / 6 * w**3).astype(
                jnp.float32)

        def _spectral(x, H):
            """Global spectral multiply via the pencil FFT (H in strided
            layout, broadcast over leading axes)."""
            X = pencil_fft(x, t_ax)
            return pencil_ifft(X * H, t_ax)

        def _fiber_fixed(A, phi_q, hs, gamma, a_km):
            """Fixed-schedule sharded SSFM (frozen-operator symmetric
            step, reference devices.py:1172-1196), pencil linear step."""
            gamma = jnp.float32(gamma)
            a_km = jnp.float32(a_km)
            hs = jnp.asarray(hs)
            h0 = hs[0]
            E0 = ssfm._lin_factor(phi_q, a_km, h0)

            def step(a, hh):
                ph = (gamma * (hh / 2)) * (a.real**2 + a.imag**2)
                half = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
                a = a * half
                E = jax.lax.cond(hh == h0, lambda: E0,
                                 lambda: ssfm._lin_factor(phi_q, a_km, hh))
                a = _spectral(a * 1.0, E)
                return a * half, None

            A, _ = jax.lax.scan(step, A, hs)
            return A

        def _fiber_adaptive(A, phi_q, length, gamma, a_km, phi_max):
            """phi_max-adaptive sharded SSFM with PER-CHANNEL step sizes:
            one masked while_loop advances every local channel with its
            own h (reference criterion devices.py:1156/1193-1196); the
            per-channel max|A|^2 is an all-reduce(max) over 'time', so
            every device in a time group sees the same h vector and the
            loop stays SPMD-consistent.  Finished channels are frozen."""
            gamma = jnp.float32(gamma)
            a_km = jnp.float32(a_km)
            length_f = jnp.float32(length)
            phi_max_f = jnp.float32(phi_max)
            lead = A.shape[:-1]          # (lc,) or (lc, 2)
            ch_axes = tuple(range(1, A.ndim))  # reduce all but channel

            def ch_max_power(a):
                m = jnp.max(a.real**2 + a.imag**2, axis=ch_axes)
                return _pmax_t(m)        # (lc,)

            h_floor = length_f * jnp.float32(1.5e-7)
            max_steps = jnp.int32(400_000)

            def bcast(v):
                """(lc,) -> broadcastable over A's trailing axes."""
                return v.reshape(v.shape + (1,) * (A.ndim - 1))

            def cond(carry):
                _, z, _, steps = carry
                return jnp.logical_and(jnp.any(z < length_f),
                                       steps < max_steps)

            def body(carry):
                A, z, h, steps = carry
                live = z < length_f                      # (lc,)
                h_eff = jnp.where(live, h, 0.0)
                z_new = z + h_eff
                ph = (gamma * bcast(h_eff / 2)) * (A.real**2 + A.imag**2)
                half = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
                a = A * half
                E = ssfm._lin_factor(phi_q, a_km, bcast(h_eff))
                a = _spectral(a, E) * half
                A = jnp.where(bcast(live), a, A)
                maxP = ch_max_power(A)
                h_next = phi_max_f / (jnp.abs(gamma) * maxP)
                h_next = jnp.minimum(h_next, length_f - z_new)
                h_next = jnp.maximum(h_next, h_floor)
                return (A, z_new, h_next.astype(jnp.float32), steps + 1)

            maxP0 = ch_max_power(A)
            h0 = jnp.minimum(phi_max_f / (jnp.abs(gamma) * maxP0),
                             length_f)
            z0 = jnp.zeros(lead[:1], jnp.float32)
            A, _, _, _ = jax.lax.while_loop(
                cond, body, (A, z0, h0.astype(jnp.float32), jnp.int32(0)))
            return A

        def core(bits_blk, seeds, consts_blk):
            """bits_blk: (lc, bits_block) f32; seeds: (lc,) uint32;
            consts_blk: dict of (block,)-strided arrays.  Returns
            (v, slots[, field_re, field_im]) local blocks."""
            q = jax.lax.axis_index(t_ax)
            lc = bits_blk.shape[0]

            streams = jax.vmap(jax.random.PRNGKey)(seeds)   # (lc, 2)

            # --- DAC: zero-stuff + global circular pulse shaping ---
            xu = jnp.zeros(bits_blk.shape + (sps,), jnp.float32)
            xu = xu.at[..., sps // 2].set(bits_blk)
            xu = xu.reshape(lc, block).astype(jnp.complex64)
            Hp = jax.lax.complex(consts_blk["Hp_re"], consts_blk["Hp_im"])
            x = pencil_ifft(pencil_fft(xu, t_ax) * Hp, t_ax).real
            x = x * jnp.float32(spec.Vpp) + jnp.float32(spec.offset)
            if ac:
                x = x - _pmean_t(jnp.mean(x, axis=-1))[:, None]

            # --- LASER (block-local keyed draws; see module notes) ---
            streams, k_laser = _split_v(streams)
            kl = jax.vmap(jax.random.split)(k_laser)
            k_ph, k_rin = kl[:, 0], kl[:, 1]
            phase = jnp.zeros((lc, 1), jnp.float32)
            if sigma_ph > 0:
                steps = _draw_v(_fold_v(k_ph, q), (block,), sigma_ph)
                phase = blockwise_cumsum(steps, t_ax)
            if has_df:
                phase = phase + consts_blk["df_phase"]
            amp = jnp.full((lc, 1), P0_amp, jnp.float32)
            rin_ok = jnp.ones((lc,), jnp.float32)
            if sigma_rin > 0:
                rin = _draw_v(_fold_v(k_rin, q), (block,), sigma_rin)
                # clamp 1+rin at 0: a tail draw past -1 darkens one sample
                # instead of NaN-ing the chain (same guard as link.py);
                # the per-channel validity flag travels with the outputs
                # (pmin over the time groups -> every device agrees)
                rin_ok = (jax.lax.pmin(jnp.min(rin, axis=-1), t_ax)
                          > -1.0).astype(jnp.float32)
                amp = amp * jnp.sqrt(jnp.maximum(1 + rin, 0.0))
            if sigma_ph > 0 or has_df:
                E = amp * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
            else:
                E = jnp.broadcast_to(amp, (lc, block)).astype(jnp.complex64)

            # --- modulator ---
            if is_pm:
                g = jnp.float32(pi / spec.Vpi) * x
                field = E * jax.lax.complex(jnp.cos(g), jnp.sin(g))
            else:
                g = jnp.float32(g_scale) * (x + jnp.float32(spec.bias))
                h_t = jnp.float32(loss_amp) * jax.lax.complex(
                    jnp.cos(g), jnp.float32(eta_half) * jnp.sin(g))
                field = E * h_t                           # (lc, block)

            # --- channel stages ---
            def promote_2pol(f):
                if f.ndim == 2:
                    return jnp.stack([f, jnp.zeros_like(f)], axis=1)
                return f                                  # (lc, 2, block)

            def apply_fiber(f, st, cc):
                if "pre_scale" in cc:
                    f = f * jnp.float32(cc["pre_scale"])
                sgn = cc["sgn"]
                phi_q = _phi_strided(q, sgn * st.beta_2, sgn * st.beta_3)
                g_nl = sgn * st.gamma
                a_lin = sgn * cc["a_km"]
                if cc["linear_only"] and cc["hs"] is None:
                    return _fiber_fixed(f, phi_q, [st.length], g_nl, a_lin)
                if cc["hs"] is not None:
                    if cc["method"] == "o4":
                        # Yoshida composition with the pencil-FFT
                        # spectral multiply as the linear substep
                        return ssfm.ssfm_o4_scan_inside(
                            f, phi_q, jnp.asarray(cc["hs"]), g_nl, a_lin,
                            spectral=lambda A, E: _spectral(A, E))
                    return _fiber_fixed(f, phi_q, cc["hs"], g_nl, a_lin)
                if cc["method"] in ("o4", "local_error"):
                    # self-tuning schemes on the sharded waveform: the
                    # pencil FFT is the spectral substep, and the error
                    # norms are psum'd over the time groups so every
                    # device agrees on h.  (One joint h over this
                    # device's local channels — the error target is the
                    # joint relative norm, conservative per channel.)
                    fn = (ssfm.ssfm_o4_auto_inside if cc["method"] == "o4"
                          else ssfm.ssfm_local_error_inside)
                    f, _ = fn(
                        f, phi_q, st.length, g_nl, st.tol,
                        st.length / 10.0, a_lin,
                        reduce_sum=lambda s: jax.lax.psum(s, t_ax),
                        spectral=lambda A, E: _spectral(A, E))
                    return f
                return _fiber_adaptive(f, phi_q, st.length, g_nl, a_lin,
                                       st.phi_max)

            def apply_edfa(f, cc, keys):
                if "sigma_ase" in cc:
                    f = promote_2pol(f) * jnp.float32(cc["sqrtG"])
                    d = _draw_v(_fold_v(keys, q), (4, block),
                                cc["sigma_ase"])
                    f = f + jax.lax.complex(d[:, :2], d[:, 2:])
                else:
                    f = f * jnp.float32(cc["sqrtG"])
                if "H2_name" in cc:
                    f = _spectral(f, consts_blk[cc["H2_name"]])
                return f

            def apply_linear(f, cc):
                if cc["kind"] == "dm":
                    w_ps = strided_w_grid(q, P_t, block, fs) * 1e-12
                    ph = (w_ps**2 * cc["D"] / 2).astype(jnp.float32)
                    H = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
                else:
                    H = consts_blk[cc["H2_name"]]
                return _spectral(f, H)

            for st, cc in zip(stages, stage_consts):
                if cc["kind"] == "fiber":
                    field = apply_fiber(field, st, cc)
                elif cc["kind"] == "edfa":
                    if "sigma_ase" in cc:
                        streams, k_ase = _split_v(streams)
                    else:
                        k_ase = None
                    field = apply_edfa(field, cc, k_ase)
                elif cc["kind"] in ("dm", "bpf"):
                    field = apply_linear(field, cc)
                else:  # repeat
                    if cc["needs_ase"]:
                        streams, k_rep = _split_v(streams)
                        field = promote_2pol(field)
                    else:
                        k_rep = jax.vmap(jax.random.PRNGKey)(
                            jnp.zeros((lc,), jnp.uint32))

                    def span_body(f, idx, st=st, cc=cc, k_rep=k_rep):
                        k_i = jax.vmap(
                            lambda k: jax.random.fold_in(k, idx))(k_rep)
                        for s_st, s_cc in zip(st.stages, cc["sub"]):
                            if s_cc["kind"] == "fiber":
                                f = apply_fiber(f, s_st, s_cc)
                            elif s_cc["kind"] == "edfa":
                                if "sigma_ase" in s_cc:
                                    k_i, k_sub = _split_v(k_i)
                                    f = apply_edfa(f, s_cc, k_sub)
                                else:
                                    f = apply_edfa(f, s_cc, None)
                            else:
                                f = apply_linear(f, s_cc)
                        return f, None

                    field, _ = jax.lax.scan(
                        span_body, field,
                        jnp.arange(cc["n"], dtype=jnp.uint32))

            # --- PD ---
            Pw = field.real**2 + field.imag**2
            if field.ndim == 3:
                Pw = Pw.sum(axis=1)
            i_ph = jnp.float32(spec.pd_r) * Pw            # (lc, block)

            streams, k_pd = _split_v(streams)
            kp = jax.vmap(jax.random.split)(k_pd)
            k_T, k_N = kp[:, 0], kp[:, 1]
            i = i_ph
            if spec.include_thermal or spec.include_shot:
                i = i + jnp.float32(spec.i_dark)
            if spec.include_thermal:
                i = i + _draw_v(_fold_v(k_T, q), (block,), S_T**0.5)
            if spec.include_shot:
                mean_i = _pmean_t(jnp.mean(i_ph, axis=-1))    # (lc,)
                S_N = (2 * jnp.float32(e)
                       * (mean_i + jnp.float32(spec.i_dark))
                       * jnp.float32(fs / 2))
                draws = _draw_v(_fold_v(k_N, q), (block,), 1.0)
                i = i + jnp.sqrt(S_N)[:, None] * draws

            # --- electrical LPF via pencil FFT ---
            v = _spectral((i * jnp.float32(spec.pd_R_load)
                           ).astype(jnp.complex64),
                          consts_blk["H2_pd"]).real
            if spec.adc_bits is not None:
                # in-graph sharded ADC: the 99.99% shortest-interval range
                # comes from a psum-reduced fixed-bin histogram quantile —
                # no global sort needed (the estimator tolerates the
                # bin-width error; reference devices.py:1616-1627)
                from .ops.eyeana import shortest_int_hist
                lo, hi = shortest_int_hist(
                    v, 99.99,
                    reduce_sum=lambda x: jax.lax.psum(x, t_ax),
                    reduce_min=lambda x: jax.lax.pmin(x, t_ax),
                    reduce_max=_pmax_t)
                nq = jnp.float32(2 ** int(spec.adc_bits) - 1)
                rng_q = (hi - lo)[..., None]
                code = jnp.round((v - lo[..., None]) / rng_q * nq)
                v = code / nq * rng_q + lo[..., None]
            out = (v, v[..., instant::sps])
            if return_field_flag:
                out = out + (field.real, field.imag)  # (lc[,2],block)
            # trailing diagnostics, same contract as LinkProgram.fn:
            # rin_ok[c] == 0 marks a clamped RIN draw on channel c
            return out + (rin_ok,)

        # ------------------------------------------------------------------
        # jit wrapper: shard_map core + sharded input placement
        # ------------------------------------------------------------------
        if wdm_axis:
            in_bits = P(w_ax, t_ax)
            in_seeds = P(w_ax)
        else:
            in_bits = P(None, t_ax)
            in_seeds = P(None)
        # does the channel promote to 2 polarizations (noisy EDFA)?
        def _has_ase(sts):
            return any((isinstance(s, EDFASpec) and s.NF is not None)
                       or (isinstance(s, RepeatSpec) and _has_ase(s.stages))
                       for s in sts)
        two_pol = _has_ase(spec.stages)
        field_sp = (P(*(in_bits[0], None, t_ax)) if two_pol else in_bits)
        out_sp = (in_bits, in_bits) + ((field_sp, field_sp)
                                       if return_field else ()) \
            + (in_seeds,)  # rin_ok: (lc,) channel-sharded flags

        core_sharded = shard_map(
            core, mesh=mesh,
            in_specs=(in_bits, in_seeds,
                      {k: P(t_ax) for k in consts}),
            out_specs=out_sp, check_vma=False)

        self.consts = {k: jax.device_put(
            jnp.asarray(v), NamedSharding(mesh, P(t_ax)))
            for k, v in consts.items()}
        self._in_bits_spec = in_bits
        self._in_seeds_spec = in_seeds
        self.fn = core_sharded
        self._jitted = jax.jit(core_sharded)
        self._dsp_cache = {}

    # ---------------------------------------------------------------- io
    def _place(self, bits, seeds):
        bits = jnp.asarray(bits, jnp.float32)
        if bits.ndim == 1:
            bits = bits[None]
        n_ch = bits.shape[0]
        if self.wdm_axis and n_ch % self.n_wdm:
            raise ValueError(f"{n_ch} channels not divisible by the "
                             f"'{self.wdm_axis}' mesh size {self.n_wdm}")
        bits = jax.device_put(bits, NamedSharding(self.mesh,
                                                  self._in_bits_spec))
        seeds = jax.device_put(jnp.asarray(seeds, jnp.uint32),
                               NamedSharding(self.mesh,
                                             self._in_seeds_spec))
        return bits, seeds

    def jitted(self, bits, seeds):
        """Compiled sharded program on the prebuilt constants."""
        bits, seeds = self._place(bits, seeds)
        return self._jitted(bits, seeds, self.consts)

    def run(self, bits=None, seed: int = 0, prbs_order: int = 15):
        """Run the sharded chain and gather (v, slots) to host — use for
        verification at small n; production receivers should stay
        device-side via :meth:`dsp`/:meth:`dsp_wdm`."""
        if bits is None or np.ndim(bits) == 1:
            if self.n_wdm > 1:
                raise ValueError(
                    f"run() with a single channel needs a mesh without a "
                    f"'{self.wdm_axis}' axis (or size 1); this mesh has "
                    f"{self.n_wdm} — pass (k*{self.n_wdm}, n_bits) bits")
        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=self.n_bits)
            bits = np.asarray(b.data, np.float32)
        bits = np.atleast_2d(np.asarray(bits, np.float32))
        seeds = np.arange(bits.shape[0], dtype=np.uint32) + np.uint32(seed)
        out = self.jitted(bits, seeds)
        rin_ok = np.asarray(out[-1]) > 0
        if not rin_ok.all():
            _warn_rin(np.flatnonzero(~rin_ok).tolist())
        return SimpleNamespace(
            v=np.asarray(out[0]).squeeze(0) if out[0].shape[0] == 1
            else np.asarray(out[0]),
            slots=np.asarray(out[1]).squeeze(0) if out[1].shape[0] == 1
            else np.asarray(out[1]),
            tx=np.asarray(bits).astype(np.uint8),
            rin_ok=(bool(rin_ok[0]) if rin_ok.size == 1 else rin_ok))

    # ------------------------------------------------------------- dsp
    def _dsp_program(self, n_channels: int, nslots: int,
                     sps_resamp: Optional[int]):
        key = (n_channels, nslots, sps_resamp)
        if key not in self._dsp_cache:
            sps = self.params.sps
            W = min(nslots, self.n_bits) * sps

            w_spec = P(self.wdm_axis, None) if self.wdm_axis \
                else P(None, None)

            def prog(bits, seeds, consts):
                full = self.fn(bits, seeds, consts)
                v, slots = full[:2]
                # eye metrology on a small gathered window + in-graph
                # THRESHOLD_EST + slicer + error count (the same
                # receiver as the unsharded LinkProgram.dsp).  The
                # window is re-laid-out time-replicated first — the XLA
                # CPU FFT thunk rejects the strided layout a sliced
                # sharded operand would otherwise carry.
                vw = jax.lax.with_sharding_constraint(
                    v[:, :W], NamedSharding(self.mesh, w_spec))

                def rx_one(v_c, slots_c, bits_c):
                    return _ook_rx_ingraph(v_c, slots_c, bits_c, sps,
                                           nslots, sps_resamp)

                m, rth, n_err = jax.vmap(rx_one)(vw, slots, bits)
                # replicate the per-channel scalars across the mesh so
                # EVERY process can device_get them — required for the
                # multi-process (DCN) runs of tests/test_multihost.py,
                # free single-process (tiny allgather of scalars)
                rep = NamedSharding(self.mesh, P())
                return jax.tree_util.tree_map(
                    lambda a: jax.lax.with_sharding_constraint(a, rep),
                    (m, rth, n_err, full[-1]))

            self._dsp_cache[key] = jax.jit(prog)
        return self._dsp_cache[key]

    def dsp(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = 128):
        """Fully-fused sharded OOK receiver: chain -> GET_EYE ->
        THRESHOLD_EST -> slicer -> BER, scalars-only readback."""
        if self.n_wdm > 1:
            raise ValueError(
                f"dsp() is single-channel but the mesh has a "
                f"'{self.wdm_axis}' axis of size {self.n_wdm}; use "
                f"dsp_wdm(n_channels=k*{self.n_wdm}) or a mesh with "
                "only a time axis")
        r = self.dsp_wdm(1, bits=None if bits is None else
                         np.atleast_2d(np.asarray(bits)), seed=seed,
                         prbs_order=prbs_order, nslots=nslots,
                         sps_resamp=sps_resamp)
        from .eyediag import Eye
        eye_kw = {k: (v[0] if isinstance(v, np.ndarray) else v)
                  for k, v in r.eye_fields.items()}
        # NaN -> None normalization, matching LinkProgram.dsp (a
        # degenerate eye reads the same whether or not a mesh was used)
        for k in ("threshold", "y_left", "y_right"):
            if eye_kw.get(k) is not None and np.isnan(eye_kw[k]):
                eye_kw[k] = None
        eye_kw["dt"] = 1.0 / self.params.fs
        return SimpleNamespace(
            ber=float(r.ber[0]), n_errors=int(r.n_errors[0]),
            threshold=float(r.threshold[0]), eye=Eye(eye_kw), tx=r.tx[0],
            rin_ok=bool(r.rin_ok[0]))

    def dsp_wdm_ppm(self, n_channels: int, M: int, decision: str = "soft",
                    bits=None, seed: int = 0, prbs_order: int = 15,
                    nslots: int = 8192, sps_resamp: Optional[int] = None):
        """M-PPM WDM sweep on the mesh: sharded chains + fused receivers,
        the sharded twin of :meth:`LinkProgram.dsp_wdm_ppm`.

        * ``decision="soft"``: per-symbol SDD argmax -> decode -> BER.
        * ``decision="hard"``: per-channel eye metrology on the gathered
          PD-voltage window (the same machinery :meth:`dsp_wdm` uses) ->
          KDE/scan threshold -> slicer -> keyed HDD repair -> decode ->
          BER (:func:`opticomlib_tpu.link._ppm_hard_rx_ingraph` vmapped
          over the channel axis)."""
        from .models.ppm import (PPM_ENCODER, positions_to_bits_jax,
                                 sdd_positions_jax)

        decision = decision.lower()
        if decision not in ("soft", "hard"):
            raise ValueError('`decision` must be "hard" or "soft"')
        if M & (M - 1) != 0 or M < 2:
            raise ValueError("`M` must be a power of 2.")
        if self.n_bits % M != 0:
            raise ValueError(
                f"link carries {self.n_bits} slots, not a multiple of "
                f"M={M}")
        k = int(math.log2(M))
        n_sym = self.n_bits // M
        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=n_channels * n_sym * k)
            bits = np.asarray(b.data, np.uint8).reshape(n_channels,
                                                        n_sym * k)
        bits = np.asarray(bits)
        if bits.shape != (n_channels, n_sym * k):
            raise ValueError(
                f"bits must have shape {(n_channels, n_sym * k)}, got "
                f"{bits.shape}")
        slots_tx = np.stack([
            np.asarray(PPM_ENCODER(bits[c], M).data, np.float32)
            for c in range(n_channels)])

        i_spec = (P(self.wdm_axis, None) if self.wdm_axis
                  else P(None, None))
        key = ("ppm", n_channels, M, decision, nslots, sps_resamp)
        if key not in self._dsp_cache:
            sps = self.params.sps
            W = min(nslots, self.n_bits) * sps

            def prog(slots_in, info, seeds, consts):
                full = self.fn(slots_in, seeds, consts)
                v, slot_samp = full[:2]
                # per-symbol argmax / slicer wants whole symbols local:
                # re-lay the (small) slot stream channel-sharded only
                ss = jax.lax.with_sharding_constraint(
                    slot_samp, NamedSharding(self.mesh, i_spec))

                rep = NamedSharding(self.mesh, P())

                def _replicated(out):
                    # scalars visible to every process (multi-host
                    # device_get; see _dsp_program)
                    return jax.tree_util.tree_map(
                        lambda a: jax.lax.with_sharding_constraint(
                            a, rep), out)

                if decision == "soft":
                    def one(s_c, i_c):
                        pos = sdd_positions_jax(s_c, M)
                        rb = positions_to_bits_jax(pos, M)
                        n_err = jnp.sum(rb != i_c.astype(jnp.uint8))
                        return jnp.full((), jnp.nan, jnp.float32), n_err

                    return _replicated(jax.vmap(one)(ss, info)
                                       + (full[-1],))

                # hard: eye metrology on a small channel-sharded gathered
                # voltage window (same re-layout as _dsp_program)
                vw = jax.lax.with_sharding_constraint(
                    v[:, :W], NamedSharding(self.mesh, i_spec))

                def one(v_c, s_c, i_c, seed_c):
                    _, rth, n_err = _ppm_hard_rx_ingraph(
                        v_c, s_c, i_c, M, sps, nslots, sps_resamp,
                        seed_c)
                    return rth, n_err

                return _replicated(jax.vmap(one)(vw, ss, info, seeds)
                                   + (full[-1],))

            self._dsp_cache[key] = jax.jit(prog)

        seeds = np.arange(n_channels, dtype=np.uint32) + np.uint32(seed)
        slots_d, seeds_d = self._place(slots_tx, seeds)
        info_d = jax.device_put(
            jnp.asarray(bits.astype(np.float32)),
            NamedSharding(self.mesh, i_spec))
        rth, n_err, rin_ok = jax.device_get(self._dsp_cache[key](
            slots_d, info_d, seeds_d, self.consts))
        n_err = np.asarray(n_err).astype(np.int64)
        rth = np.asarray(rth, np.float64)
        rin_ok = np.asarray(rin_ok) > 0
        if not rin_ok.all():
            _warn_rin(np.flatnonzero(~rin_ok).tolist())
        return SimpleNamespace(ber=n_err / (n_sym * k), n_errors=n_err,
                               M=M, decision=decision,
                               n_channels=n_channels,
                               threshold=(None if np.isnan(rth).all()
                                          else rth),
                               tx=bits.astype(np.uint8), rin_ok=rin_ok)

    def dsp_wdm(self, n_channels: int, bits=None, seed: int = 0,
                prbs_order: int = 15, nslots: int = 8192,
                sps_resamp: Optional[int] = None):
        """WDM sweep with per-channel fused receivers over the mesh:
        channels shard over ``'wdm'``, every channel's waveform shards
        over ``'time'`` (BASELINE config 5 through the public API)."""
        if n_channels < 1:
            raise ValueError("n_channels must be >= 1")
        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=n_channels * self.n_bits)
            bits = np.asarray(b.data, np.uint8).reshape(
                n_channels, self.n_bits)
        bits = np.asarray(bits)
        if bits.shape != (n_channels, self.n_bits):
            raise ValueError(
                f"bits must have shape {(n_channels, self.n_bits)}, got "
                f"{bits.shape}")
        seeds = np.arange(n_channels, dtype=np.uint32) + np.uint32(seed)
        prog = self._dsp_program(n_channels, nslots, sps_resamp)
        bits_d, seeds_d = self._place(bits.astype(np.float32), seeds)
        m, rth, n_err, rin_ok = jax.device_get(
            prog(bits_d, seeds_d, self.consts))
        n_err = np.asarray(n_err).astype(np.int64)
        rin_ok = np.asarray(rin_ok) > 0
        if not rin_ok.all():
            _warn_rin(np.flatnonzero(~rin_ok).tolist())
        return SimpleNamespace(
            ber=n_err / self.n_bits, n_errors=n_err,
            threshold=np.asarray(rth),
            mu0=m["mu0"], mu1=m["mu1"], s0=m["s0"], s1=m["s1"],
            er=m["er"], eye_h=m["eye_h"], eye_fields=m,
            n_channels=n_channels, tx=bits.astype(np.uint8),
            rin_ok=rin_ok)
