"""Sharded split-step Fourier propagation over a device mesh.

The new capability the reference never had (it is single-process NumPy/CuPy,
reference devices.py:1114-1134): scale the NLSE solve across devices by
sharding

* the **time (sample) axis** — the optical-simulation analogue of
  sequence/context parallelism.  Each device owns a contiguous block of the
  waveform; the nonlinear (pointwise) steps need no communication; the
  dispersion steps use blockwise overlap-save with ring halo exchange
  (``ppermute`` between neighbor devices) — see :mod:`opticomlib_tpu.parallel.halo` for the
  derivation of the halo width;
* the **WDM channel axis** — embarrassingly parallel (data-parallel
  analogue), a leading array dimension sharded over the 'wdm' mesh axis.

The sharded fixed-step kernel produces the same waveform as the
single-device :func:`opticomlib_tpu.ops.ssfm.ssfm_propagate` up to the
overlap-save truncation error (tested to ~1e-4 relative on an 8-device CPU
mesh in tests/test_parallel.py).
"""
from __future__ import annotations

import math
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.ssfm import (adaptive_h0, alpha_per_km, dispersion_phase,
                        _lin_factor, ssfm_step_schedule, ssfm_while_inside)
from .dfft import pencil_fft, pencil_ifft, strided_w_grid
from .halo import exchange_halos, halo_width

__all__ = ["make_link_mesh", "ssfm_sharded", "shard_waveform",
           "resolve_shard_method", "AUTO_HALO_FRAC"]

# 'auto' picks overlap-save only when the per-step halo fraction
# (2H/block) is at most this threshold.  MEASURED value
# (scripts/bench_shard_crossover.py -> CROSSOVER.json, 8-device mesh,
# 2^20-2^22 x {config2, config4-span}): overlap never beat the pencil
# FFT on this mesh — it ran at 0.38-0.53x pencil's speed even at halo
# fractions of 0.001-0.002, because the mesh's all_to_all is
# shared-memory-cheap while overlap pays a padded local FFT — so the
# measured threshold is 0.0 and 'auto' resolves to the exact pencil
# transform unless pencil is infeasible.  On GPUs, where all_to_all
# crosses NVLink, the crossover can move (not measured on the H100 yet):
# re-measure with `bench_shard_crossover.py --devices` and set
# OPTICOMLIB_TPU_AUTO_HALO_FRAC to the measured value.
AUTO_HALO_FRAC = float(os.environ.get(
    "OPTICOMLIB_TPU_AUTO_HALO_FRAC", "0.0"))


def resolve_shard_method(n: int, n_time: int, h, beta_2: float,
                         beta_3: float, fs: float,
                         halo_safety: float = 4.0,
                         adaptive: bool = False) -> str:
    """Resolve ``shard_method='auto'`` to 'pencil' or 'overlap' from the
    structural cost ratio ``2H/block`` (halo samples per side over block
    length) against the MEASURED crossover threshold
    :data:`AUTO_HALO_FRAC`.

    Adaptive stepping always resolves to 'pencil': its worst-case halo
    must be sized from a host readback of the input power (a launch
    sync the pencil path never pays) and padded 4x harder because the
    truncation error feeds back through the step controller.  Fixed-
    step runs pick overlap-save only when the halo fraction is within
    the measured threshold and the block admits it; pencil whenever its
    exactness is free or overlap is infeasible.
    """
    block = n // n_time
    pencil_ok = block % n_time == 0
    if adaptive or h is None:
        return "pencil" if pencil_ok else "overlap"
    H = halo_width(float(h), beta_2, beta_3, fs, safety=halo_safety)
    if 2 * H >= block:          # overlap infeasible
        return "pencil"
    if not pencil_ok:           # pencil infeasible (n % n_time^2 != 0)
        return "overlap"
    return "overlap" if 2 * H / block <= AUTO_HALO_FRAC else "pencil"


def make_link_mesh(n_wdm: int = 1, n_time: Optional[int] = None,
                   devices=None) -> Mesh:
    """Build a ('wdm', 'time') device mesh.

    ``n_time`` defaults to ``len(devices) // n_wdm`` so all devices are used.
    """
    devices = devices if devices is not None else jax.devices()
    if n_time is None:
        n_time = len(devices) // n_wdm
    n = n_wdm * n_time
    if n > len(devices):
        raise ValueError(
            f"mesh {n_wdm}x{n_time} needs {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(n_wdm, n_time)
    return Mesh(dev_array, axis_names=("wdm", "time"))


def shard_waveform(A: np.ndarray, mesh: Mesh, wdm_axis: Optional[str] = "wdm"):
    """Place a (channels, nsamples) or (nsamples,) array on the mesh with
    channels over ``wdm_axis`` (None -> replicated leading axis) and
    samples over 'time'."""
    if A.ndim == 1:
        spec = P("time")
    else:
        spec = P(wdm_axis, "time")
    return jax.device_put(A, NamedSharding(mesh, spec))


def _overlap_propagate_fn(phi_pad, a_km: float, H: int, gamma: float,
                          axis_name: str):
    """Blockwise overlap-save propagation over a fixed step schedule.

    Dispersion is a real phase array + scalar loss (see ops/ssfm.py
    ``dispersion_phase``); the linear factor for the schedule's leading step
    is computed once *outside* the scan, so off-schedule steps (at most the
    final remainder) pay the cos/sin recompute."""
    gamma = jnp.float32(gamma)
    alpha = jnp.float32(a_km)

    def propagate(x, hs):
        h0 = hs[0]
        E0 = _lin_factor(phi_pad, alpha, h0)

        def step(x, h):
            # half nonlinear step (pointwise, no comms) — operator frozen
            # at step start, matching reference devices.py:1172-1196
            phi = (gamma * (h / 2)) * (x.real * x.real + x.imag * x.imag)
            half_nl = jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
            x = x * half_nl
            # linear step: overlap-save with ring halos (circular semantics)
            E = jax.lax.cond(h == h0, lambda: E0,
                             lambda: _lin_factor(phi_pad, alpha, h))
            xp = exchange_halos(x, H, axis_name)
            Xp = jnp.fft.fft(xp, axis=-1)
            xp = jnp.fft.ifft(Xp * E, axis=-1)
            x = xp[..., H:-H]
            return x * half_nl, None

        y, _ = jax.lax.scan(step, x, hs)
        return y

    return propagate


def _pencil_propagate_fn(n_time: int, block: int, fs: float, alpha: float,
                         beta_2: float, beta_3: float, gamma: float,
                         axis_name: str):
    """Propagation with an *exact* distributed FFT per linear step (pencil
    transpose, see parallel/dfft.py).  The linear operator is sampled on the
    strided spectrum layout each device owns after ``pencil_fft``; the
    per-device phase grid and leading-step factor live outside the scan."""
    gamma = jnp.float32(gamma)
    alpha_lin = jnp.float32(alpha_per_km(alpha))

    def propagate(x, hs):
        q = jax.lax.axis_index(axis_name)
        w = strided_w_grid(q, n_time, block, fs) * 1e-12  # rad/ps
        phi_q = (beta_2 / 2 * w**2 + beta_3 / 6 * w**3).astype(jnp.float32)
        h0 = hs[0]
        E0 = _lin_factor(phi_q, alpha_lin, h0)

        def step(x, h):
            phi = (gamma * (h / 2)) * (x.real * x.real + x.imag * x.imag)
            half_nl = jax.lax.complex(jnp.cos(phi), jnp.sin(phi))
            x = x * half_nl
            E = jax.lax.cond(h == h0, lambda: E0,
                             lambda: _lin_factor(phi_q, alpha_lin, h))
            X = pencil_fft(x, axis_name)
            x = pencil_ifft(X * E, axis_name)
            return x * half_nl, None

        y, _ = jax.lax.scan(step, x, hs)
        return y

    return propagate


from collections import OrderedDict

_prog_cache: "OrderedDict" = OrderedDict()
_PROG_CACHE_MAX = 32  # LRU bound: adaptive-overlap keys include the
# power-derived halo step, so unbounded sweeps would leak executables


def _prog_cache_put(key, prog):
    _prog_cache[key] = prog
    _prog_cache.move_to_end(key)
    while len(_prog_cache) > _PROG_CACHE_MAX:
        _prog_cache.popitem(last=False)


def ssfm_sharded(
    A,
    mesh: Mesh,
    fs: float,
    length: float,
    alpha: float = 0.0,
    beta_2: float = 0.0,
    beta_3: float = 0.0,
    gamma: float = 0.0,
    h: Optional[float] = 1.0,
    phi_max: float = 0.01,
    method: str = "pencil",
    halo_safety: float = 4.0,
    time_axis: str = "time",
    wdm_axis: Optional[str] = "wdm",
    ckpt_dir: Optional[str] = None,
    segment_km: Optional[float] = None,
    scheme: str = "reference",
    tol: float = 1e-5,
):
    """Propagate a sharded waveform through ``length`` km of fiber.

    ``scheme`` selects the splitting scheme (mirrors
    ``devices.FIBER(method=)``): ``"reference"`` (default — the 2nd-order
    frozen-operator step, phi_max-adaptive or fixed ``h``), ``"o4"``
    (4th-order Yoshida: fixed-schedule with ``h``, self-tuning
    step-doubling control at ``tol`` with ``h=None``), or
    ``"local_error"`` (Sinkin adaptive stepping at ``tol``).  The
    higher-order schemes run on the pencil-FFT path with their error
    norms all-reduced over the mesh, so every device agrees on the step
    sequence; they are not available with ``method='overlap'`` (the
    halo width is derived for the reference step).  Checkpointing
    composes with every scheme (the scheme is part of the config
    fingerprint; the self-tuning controllers restart per segment).

    ``A``: (nsamples,) or (channels, nsamples) complex array (host or
    already device_put with the matching sharding).  Returns a sharded
    jax.Array with the same shape.

    ``h``: fixed step [km], or ``None`` for **phi_max-adaptive stepping**
    (the reference criterion, devices.py:1156/1193-1196): the per-step
    ``max|A|^2`` becomes an all-reduce(max) over every mesh axis
    (``jax.lax.pmax``), so all shards advance with one global step size —
    exactly matching the single-device adaptive result.

    ``method``:
      * ``"pencil"`` (default) — exact distributed FFT per linear step
        (2 all_to_all per transform; matches the single-device result to
        float32 round-off);
      * ``"overlap"`` — blockwise overlap-save with ring halo exchange
        (ppermute only; cheaper on the interconnect but approximate — the
        truncation error decays ~1/H^2 in the halo width).

    ``ckpt_dir``: checkpoint/resume (SURVEY §5.4).  The span is run in
    segments of ``segment_km`` (default: the whole span), the field
    saved after each segment (atomic versioned npz via
    :class:`opticomlib_tpu.runtime.PropagationCheckpointer`); a rerun
    with the same directory and physics resumes from the latest
    checkpoint and reproduces the uninterrupted segmented run
    bit-for-bit (adaptive stepping re-probes h0 at each segment
    boundary in both cases).

    Compiled programs are cached per (mesh devices, shape, physics,
    method) — repeated calls with the same configuration re-trace
    nothing.
    """
    if scheme not in ("reference", "o4", "local_error"):
        raise ValueError(
            "scheme must be 'reference', 'o4' or 'local_error'")
    if scheme != "reference":
        if method == "overlap":
            raise ValueError(
                f"scheme='{scheme}' needs the exact pencil-FFT path "
                "(method='pencil' or 'auto'); the overlap halo width is "
                "derived for the reference step")
        method = "pencil"
    if ckpt_dir is not None:
        return _ssfm_sharded_resumable(
            A, mesh, fs, length, alpha, beta_2, beta_3, gamma, h,
            phi_max, method, halo_safety, time_axis, wdm_axis,
            ckpt_dir, segment_km, scheme=scheme, tol=tol)
    A = jnp.asarray(A, dtype=jnp.complex64)
    n = A.shape[-1]
    n_time = mesh.shape[time_axis]
    if n % n_time:
        raise ValueError(f"nsamples {n} not divisible by time shards {n_time}")
    block = n // n_time

    adaptive = h is None
    if adaptive and gamma == 0:
        # linear-only: single step over the whole span (reference h0=length)
        h, adaptive = length, False
    if method == "auto":
        method = resolve_shard_method(
            n, n_time, None if adaptive else min(float(h), float(length)),
            beta_2, beta_3, fs, halo_safety=halo_safety,
            adaptive=adaptive)
    if adaptive:
        if method == "overlap":
            # worst-case adaptive step (sizes the overlap halo):
            # maxP(z) >= maxP0 * e^(-alpha*L), so h(z) <= h0 * e^(+alpha*L).
            # This is the only place the input must be read back to host —
            # the pencil path never does, so its cache hits launch sync-free.
            maxP0_host = float(jnp.max(A.real**2 + A.imag**2))
            h0_host = adaptive_h0(phi_max, gamma, maxP0_host, length)
            h_for_halo = min(length,
                             h0_host * math.exp(alpha_per_km(alpha) * length))
        else:
            h_for_halo = None
    else:
        h_for_halo = h
    hs = ssfm_step_schedule(length, h if not adaptive else length)

    # collectives: the adaptive max reduction must see every shard of the
    # waveform — both time blocks and (independent-channel parity with the
    # single-device reference, which maxes over the whole array) channels
    axes = ((time_axis,) if A.ndim == 1 or wdm_axis is None
            else (wdm_axis, time_axis))

    def reduce_max(m):
        for ax in axes:
            m = jax.lax.pmax(m, ax)
        return m

    cache_key = (tuple(mesh.axis_names),
                 tuple(d.id for d in mesh.devices.flat),
                 A.shape, method, float(fs), float(length), float(alpha),
                 float(beta_2), float(beta_3), float(gamma), h, adaptive,
                 float(phi_max), float(halo_safety), time_axis, wdm_axis,
                 scheme, float(tol),
                 (round(float(h_for_halo), 9)
                  if method == "overlap" else None))
    prog = _prog_cache.get(cache_key)
    if prog is not None:
        _prog_cache.move_to_end(cache_key)
        return prog(A)

    if method == "pencil":
        if block % n_time:
            raise ValueError(
                f"pencil FFT needs block ({block}) divisible by time shards "
                f"({n_time}) — i.e. nsamples divisible by n_time^2")
        propagate = _pencil_propagate_fn(n_time, block, fs, alpha, beta_2,
                                         beta_3, gamma, time_axis)
        if adaptive:
            alpha_lin = alpha_per_km(alpha)

            def propagate(x, _hs):  # noqa: F811 - adaptive variant
                q = jax.lax.axis_index(time_axis)
                w = strided_w_grid(q, n_time, block, fs) * 1e-12
                phi_q = (beta_2 / 2 * w**2
                         + beta_3 / 6 * w**3).astype(jnp.float32)

                def linear_step(a, hh):
                    E = _lin_factor(phi_q, jnp.float32(alpha_lin), hh)
                    return pencil_ifft(pencil_fft(a, time_axis) * E,
                                       time_axis)

                maxP0 = reduce_max(jnp.max(x.real**2 + x.imag**2))
                h0 = jnp.minimum(
                    jnp.float32(phi_max) / (jnp.abs(jnp.float32(gamma))
                                            * maxP0), jnp.float32(length))
                y, _ = ssfm_while_inside(
                    x, None, length, gamma, phi_max, h0, alpha_lin,
                    adaptive=True, reduce_max=reduce_max,
                    linear_step=linear_step)
                return y
        if scheme != "reference":
            from ..ops.ssfm import (ssfm_local_error_inside,
                                    ssfm_o4_auto_inside,
                                    ssfm_o4_scan_inside)

            alpha_lin = alpha_per_km(alpha)

            def propagate(x, hs_in):  # noqa: F811 - scheme variants
                q = jax.lax.axis_index(time_axis)
                w = strided_w_grid(q, n_time, block, fs) * 1e-12
                phi_q = (beta_2 / 2 * w**2
                         + beta_3 / 6 * w**3).astype(jnp.float32)

                def spectral(a, E):
                    return pencil_ifft(pencil_fft(a, time_axis) * E,
                                       time_axis)

                def reduce_sum(s):
                    for ax in axes:
                        s = jax.lax.psum(s, ax)
                    return s

                if scheme == "o4" and h is not None:
                    return ssfm_o4_scan_inside(
                        x, phi_q, hs_in, jnp.float32(gamma),
                        jnp.float32(alpha_lin), spectral=spectral)
                fn = (ssfm_o4_auto_inside if scheme == "o4"
                      else ssfm_local_error_inside)
                # a user-supplied h acts as the initial step h0, same
                # as the unsharded ssfm_local_error (review fix: it was
                # silently dropped on the mesh path)
                h0 = min(float(h), float(length)) if h is not None \
                    else float(length) / 10.0
                y, _ = fn(x, phi_q, jnp.float32(length),
                          jnp.float32(gamma), jnp.float32(tol),
                          jnp.float32(h0), jnp.float32(alpha_lin),
                          reduce_sum=reduce_sum, spectral=spectral)
                return y
    elif method == "overlap":
        # adaptive mode: truncation error feeds back through the step
        # controller (h depends on max|A|^2, which halo error perturbs),
        # so pad the halo harder than the fixed-step case
        eff_safety = halo_safety * (4.0 if adaptive else 1.0)
        H = halo_width(float(min(h_for_halo, length)), beta_2, beta_3, fs,
                       safety=eff_safety)
        if 2 * H >= block:
            raise ValueError(
                f"halo {H} too large for block {block}; increase samples per "
                f"device or reduce step size")
        # dispersion phase on the padded-block grid
        w_pad = 2 * np.pi * np.fft.fftfreq(block + 2 * H) * fs
        phi_pad = jnp.asarray(dispersion_phase(w_pad, beta_2, beta_3))
        if adaptive:
            alpha_lin = alpha_per_km(alpha)

            def propagate(x, _hs):
                def linear_step(a, hh):
                    E = _lin_factor(phi_pad, jnp.float32(alpha_lin), hh)
                    ap = exchange_halos(a, H, time_axis)
                    ap = jnp.fft.ifft(jnp.fft.fft(ap, axis=-1) * E, axis=-1)
                    return ap[..., H:-H]

                maxP0 = reduce_max(jnp.max(x.real**2 + x.imag**2))
                h0 = jnp.minimum(
                    jnp.float32(phi_max) / (jnp.abs(jnp.float32(gamma))
                                            * maxP0), jnp.float32(length))
                y, _ = ssfm_while_inside(
                    x, None, length, gamma, phi_max, h0, alpha_lin,
                    adaptive=True, reduce_max=reduce_max,
                    linear_step=linear_step, h_max=h_for_halo)
                return y
        else:
            propagate = _overlap_propagate_fn(phi_pad, alpha_per_km(alpha),
                                              H, gamma, time_axis)
    else:
        raise ValueError("method must be 'pencil' or 'overlap'")

    if A.ndim == 1:
        in_spec = out_spec = P(time_axis)
    else:
        in_spec = out_spec = P(wdm_axis, time_axis)

    @partial(shard_map, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec,
             check_vma=False)
    def run(x):
        return propagate(x, jnp.asarray(hs))

    prog = _prog_cache.get(cache_key)
    if prog is None:
        prog = jax.jit(run)
        _prog_cache_put(cache_key, prog)
    return prog(A)


def _ssfm_sharded_resumable(A, mesh, fs, length, alpha, beta_2, beta_3,
                            gamma, h, phi_max, method, halo_safety,
                            time_axis, wdm_axis, ckpt_dir, segment_km,
                            scheme="reference", tol=1e-5):
    """Segmented sharded propagation with checkpoint/resume (SURVEY §5.4;
    VERDICT round-2 item 7).  Each segment is one cached jitted sharded
    program; the field is gathered and saved after every segment.  A
    rerun with the same directory+physics resumes from the latest valid
    checkpoint — the resumed output is bit-identical to the
    uninterrupted segmented run (both re-probe the adaptive h0 at each
    segment boundary from the same field).

    Multi-host safe: with >1 JAX process each host writes only its
    addressable shards (``shard=process_index`` files, the standard
    per-host checkpoint pattern) and resumes by reassembling a global
    array from them — the global field is never gathered to one host."""
    from ..runtime.checkpoint import PropagationCheckpointer

    seg = float(segment_km) if segment_km else float(length)
    nproc = jax.process_count()
    shape = tuple(A.shape)
    ndim = len(shape)
    cfg = dict(kind="ssfm_sharded", n=list(shape), fs=fs, length=length,
               alpha=alpha, beta_2=beta_2, beta_3=beta_3, gamma=gamma,
               h=h, phi_max=phi_max, method=method, segment_km=seg,
               halo_safety=halo_safety, time_axis=time_axis,
               wdm_axis=wdm_axis, scheme=scheme, tol=tol,
               mesh=[list(mesh.axis_names),
                     [int(d.id) for d in mesh.devices.flat]])
    ck = PropagationCheckpointer(
        ckpt_dir, config=cfg,
        shard=jax.process_index() if nproc > 1 else None)
    sharding = NamedSharding(
        mesh, P("time") if ndim == 1
        else P(None if wdm_axis is None else wdm_axis, "time"))

    state = ck.latest() if nproc == 1 else _multihost_agreed_state(ck)
    if state is not None:
        step, z, re, im, extra = state
        if nproc == 1:
            A = shard_waveform(
                np.asarray(re + 1j * im, dtype=np.complex64), mesh,
                wdm_axis=None if ndim == 1 else wdm_axis)
        else:
            A = _assemble_from_host_shards(re, im, extra["indices"],
                                           shape, sharding)
    else:
        step, z = 0, 0.0
        if isinstance(A, jax.Array) and not A.is_fully_addressable:
            A = jax.device_put(A, sharding)  # already global: just re-lay
        else:
            A = shard_waveform(
                np.asarray(jnp.asarray(A, dtype=jnp.complex64)), mesh,
                wdm_axis=None if ndim == 1 else wdm_axis)
    while z < length - 1e-9:
        this = min(seg, length - z)
        A = ssfm_sharded(A, mesh, fs, this, alpha=alpha, beta_2=beta_2,
                         beta_3=beta_3, gamma=gamma, h=h, phi_max=phi_max,
                         method=method, halo_safety=halo_safety,
                         time_axis=time_axis, wdm_axis=wdm_axis,
                         scheme=scheme, tol=tol)
        z += this
        step += 1
        if nproc == 1:
            A_host = np.asarray(A)
            ck.save(step, z, A_host.real, A_host.imag)
        else:
            blocks, indices = _host_shard_blocks(A)
            ck.save(step, z, blocks.real, blocks.imag,
                    extra={"indices": indices})
    return A


def _multihost_agreed_state(ck):
    """Resume state all processes AGREE on (nproc > 1).

    Each process independently keeps its own shard checkpoints; a crash
    between per-host saves — or one host silently falling back past a
    corrupt file — leaves hosts with different latest steps, and the
    subsequent shard_map segments would silently combine shards
    propagated to different distances.  So before resuming, every
    process gathers the set of steps it can actually load (corrupt
    files excluded by a real load attempt) and all resume from the
    **highest step available on every host** — or from scratch when no
    common step exists.
    """
    from jax.experimental import multihost_utils

    keep = ck.keep
    mine = [s for s in ck._steps() if ck.load(s) is not None][-keep:]
    vec = np.full(keep, -1, np.int64)
    vec[:len(mine)] = mine
    rows = np.asarray(multihost_utils.process_allgather(vec))
    sets = [set(int(x) for x in row if x >= 0) for row in rows]
    common = set.intersection(*sets) if sets else set()
    if not common:
        return None
    return ck.load(max(common))


def _host_shard_blocks(A):
    """This host's addressable shards of a global array, stacked in a
    deterministic order, plus their global index bounds (JSON-friendly)."""
    def bounds(idx):
        return [[0 if s.start is None else int(s.start),
                 int(s.stop) if s.stop is not None else -1] for s in idx]

    shards = sorted(A.addressable_shards, key=lambda s: bounds(s.index))
    # deduplicate replicated placements (same global slice on >1 local device)
    seen, blocks, indices = set(), [], []
    for s in shards:
        key = tuple(map(tuple, bounds(s.index)))
        if key in seen:
            continue
        seen.add(key)
        blocks.append(np.asarray(s.data))
        indices.append(bounds(s.index))
    return np.stack(blocks), indices


def _assemble_from_host_shards(re, im, indices, shape, sharding):
    """Rebuild a global sharded array from this host's checkpointed
    blocks (inverse of :func:`_host_shard_blocks`)."""
    by_index = {tuple(map(tuple, idx)): re[k] + 1j * im[k]
                for k, idx in enumerate(indices)}
    arrays = []
    for dev, idx in sharding.addressable_devices_indices_map(shape).items():
        key = tuple((0 if s.start is None else int(s.start),
                     int(s.stop) if s.stop is not None else -1)
                    for s in idx)
        block = np.asarray(by_index[key], dtype=np.complex64)
        arrays.append(jax.device_put(block, dev))
    return jax.make_array_from_single_device_arrays(shape, sharding, arrays)
