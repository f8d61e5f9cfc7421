"""Fused end-to-end link: the whole TX -> channel -> RX chain as ONE XLA
program.

The reference's canonical entry point is the staged chain
(reference examples/ook_transmission_fiber_simulation.py:27-67:
PRBS -> DAC -> LASER -> MZM -> FIBER -> PD -> DSP), where every stage is a
separate host call.  Here the *entire* chain compiles into a single jitted
program with planar float32 boundaries: bits in, filtered photodiode
voltage (+ slot samples) out.  Between the input and the output nothing
touches the host — pulse shaping, modulation, split-step propagation,
amplification, detection, and electrical filtering are one fused XLA
graph, and every noise source draws from ``jax.random`` keys threaded
in-graph (see :mod:`opticomlib_tpu.rng`), so a single ``seed`` scalar
reproduces the full waveform.

Design notes (differences from the staged device path, all deliberate):

* **Circular convolution boundaries.**  DAC pulse shaping and the PD's
  electrical low-pass are applied as length-``n`` circular (FFT-domain)
  convolutions — the same boundary semantics the FFT-based fiber solver
  already has (reference devices.py:1179) — instead of zero-padded
  'same' convolutions.  Only the first/last ~pulse-span slots differ.
* **Physical ASE.**  EDFA noise is *added to the propagating field* (and
  detected square-law at the PD), rather than carried on the reference's
  separate algebraic noise track (reference devices.py:1460-1479).  The
  signal-ASE / ASE-ASE beat terms arise physically in ``|E|^2``.  Both
  polarizations are carried after the first EDFA (the orthogonal-pol ASE
  adds direct-detected power and ASE-ASE beat exactly as in the
  reference's 2-pol model).
* **Key threading matches the staged devices.**  The in-graph key stream
  replicates ``gv(seed=...)`` + per-device ``rng.resolve()`` consumption
  order, so a fused run with ``seed=s`` draws bit-identical noise to the
  staged chain seeded with ``gv(seed=s)`` (tested in tests/test_link.py).

Typical use::

    from opticomlib_tpu.link import LinkSpec, FiberSpec, EDFASpec, build_link
    spec = LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                    pulse_shape="gaussian", stages=(
                        FiberSpec(length=50, alpha=0.2, beta_2=-21, gamma=1.3),
                        EDFASpec(G=10, NF=5),
                    ), pd_BW=7.5e9)
    prog = build_link(spec, n_bits=2**16)        # compiles once
    res = prog.run(seed=42)                       # PRBS -> ... -> RX
    ber = res.ber()                               # eye-threshold decision

Round-3 stage vocabulary (all in-graph): ``DMSpec`` (dispersion
compensation), ``BPFSpec``, ``DBPSpec`` (back-propagation with
``undo_gain_dB``), ``EDFASpec(NF=None)`` (noiseless gain/attenuator)
with optional output ``BW``, and ``RepeatSpec(n, stages)`` — N
identical spans lowered to ONE ``lax.scan``.  ``modulator="pm"``
selects a phase modulator; ``adc_bits`` adds an in-graph ADC.  Pass
``mesh=`` to :func:`build_link` for the SHARDED fused link
(:mod:`opticomlib_tpu.link_sharded`).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from scipy.constants import e, k as kB, pi

from .ops import filters, pulses, ssfm
from .ops.eyeana import _shortest_int_masked, eye_metrics_jax
from .ops.noise import ase_sigma, gaussian_inside, wiener_phase_inside
from .params import SimParams, gv
from .signals import BinarySequence, ElectricalSignal
from .utils.analysis import idb, idbm

__all__ = ["FiberSpec", "DBPSpec", "EDFASpec", "DMSpec", "BPFSpec",
           "RepeatSpec", "LinkSpec", "LinkProgram", "build_link"]




# ---------------------------------------------------------------------------
# channel stage specs
# ---------------------------------------------------------------------------
_EYE_TRACE_KEYS = ("y", "t", "y_top", "y_bot", "y_25_75")


def _warn_rin(bad_channels=None):
    """One shared RuntimeWarning for clamped RIN draws (``rin_ok == 0``):
    the fused/sharded programs clamp ``1+rin`` at 0 where the staged
    LASER — like the reference (devices.py:492-500) — raises per draw.
    ``bad_channels``: optional indices for the multi-channel surfaces."""
    where = ("" if bad_channels is None
             else f" on channel(s) {list(bad_channels)}")
    warnings.warn(
        f"RIN draw crossed -1 and was clamped to dark{where} (the "
        "staged LASER raises here, reference devices.py:492-500); "
        "decrease `rin` or change the seed.", RuntimeWarning,
        stacklevel=3)


def _adc_quantize(v, bits: int):
    """In-graph ADC: uniform quantization over the robust 99.99%
    shortest-interval range (reference devices.py:1616-1627; the range
    estimator is the device twin of ``utils.analysis.shortest_int``).
    Shared by the fused and pipelined link builders so the operator
    cannot drift between paths."""
    lo, hi = _shortest_int_masked(v, jnp.ones(v.shape, bool), 99.99)
    nq = jnp.float32(2 ** int(bits) - 1)
    code = jnp.round((v - lo) / (hi - lo) * nq)
    return code / nq * (hi - lo) + lo


def _ook_rx_ingraph(v, slots, bits_f32, sps, nslots, sps_resamp,
                    trace_keys=_EYE_TRACE_KEYS):
    """In-graph OOK receiver: GET_EYE reductions -> THRESHOLD_EST ->
    slicer -> error count (device twin of models.ook.DSP +
    BER_analizer('counter'), reference ook.py:22-60, 63-132, 135-218).
    Shared by LinkProgram.dsp and LinkProgram.dsp_wdm (vmapped there)."""
    m = eye_metrics_jax(v, sps=sps, nslots=nslots, sps_resamp=sps_resamp)
    for k in trace_keys:
        m.pop(k, None)
    # THRESHOLD_EST (reference ook.py:22-60).  The scan runs in log
    # space — float32 Q underflows to a flat zero basin at high SNR,
    # which would degenerate the argmin; log(Q(x)) = log_ndtr(-x) stays
    # resolved arbitrarily deep, and argmin log(Q1+Q0) == argmin
    # 0.5*(Q1+Q0).
    r = jnp.linspace(m["mu0"], m["mu1"], 1000)
    lq1 = jax.scipy.special.log_ndtr(-(m["mu1"] - r) / m["s1"])
    lq0 = jax.scipy.special.log_ndtr(-(r - m["mu0"]) / m["s0"])
    rth = r[jnp.argmin(jnp.logaddexp(lq1, lq0))]
    rx = slots.real > rth
    n_err = jnp.sum(rx != (bits_f32 > 0.5))
    return m, rth, n_err


def _ppm_hard_rx_ingraph(v, slot_samp, info_bits_f32, M, sps, nslots,
                         sps_resamp, seed_u32,
                         trace_keys=_EYE_TRACE_KEYS):
    """In-graph hard-decision M-PPM receiver: GET_EYE reductions -> KDE
    threshold (falling back to the log-space M-PPM THRESHOLD_EST scan,
    reference ppm.py:261-305, where the KDE fails) -> slicer ->
    keyed-random HDD repair -> decode -> error count (device twin of
    ``models.ppm.DSP(decision='hard')`` + ``BER_analizer('counter')``,
    reference ppm.py:390-405, 419-577).  Shared by LinkProgram.dsp_ppm,
    dsp_wdm_ppm (vmapped there) and the sharded twin.  Returns
    (eye_scalars, rth, n_err)."""
    from .models.ppm import hdd_positions_jax, positions_to_bits_jax

    m = eye_metrics_jax(v, sps=sps, nslots=nslots, sps_resamp=sps_resamp)
    for tk in trace_keys:
        m.pop(tk, None)
    # M-PPM THRESHOLD_EST in log space: argmin 1 - Q((r-mu1)/s1) *
    # (1-Q((r-mu0)/s0))^(M-1) == argmax log Q((r-mu1)/s1) +
    # (M-1) log(1-Q((r-mu0)/s0)), with log Q(x) = log_ndtr(-x)
    r = jnp.linspace(m["mu0"], m["mu1"], 1000)
    log_a = (jax.scipy.special.log_ndtr((m["mu1"] - r) / m["s1"])
             + (M - 1) * jax.scipy.special.log_ndtr(
                 (r - m["mu0"]) / m["s0"]))
    rth_scan = r[jnp.argmax(log_a)]
    rth = jnp.where(jnp.isnan(m["threshold"]), rth_scan, m["threshold"])
    on = (jnp.real(slot_samp) > rth).astype(jnp.float32)
    # the reference repairs degenerate symbols with np.random draws
    # (ppm.py:184-190); here a per-slot keyed uniform score derived from
    # the link seed keeps the repair reproducible and schedule-free
    k_hdd = jax.random.fold_in(jax.random.PRNGKey(seed_u32), 0x504D)
    pos = hdd_positions_jax(on, M, k_hdd)
    rx_bits = positions_to_bits_jax(pos, M)
    n_err = jnp.sum(rx_bits != info_bits_f32.astype(jnp.uint8))
    return m, rth, n_err


@dataclass(frozen=True)
class FiberSpec:
    """One fiber span (same physics as :func:`opticomlib_tpu.devices.FIBER`,
    reference devices.py:1038-1206).

    ``method="o4"`` selects the 4th-order Yoshida composition for this
    span — the equal-accuracy lever: fewer FFT pairs than the reference
    scheme at matched output error once the target is tight (the
    matched step sizes are not calibrated on the H100 yet).  With a
    fixed ``h`` it runs the fixed-
    schedule scan; with ``h=None`` it **self-tunes** via step-doubling
    local-error control targeting relative local error ``tol`` per step
    (no calibration script needed; ops/ssfm.ssfm_o4_auto_inside).
    ``method="local_error"`` is the Sinkin adaptive 2nd-order scheme
    with Richardson extrapolation (same ``tol`` semantics).  The default
    ``"reference"`` is the reference's 2nd-order frozen-operator scheme.
    """
    length: float                 # [km]
    alpha: float = 0.0            # [dB/km]
    beta_2: float = 0.0           # [ps^2/km]
    beta_3: float = 0.0           # [ps^3/km]
    gamma: float = 0.0            # [1/W/km]
    phi_max: float = 0.01         # adaptive max NL phase [rad]
    h: Optional[float] = None     # fixed step [km]; None -> adaptive
    method: str = "reference"     # 'reference' | 'o4' | 'local_error'
    tol: float = 1e-5             # target relative local error per step
    # (o4 h=None and local_error; ignored by 'reference')

    def __post_init__(self):
        if self.length <= 0:
            raise ValueError("FiberSpec.length must be > 0 km")
        if self.phi_max <= 0:
            raise ValueError("FiberSpec.phi_max must be > 0")
        if self.h is not None and self.h <= 0:
            raise ValueError("FiberSpec.h must be > 0 km (or None)")
        if self.method not in ("reference", "o4", "local_error"):
            raise ValueError(
                "FiberSpec.method must be 'reference', 'o4' or "
                "'local_error'")
        if self.tol <= 0:
            raise ValueError("FiberSpec.tol must be > 0")
        if self.method == "local_error" and self.h is not None:
            raise ValueError(
                "FiberSpec(method='local_error') is adaptive; give tol, "
                "not h (use method='o4' for a fixed-step scheme)")


@dataclass(frozen=True)
class DBPSpec(FiberSpec):
    """Digital back-propagation span: the fiber physics with every operator
    sign flipped (alpha -> -alpha, beta -> -beta, gamma -> -gamma; reference
    devices.py:1280-1283), run as an in-graph receiver equalizer stage.

    ``undo_gain_dB`` is removed from the field (divided out) *before* the
    backward pass — set it to the span amplifier gain so per-span DBP
    exactly inverts a FIBER+EDFA span at bounded power."""
    undo_gain_dB: float = 0.0


@dataclass(frozen=True)
class EDFASpec:
    """Flat-gain amplifier + ASE (reference devices.py:829-942).

    ``NF=None`` disables the ASE draw — a pure field scale of
    ``10^(G/20)`` (negative ``G`` = attenuator), useful for noiseless
    studies and for gain bookkeeping around DBP stages.  ``BW`` adds the
    reference EDFA's optional output band-pass (zero-phase Bessel
    ``|H|^2``, reference devices.py:938-941)."""
    G: float                      # gain [dB]
    NF: Optional[float] = None    # noise figure [dB]; None -> no ASE
    BW: Optional[float] = None    # optional output optical filter [Hz]
    filt_order: int = 4

    def __post_init__(self):
        if self.BW is not None and self.BW <= 0:
            raise ValueError("EDFASpec.BW must be > 0 Hz (or None)")


@dataclass(frozen=True)
class DMSpec:
    """Dispersive medium: frequency-domain phase ``H = exp(j*w^2*D/2)``
    with ``D`` the accumulated GVD in [ps^2] (reference devices.py:945-1035).
    ``D = -beta_2 * length`` compensates a fiber span exactly."""
    D: float                      # accumulated dispersion [ps^2]


@dataclass(frozen=True)
class BPFSpec:
    """Optical band-pass filter stage: zero-phase Bessel ``|H|^2`` with
    full bandwidth ``BW`` (baseband low-pass equivalent, reference
    devices.py:788-826)."""
    BW: float                     # full optical bandwidth [Hz]
    n: int = 4                    # filter order

    def __post_init__(self):
        if self.BW <= 0:
            raise ValueError("BPFSpec.BW must be > 0 Hz")


@dataclass(frozen=True)
class RepeatSpec:
    """``n`` repetitions of a stage block, lowered to ONE ``lax.scan`` over
    the block (the 20x80 km configs compile one span body instead of 20
    unrolled copies).  ASE keys inside the block are derived per iteration
    with ``fold_in(block_key, span_index)``.

    The field is promoted to 2 polarizations *before* the scan when the
    block contains a noisy EDFA (the scan carry must be shape-invariant).
    """
    n: int
    stages: Tuple = ()

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("RepeatSpec.n must be >= 1")
        if not self.stages:
            raise ValueError("RepeatSpec.stages must be non-empty")
        for st in self.stages:
            if isinstance(st, RepeatSpec):
                raise ValueError("RepeatSpec cannot nest")
            if not isinstance(st, (FiberSpec, EDFASpec, DMSpec, BPFSpec)):
                raise ValueError(f"unsupported stage in RepeatSpec: {st!r}")


@dataclass(frozen=True)
class LinkSpec:
    """Full-link configuration (TX + channel stages + RX).

    Field semantics match the corresponding staged devices
    (DAC/LASER/MZM: reference devices.py:185-785; PD: devices.py:1378-1555).
    """
    # --- DAC (reference devices.py:185-350) ---
    pulse_shape: str = "gaussian"         # 'nrz' | 'gaussian' | 'rcos'
    pulse_kwargs: Tuple = ()              # (('m', 2), ('c', 0.0), ...)
    pulse_span: int = 32                  # FIR span [slots]; the reference
    # grows the span with the sequence length (span = bits-4), but a pulse
    # is numerically zero beyond a few slots — 32 is < 1e-16 truncation for
    # every supported shape and keeps the shaping FFT at length n.
    Vpp: float = 1.0
    offset: float = 0.0
    coupling: str = "DC"                  # 'DC' | 'AC'
    # --- LASER (reference devices.py:353-510) ---
    P0: float = 0.0                       # [dBm]
    lw: Optional[float] = None            # linewidth [Hz]
    rin: Optional[float] = None           # RIN [dB/Hz]
    df: Optional[float] = None            # frequency offset [Hz]
    # --- modulator (MZM: reference devices.py:620-785; PM: 513-617) ---
    modulator: str = "mzm"                # 'mzm' | 'pm'
    bias: float = 0.0
    Vpi: float = 5.0
    loss_dB: float = 0.0
    ER_dB: float = 26.0
    # --- channel ---
    stages: Tuple[Union["FiberSpec", "EDFASpec", "DMSpec", "BPFSpec",
                        "RepeatSpec"], ...] = ()
    # --- PD (reference devices.py:1378-1555) ---
    pd_BW: float = 7.5e9                  # electrical bandwidth [Hz]
    pd_r: float = 1.0                     # responsivity [A/W]
    pd_T: float = 300.0                   # temperature [K]
    pd_R_load: float = 50.0               # load resistance [ohm]
    pd_Fn: float = 0.0                    # electrical noise figure [dB]
    i_dark: float = 10e-9                 # dark current [A]
    include_thermal: bool = True
    include_shot: bool = True
    lpf_order: int = 4
    # --- ADC (optional in-graph quantization, reference devices.py:1558-1632)
    adc_bits: Optional[int] = None        # None -> no quantization
    # --- sampling ---
    sampler_instant: Optional[int] = None  # default sps//2 (ook.DSP)

    def __post_init__(self):
        # Validate at construction — the staged devices validate heavily
        # (e.g. DAC, reference devices.py:269-342); the flagship API must
        # not defer a typo to a trace-time error deep in XLA.
        if self.pulse_shape.lower() not in ("nrz", "gaussian", "rcos"):
            raise ValueError(
                f"pulse_shape must be 'nrz', 'gaussian' or 'rcos', got "
                f"{self.pulse_shape!r}")
        if self.coupling.strip().upper() not in ("AC", "DC"):
            raise ValueError(
                f"coupling must be 'AC' or 'DC', got {self.coupling!r}")
        if self.modulator.lower() not in ("mzm", "pm"):
            raise ValueError(
                f"modulator must be 'mzm' or 'pm', got {self.modulator!r}")
        if self.Vpi <= 0:
            raise ValueError("Vpi must be > 0")
        if self.pd_BW <= 0:
            raise ValueError("pd_BW must be > 0 Hz")
        if self.pulse_span < 1:
            raise ValueError("pulse_span must be >= 1 slot")
        if self.adc_bits is not None and not 1 <= int(self.adc_bits) <= 16:
            raise ValueError("adc_bits must be in [1, 16] (or None)")
        for st in self.stages:
            if not isinstance(st, (FiberSpec, EDFASpec, DMSpec, BPFSpec,
                                   RepeatSpec)):
                raise ValueError(
                    f"unsupported stage {st!r}; expected FiberSpec/DBPSpec/"
                    "EDFASpec/DMSpec/BPFSpec/RepeatSpec")
        dict(self.pulse_kwargs)  # must be (('key', val), ...) pairs


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------
def _pulse_taps(spec: LinkSpec, sps: int) -> np.ndarray:
    kw = dict(spec.pulse_kwargs)
    shape = spec.pulse_shape.lower()
    span = int(spec.pulse_span)
    if shape == "nrz":
        return pulses.nrz_pulse(span=span, sps=sps, T=kw.get("T", 1))
    if shape == "gaussian":
        hp = pulses.gauss_pulse(span=span, sps=sps, T=kw.get("T", 1),
                                m=kw.get("m", 1), c=kw.get("c", 0.0))
        return hp.real if kw.get("c", 0.0) == 0 else hp
    if shape == "rcos":
        return pulses.rcos_pulse(beta=kw.get("beta", 0.25), span=span,
                                 sps=sps, shape=kw.get("rcos_type", "normal"))
    raise ValueError(f"unknown pulse_shape {spec.pulse_shape!r}")


def _stage_plan(stages, f0: float, fs: float, *, fiber_extra, dm_const,
                bpf_name, wrap_hs=lambda hs: hs):
    """Shared spec -> per-stage-constants derivation for BOTH link
    builders (LinkProgram and ShardedLinkProgram), so stage semantics
    (DBP sign/undo-gain, EDFA ASE power, repeat/ASE detection, ...) live
    in exactly one place.  The builders inject only their spectral-array
    representation: ``fiber_extra(st)`` / ``dm_const(st)`` return extra
    dict entries (e.g. a registered phase-array name, or the raw D for
    in-graph evaluation), ``bpf_name(order, BW)`` registers a |H|^2
    response, ``wrap_hs`` converts step schedules."""
    def one(st):
        if isinstance(st, FiberSpec):  # incl. DBPSpec
            cc = {"kind": "fiber",
                  "sgn": -1.0 if isinstance(st, DBPSpec) else 1.0,
                  "a_km": ssfm.alpha_per_km(st.alpha),
                  "hs": (None if st.h is None else
                         wrap_hs(ssfm.ssfm_step_schedule(st.length,
                                                         st.h))),
                  "method": st.method,
                  "linear_only": (st.gamma == 0
                                  or (st.beta_2 == 0 and st.beta_3 == 0))}
            if isinstance(st, DBPSpec) and st.undo_gain_dB:
                cc["pre_scale"] = float(idb(-st.undo_gain_dB) ** 0.5)
            cc.update(fiber_extra(st))
            return cc
        if isinstance(st, EDFASpec):
            cc = {"kind": "edfa", "sqrtG": float(idb(st.G) ** 0.5)}
            if st.NF is not None:
                if st.G < 0:
                    raise ValueError(
                        "EDFASpec with ASE (NF set) needs G >= 0 dB")
                # G = 0 dB gives sigma_ase = 0, matching the staged EDFA
                cc["sigma_ase"] = ase_sigma(st.G, st.NF, f0, fs)
            if st.BW is not None:
                cc["H2_name"] = bpf_name(st.filt_order, st.BW)
            return cc
        if isinstance(st, DMSpec):
            return {"kind": "dm", **dm_const(st)}
        if isinstance(st, BPFSpec):
            return {"kind": "bpf", "H2_name": bpf_name(st.n, st.BW)}
        if isinstance(st, RepeatSpec):
            return {"kind": "repeat", "n": st.n,
                    "sub": tuple(one(s) for s in st.stages),
                    "needs_ase": any(
                        isinstance(s, EDFASpec) and s.NF is not None
                        for s in st.stages)}
        raise ValueError(f"unsupported stage {st!r}")

    return [one(s) for s in stages]


def _circular_zero_phase_spectrum(h: np.ndarray, n: int) -> np.ndarray:
    """FFT spectrum of the kernel ``h`` centered at index 0 (zero phase),
    for length-``n`` circular convolution equivalent to 'same' linear
    convolution away from the edges."""
    m = h.size
    if m > n:
        raise ValueError(f"pulse span ({m} taps) exceeds waveform ({n})")
    buf = np.zeros(n, dtype=np.complex128 if np.iscomplexobj(h) else
                   np.float64)
    buf[:m] = h
    buf = np.roll(buf, -((m - 1) // 2))
    return np.fft.fft(buf).astype(np.complex64)


class LinkProgram:
    """A compiled end-to-end link.  Call :meth:`run` (host convenience),
    :meth:`jitted` (compiled, prebuilt constants), or use :attr:`fn`
    directly: ``fn(bits_f32, seed_u32, consts) -> (v_t, v_slots)`` — a
    jittable pure function with planar float32 in/out (pass
    :attr:`consts` for the third argument)."""

    # NOTE: `fn` has signature (bits_f32, seed_u32, consts_pytree) — the
    # large frequency-response / dispersion arrays travel as arguments
    # (`self.consts`), never as embedded graph constants.
    def __init__(self, spec: LinkSpec, n_bits: int, params: SimParams,
                 return_field: bool = False):
        self.spec = spec
        self.n_bits = int(n_bits)
        self.params = params
        sps = params.sps
        n = self.n_bits * sps
        self.n = n
        fs = params.fs
        dt = 1.0 / fs

        # ---- host-side constants ----
        # Large length-n arrays are passed to the program as a pytree
        # ARGUMENT (self.consts), not closed over: embedded constants get
        # serialized into the compiled program (hundreds of MB at 2^24
        # samples).  Complex constants are stored planar (re, im) and
        # recombined in-graph, like every jitted boundary of this package
        # (see ops/ssfm.py "Planar jit boundaries").
        consts = {}
        hp = _pulse_taps(spec, sps)
        Hp_np = _circular_zero_phase_spectrum(hp, n)
        consts["Hp_re"] = jnp.asarray(Hp_np.real.astype(np.float32))
        consts["Hp_im"] = jnp.asarray(Hp_np.imag.astype(np.float32))
        pulse_complex = np.iscomplexobj(hp)

        # laser t-axis: reference gv.t (linspace endpoint=True,
        # typing.py:356) for drop-in equality with the staged LASER
        t_axis = np.linspace(0.0, n / fs, n, endpoint=True)
        P0_amp = float(np.sqrt(idbm(spec.P0)))
        sigma_ph = (float(np.sqrt(2 * pi * spec.lw * dt))
                    if spec.lw and spec.lw > 0 else 0.0)
        sigma_rin = (float(np.sqrt(idb(spec.rin) * fs))
                     if spec.rin is not None else 0.0)
        # Build-time analogue of the staged LASER's per-draw validity check
        # (devices.py: raises when any 1+rin draw < 0, which would NaN the
        # sqrt).  The expected minimum of n N(0,sigma) draws is about
        # -sigma*sqrt(2 ln n); refuse configurations where it crosses -1,
        # instead of silently NaN-ing the whole fused chain in-graph.
        if sigma_rin * math.sqrt(2 * math.log(max(n, 2))) >= 1.0:
            raise ValueError(
                "Noise power is to high, try decrease RIN parameter.")
        if spec.df:
            # reduce mod 2*pi in float64 BEFORE the float32 cast: at large
            # n*df the raw phase reaches ~1e7 rad where float32 ulp is
            # whole radians, which would randomize the carrier rotation
            df_phase64 = np.mod(2 * pi * spec.df * t_axis, 2 * pi)
            consts["df_phase"] = jnp.asarray(df_phase64.astype(np.float32))
        has_df = bool(spec.df)

        loss_amp = float(idb(-spec.loss_dB) ** 0.5)
        eta_half = float(idb(-spec.ER_dB) ** 0.5)  # eta/2 with eta=2*10^-ER/20
        g_scale = float(pi / 2 / spec.Vpi)

        w = 2 * np.pi * np.fft.fftfreq(n) * fs
        _arr_cache = {}  # identical spectral arrays shared across stages

        def _register(prefix: str, key, build):
            key = (prefix,) + tuple(key)
            if key not in _arr_cache:
                name = f"{prefix}_{len(_arr_cache)}"
                consts[name] = build()
                _arr_cache[key] = name
            return _arr_cache[key]

        def _bpf_const(order: int, BW: float):
            # optical BPF: full bandwidth BW -> low-pass cutoff BW/2
            # (reference devices.py:818-822), zero-phase |H|^2
            return _register("H2_bpf", (order, float(BW)), lambda:
                             jnp.asarray(filters.bessel_filtfilt_response(
                                 order, float(BW) / 2, fs, n)))

        stage_consts = _stage_plan(
            spec.stages, params.f0, fs,
            fiber_extra=lambda st: {"phi_name": _register(
                "phi_w", (st.beta_2, st.beta_3), lambda:
                jnp.asarray(ssfm.dispersion_phase(
                    w, st.beta_2, st.beta_3)))},
            dm_const=lambda st: {"phi_name": _register(
                "phi_dm", (st.D,), lambda: jnp.asarray(
                    ((w * 1e-12) ** 2 * st.D / 2).astype(np.float32)))},
            bpf_name=_bpf_const, wrap_hs=jnp.asarray)

        S_T = (4 * kB * spec.pd_T * fs / 2 * idb(spec.pd_Fn) / spec.pd_R_load
               if spec.include_thermal else 0.0)
        consts["H2_pd"] = jnp.asarray(np.asarray(
            filters.bessel_filtfilt_response(
                spec.lpf_order, float(spec.pd_BW), fs, n), dtype=np.float32))

        instant = (spec.sampler_instant if spec.sampler_instant is not None
                   else sps // 2)
        ac = spec.coupling.strip().upper() == "AC"
        is_pm = spec.modulator.lower() == "pm"
        stages = spec.stages

        # ---- the fused program ----
        def fwd(bits, seed, consts):
            # key stream replicating gv(seed=...) + per-device
            # rng.resolve() consumption order (see module docstring)
            stream = jax.random.PRNGKey(seed)

            def next_key(stream):
                stream, sub = jax.random.split(stream)
                return stream, sub

            # --- DAC: zero-stuff upsample + circular pulse shaping ---
            xu = pulses.upsample_zero_stuff(bits.astype(jnp.float32), sps)
            Hp = jax.lax.complex(consts["Hp_re"], consts["Hp_im"])
            X = jnp.fft.fft(xu) * Hp
            x = jnp.fft.ifft(X) if pulse_complex else jnp.fft.ifft(X).real
            x = x * jnp.float32(spec.Vpp) + jnp.float32(spec.offset)
            if ac:
                x = x - jnp.mean(x)
            if pulse_complex:
                x = x.real  # MZM drive voltage is real

            # --- LASER ---
            stream, k_laser = next_key(stream)
            k_ph, k_rin = jax.random.split(k_laser)
            phase = jnp.zeros((), jnp.float32)
            if sigma_ph > 0:
                phase = wiener_phase_inside(k_ph, n, sigma_ph)
            if has_df:
                phase = phase + consts["df_phase"]
            amp = jnp.float32(P0_amp)
            rin_ok = jnp.float32(1.0)
            if sigma_rin > 0:
                rin_noise = gaussian_inside(k_rin, (n,), sigma_rin)
                # the build-time guard rejects configs whose EXPECTED
                # minimum draw crosses -1, but a given seed's actual min
                # still can; clamp the power at 0 so the tail draw darkens
                # one sample instead of NaN-ing the whole fused chain,
                # and raise the validity flag (the staged LASER — like
                # the reference, devices.py:492-500 — RAISES on such a
                # draw; the flag makes the fused clamp attributable)
                rin_ok = (jnp.min(rin_noise) > -1.0).astype(jnp.float32)
                amp = amp * jnp.sqrt(jnp.maximum(1 + rin_noise, 0.0))
            if sigma_ph > 0 or has_df:
                E = amp * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
            else:
                E = jnp.broadcast_to(amp, (n,)).astype(jnp.complex64)

            # --- modulator ---
            if is_pm:
                # phase modulator: E*exp(j*pi*u/Vpi) (reference
                # devices.py:513-617); bias/loss/ER do not apply
                g = jnp.float32(pi / spec.Vpi) * x
                field = E * jax.lax.complex(jnp.cos(g), jnp.sin(g))
            else:
                # MZM (reference devices.py:762-768)
                g = jnp.float32(g_scale) * (x + jnp.float32(spec.bias))
                h_t = jnp.float32(loss_amp) * jax.lax.complex(
                    jnp.cos(g), jnp.float32(eta_half) * jnp.sin(g))
                field = E * h_t  # (n,) complex64

            # --- channel stages ---
            def promote_2pol(f):
                if f.ndim == 1:
                    return jnp.stack([f, jnp.zeros_like(f)])
                return f

            def apply_fiber(f, st, cc):
                """Forward span, or (DBPSpec: sgn=-1) the sign-flipped
                back-propagation pass (reference devices.py:1280-1283)."""
                if "pre_scale" in cc:
                    f = f * jnp.float32(cc["pre_scale"])
                sgn = cc["sgn"]
                phi_w = consts[cc["phi_name"]]
                if sgn < 0:
                    phi_w = -phi_w  # loop-invariant; XLA hoists it
                g_nl = sgn * st.gamma
                a_lin = sgn * cc["a_km"]
                if cc["linear_only"] and cc["hs"] is None:
                    hs1 = jnp.asarray([st.length], dtype=jnp.float32)
                    return ssfm.ssfm_scan_inside(f, phi_w, hs1, g_nl, a_lin)
                if cc["hs"] is not None:
                    if cc["method"] == "o4":
                        return ssfm.ssfm_o4_scan_inside(
                            f, phi_w, cc["hs"], g_nl, a_lin)
                    return ssfm.ssfm_scan_inside(f, phi_w, cc["hs"], g_nl,
                                                 a_lin)
                if cc["method"] == "o4":      # self-tuning Yoshida S4
                    f, _ = ssfm.ssfm_o4_auto_inside(
                        f, phi_w, st.length, g_nl, st.tol,
                        st.length / 10.0, a_lin)
                    return f
                if cc["method"] == "local_error":
                    f, _ = ssfm.ssfm_local_error_inside(
                        f, phi_w, st.length, g_nl, st.tol,
                        st.length / 10.0, a_lin)
                    return f
                maxP0 = jnp.max(f.real**2 + f.imag**2)
                h0 = jnp.minimum(
                    jnp.float32(st.phi_max)
                    / (jnp.abs(jnp.float32(g_nl)) * maxP0),
                    jnp.float32(st.length))
                f, _ = ssfm.ssfm_while_inside(
                    f, phi_w, st.length, g_nl, st.phi_max, h0, a_lin,
                    adaptive=True)
                return f

            def apply_edfa(f, cc, key):
                """Gain + physical 2-pol ASE (+ optional output filter)."""
                if "sigma_ase" in cc:
                    f = promote_2pol(f) * jnp.float32(cc["sqrtG"])
                    d = gaussian_inside(key, (4, n), cc["sigma_ase"])
                    f = f + jax.lax.complex(d[:2], d[2:])
                else:
                    f = f * jnp.float32(cc["sqrtG"])
                if "H2_name" in cc:
                    f = jnp.fft.ifft(jnp.fft.fft(f, axis=-1)
                                     * consts[cc["H2_name"]], axis=-1)
                return f

            def apply_linear(f, cc):
                """DM phase / BPF |H|^2 spectral multiply."""
                if cc["kind"] == "dm":
                    ph = consts[cc["phi_name"]]
                    H = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
                else:
                    H = consts[cc["H2_name"]]
                return jnp.fft.ifft(jnp.fft.fft(f, axis=-1) * H, axis=-1)

            for st, cc in zip(stages, stage_consts):
                if cc["kind"] == "fiber":
                    field = apply_fiber(field, st, cc)
                elif cc["kind"] == "edfa":
                    if "sigma_ase" in cc:
                        stream, k_ase = next_key(stream)
                    else:
                        k_ase = None
                    field = apply_edfa(field, cc, k_ase)
                elif cc["kind"] in ("dm", "bpf"):
                    field = apply_linear(field, cc)
                else:  # repeat: ONE scan over the span block
                    if cc["needs_ase"]:
                        stream, k_rep = next_key(stream)
                        field = promote_2pol(field)  # scan carry is
                        # shape-invariant; ASE would promote mid-scan
                    else:
                        k_rep = jax.random.PRNGKey(0)  # never consumed

                    def span_body(f, idx, st=st, cc=cc, k_rep=k_rep):
                        k_i = jax.random.fold_in(k_rep, idx)
                        for s_st, s_cc in zip(st.stages, cc["sub"]):
                            if s_cc["kind"] == "fiber":
                                f = apply_fiber(f, s_st, s_cc)
                            elif s_cc["kind"] == "edfa":
                                if "sigma_ase" in s_cc:
                                    k_i, k_sub = jax.random.split(k_i)
                                    f = apply_edfa(f, s_cc, k_sub)
                                else:
                                    f = apply_edfa(f, s_cc, None)
                            else:
                                f = apply_linear(f, s_cc)
                        return f, None

                    field, _ = jax.lax.scan(
                        span_body, field, jnp.arange(cc["n"],
                                                     dtype=jnp.uint32))

            # --- PD (reference devices.py:1378-1555) ---
            P = field.real**2 + field.imag**2
            if field.ndim == 2:
                P = P.sum(axis=0)
            i_ph = jnp.float32(spec.pd_r) * P

            stream, k_pd = next_key(stream)
            k_T, k_N = jax.random.split(k_pd)
            i = i_ph
            if spec.include_thermal or spec.include_shot:
                # reference folds i_dark into the noise track
                # (devices.py:1521-1546); with noise off it is omitted
                i = i + jnp.float32(spec.i_dark)
            if spec.include_thermal:
                i = i + gaussian_inside(k_T, (n,), S_T**0.5)
            if spec.include_shot:
                mean_i = jnp.mean(i_ph)
                S_N = (2 * jnp.float32(e) * (mean_i + jnp.float32(spec.i_dark))
                       * jnp.float32(fs / 2))
                i = i + jnp.sqrt(S_N) * jax.random.normal(k_N, (n,),
                                                          dtype=jnp.float32)

            # --- electrical LPF (zero-phase |H|^2, ops/filters.py) ---
            v = jnp.fft.ifft(jnp.fft.fft(i * jnp.float32(spec.pd_R_load))
                             * consts["H2_pd"]).real
            if spec.adc_bits is not None:
                v = _adc_quantize(v, int(spec.adc_bits))
            out = (v, v[instant::sps])
            if return_field:
                out = out + (field.real, field.imag)
            # trailing diagnostics: rin_ok == 0 means a RIN draw crossed
            # -1 and was clamped (front-positional consumers unaffected)
            return out + (rin_ok,)

        self.consts = consts
        self.fn = fwd
        self._jitted = jax.jit(fwd)

    def jitted(self, bits, seed):
        """Compiled program on the prebuilt constants:
        ``(bits_f32, seed) -> (v_t, v_slots, ...)``."""
        return self._jitted(bits, seed, self.consts)

    # ---- host conveniences ----
    def run(self, bits=None, seed: int = 0, prbs_order: int = 9):
        """Run the fused link.  ``bits``: array/BinarySequence of length
        ``n_bits`` (default: PRBS of ``prbs_order`` wrapped to length).
        Returns a namespace with ``tx`` (BinarySequence), ``v``
        (ElectricalSignal, filtered PD voltage), ``slots`` (per-slot
        samples), and helpers ``decide(threshold)`` / ``ber()``."""
        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=self.n_bits)
            bits = b
        tx = BinarySequence(bits)
        if tx.size != self.n_bits:
            raise ValueError(f"need {self.n_bits} bits, got {tx.size}")
        out = self.jitted(
            jnp.asarray(tx.to_numpy(np.float32)), jnp.uint32(seed))
        v, slots = out[:2]
        rin_ok = float(out[-1])
        if rin_ok == 0.0:
            _warn_rin()
        v_np = np.asarray(v)
        slots_np = np.asarray(slots)

        ns = SimpleNamespace(tx=tx, v=ElectricalSignal(v_np),
                             slots=ElectricalSignal(slots_np),
                             program=self, rin_ok=bool(rin_ok))

        def decide(threshold: float) -> BinarySequence:
            return BinarySequence((slots_np > threshold).astype(np.uint8))

        def ber(threshold: Optional[float] = None) -> float:
            if threshold is None:
                from .devices import GET_EYE
                from .models.ook import THRESHOLD_EST
                eye_obj = GET_EYE(ns.v, nslots=min(8192, self.n_bits))
                threshold = THRESHOLD_EST(eye_obj)
            rx = decide(threshold)
            return float(np.mean(rx.data != tx.data))

        ns.decide = decide
        ns.ber = ber
        return ns

    def eye(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = None,
            with_traces: bool = False):
        """Fused chain **plus** eye metrology: TX -> channel -> RX ->
        GET_EYE as ONE XLA program.

        The waveform never leaves the accelerator — the blind eye
        estimation pipeline (reference devices.py:1635-1868) runs as
        jitted reductions (:func:`opticomlib_tpu.ops.eyeana.
        eye_metrics_jax`) directly on the device-resident PD voltage, and
        only the scalar eye parameters (mu0/mu1/s0/s1, crossings, t_opt,
        threshold, ER, eye height) are transferred back.  Set
        ``with_traces=True`` to also return the rendering traces
        (``t``/``y``/...) for :meth:`Eye.plot`.
        """
        from .eyediag import Eye

        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=self.n_bits)
            bits = b
        tx = BinarySequence(bits)
        if tx.size != self.n_bits:
            raise ValueError(f"need {self.n_bits} bits, got {tx.size}")

        key = (nslots, sps_resamp, with_traces)
        cache = getattr(self, "_eye_jitted", None)
        if cache is None:
            cache = self._eye_jitted = {}
        if key not in cache:
            sps = self.params.sps
            trace_keys = _EYE_TRACE_KEYS

            def prog(bits_f32, seed_u32, consts):
                v = self.fn(bits_f32, seed_u32, consts)[0]
                m = eye_metrics_jax(v, sps=sps, nslots=nslots,
                                    sps_resamp=sps_resamp)
                if not with_traces:
                    for k in trace_keys:
                        m.pop(k, None)
                return m

            cache[key] = jax.jit(prog)

        metrics = jax.device_get(cache[key](
            jnp.asarray(tx.to_numpy(np.float32)), jnp.uint32(seed),
            self.consts))
        out = {}
        for k, v in metrics.items():
            if isinstance(v, np.ndarray) and v.ndim == 0:
                out[k] = v.item()
            else:
                out[k] = v
        for k in ("threshold", "y_left", "y_right"):
            if out.get(k) is not None and np.isnan(out[k]):
                out[k] = None
        out["dt"] = 1.0 / self.params.fs
        return Eye(out)

    def dsp(self, bits=None, seed: int = 0, prbs_order: int = 9,
            nslots: int = 8192, sps_resamp: Optional[int] = 128):
        """Fully-fused OOK receiver: chain -> GET_EYE -> THRESHOLD_EST ->
        slicer -> **BER**, one XLA program, scalars-only readback.

        Mirrors ``models.ook.DSP`` + ``BER_analizer('counter')``
        (reference ook.py:63-132, 135-218): blind eye metrology on the PD
        voltage, the 1000-point ``argmin 0.5*[Q((mu1-r)/s1)+Q((r-mu0)/s0)]``
        threshold scan, per-slot decision at the sampler instant, and the
        error count against the transmitted bits — with every stage a
        device-side reduction (north star: "GET_EYE/BER become vectorized
        reductions").  Returns a namespace with ``ber``, ``threshold``,
        ``n_errors`` and the eye scalars (``Eye`` object without traces).
        """
        from .eyediag import Eye

        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=self.n_bits)
            bits = b
        tx = BinarySequence(bits)
        if tx.size != self.n_bits:
            raise ValueError(f"need {self.n_bits} bits, got {tx.size}")

        key = (nslots, sps_resamp)
        cache = getattr(self, "_dsp_jitted", None)
        if cache is None:
            cache = self._dsp_jitted = {}
        if key not in cache:
            sps = self.params.sps

            def prog(bits_f32, seed_u32, consts):
                full = self.fn(bits_f32, seed_u32, consts)
                v, slots = full[:2]
                return _ook_rx_ingraph(v, slots, bits_f32, sps,
                                       nslots, sps_resamp) + (full[-1],)

            cache[key] = jax.jit(prog)

        m, rth, n_err, rin_ok = jax.device_get(cache[key](
            jnp.asarray(tx.to_numpy(np.float32)), jnp.uint32(seed),
            self.consts))
        if float(rin_ok) == 0.0:
            _warn_rin()
        out = {k: (v.item() if isinstance(v, np.ndarray) and v.ndim == 0
                   else v) for k, v in m.items()}
        for k in ("threshold", "y_left", "y_right"):
            if out.get(k) is not None and np.isnan(out[k]):
                out[k] = None
        out["dt"] = 1.0 / self.params.fs
        n_err = int(n_err)
        return SimpleNamespace(ber=n_err / self.n_bits, n_errors=n_err,
                               threshold=float(rth), eye=Eye(out), tx=tx,
                               rin_ok=bool(float(rin_ok)))

    def dsp_ppm(self, M: int, decision: str = "soft", bits=None,
                seed: int = 0, prbs_order: int = 15,
                nslots: int = 8192, sps_resamp: Optional[int] = None):
        """Fully-fused M-PPM receiver: chain -> decision -> decode -> BER,
        one XLA program (device twin of ``models.ppm.DSP`` +
        ``BER_analizer('counter')``, reference ppm.py:309-415, 419-577).

        The link's input sequence is the M-slot one-hot stream (so the
        program is built with ``n_bits = n_symbols * M`` slots); ``bits``
        here are the *information* bits (``n_symbols * log2(M)`` of them,
        PRBS by default), host-encoded once with ``PPM_ENCODER``.

        * ``decision="soft"``: mid-slot subsample -> per-symbol argmax
          (``sdd_positions_jax``).
        * ``decision="hard"``: device GET_EYE -> KDE threshold (falling
          back to the M-PPM log-space THRESHOLD_EST scan where the KDE
          fails) -> slicer -> keyed-random HDD repair
          (``hdd_positions_jax``) — the reference's ``np.random`` symbol
          repair becomes a per-slot keyed uniform score.

        Decoded bits compare against the information bits in-graph; only
        (n_errors, threshold, eye scalars) leave the device.
        """
        from .eyediag import Eye
        from .models.ppm import (PPM_ENCODER, positions_to_bits_jax,
                                 sdd_positions_jax)

        decision = decision.lower()
        if decision not in ("soft", "hard"):
            raise ValueError('`decision` must be "hard" or "soft"')
        if M & (M - 1) != 0 or M < 2:
            raise ValueError("`M` must be a power of 2.")
        if self.n_bits % M != 0:
            raise ValueError(
                f"link carries {self.n_bits} slots, not a multiple of M={M}")
        k = int(math.log2(M))
        n_sym = self.n_bits // M

        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=n_sym * k)
            bits = b
        tx = BinarySequence(bits)
        if tx.size != n_sym * k:
            raise ValueError(
                f"need {n_sym * k} information bits for {n_sym} symbols "
                f"of M={M}, got {tx.size}")
        slots_tx = PPM_ENCODER(tx, M)

        key = (M, decision, nslots, sps_resamp)
        cache = getattr(self, "_dsp_ppm_jitted", None)
        if cache is None:
            cache = self._dsp_ppm_jitted = {}
        if key not in cache:
            sps = self.params.sps

            def prog(slots_f32, info_bits_f32, seed_u32, consts):
                full = self.fn(slots_f32, seed_u32, consts)
                v, slot_samp = full[:2]
                if decision == "soft":
                    pos = sdd_positions_jax(slot_samp, M)
                    rx_bits = positions_to_bits_jax(pos, M)
                    n_err = jnp.sum(
                        rx_bits != info_bits_f32.astype(jnp.uint8))
                    return {}, jnp.nan, n_err, full[-1]
                return _ppm_hard_rx_ingraph(
                    v, slot_samp, info_bits_f32, M, sps, nslots,
                    sps_resamp, seed_u32) + (full[-1],)

            cache[key] = jax.jit(prog)

        m, rth, n_err, rin_ok = jax.device_get(cache[key](
            jnp.asarray(slots_tx.to_numpy(np.float32)),
            jnp.asarray(tx.to_numpy(np.float32)),
            jnp.uint32(seed), self.consts))
        n_err = int(n_err)
        if float(rin_ok) == 0.0:
            _warn_rin()
        eye_obj = None
        if m:
            out = {kk: (vv.item() if isinstance(vv, np.ndarray)
                        and vv.ndim == 0 else vv) for kk, vv in m.items()}
            for kk in ("threshold", "y_left", "y_right"):
                if out.get(kk) is not None and np.isnan(out[kk]):
                    out[kk] = None
            out["dt"] = 1.0 / self.params.fs
            eye_obj = Eye(out)
        rth = float(rth)
        return SimpleNamespace(
            ber=n_err / tx.size, n_errors=n_err,
            threshold=(None if np.isnan(rth) else rth),
            eye=eye_obj, tx=tx, slots_tx=slots_tx, M=M, decision=decision,
            rin_ok=bool(float(rin_ok)))

    def dsp_wdm(self, n_channels: int, bits=None, seed: int = 0,
                prbs_order: int = 15, nslots: int = 8192,
                sps_resamp: Optional[int] = None, mesh=None,
                axis: str = "wdm"):
        """WDM sweep with per-channel receivers: ``n_channels`` independent
        TX->RX chains + OOK DSP, vmapped into ONE XLA program (BASELINE
        config 5 as a first-class API).

        Channel ``c`` runs the chain with its own bits (row ``c`` of
        ``bits``, default: consecutive PRBS segments) and its own key
        stream (``seed + c`` — identical to ``prog.dsp(seed=seed + c)``).
        The per-channel receiver is the same in-graph GET_EYE ->
        THRESHOLD_EST -> slicer -> BER reduction as :meth:`dsp`; readback
        is (n_channels,) vectors of scalars.

        Pass ``mesh`` (a ``jax.sharding.Mesh`` with a ``axis`` dimension,
        e.g. ``Mesh(jax.devices(), ('wdm',))``) to shard the channel axis
        across chips: inputs are placed with
        ``NamedSharding(mesh, P('wdm'))`` and XLA partitions the whole
        vmapped program channel-parallel — the channel dimension is
        embarrassingly parallel (SURVEY §2.6: the DP analogue), so no
        collectives are needed until the scalar gather at the end.
        """
        if n_channels < 1:
            raise ValueError("n_channels must be >= 1")
        if bits is None:
            from .ops.prbs import prbs as _prbs
            b, _ = _prbs(prbs_order, length=n_channels * self.n_bits)
            bits = b.reshape(n_channels, self.n_bits)
        bits = np.asarray(bits)
        if bits.shape != (n_channels, self.n_bits):
            raise ValueError(
                f"bits must have shape {(n_channels, self.n_bits)}, "
                f"got {bits.shape}")

        key = (n_channels, nslots, sps_resamp,
               None if mesh is None else (tuple(mesh.axis_names),
                                          mesh.devices.shape))
        cache = getattr(self, "_dsp_wdm_jitted", None)
        if cache is None:
            cache = self._dsp_wdm_jitted = {}
        if key not in cache:
            sps = self.params.sps

            def one(bits_c, seed_c, consts):
                full = self.fn(bits_c, seed_c, consts)
                v, slots = full[:2]
                m, rth, n_err = _ook_rx_ingraph(v, slots, bits_c, sps,
                                                nslots, sps_resamp)
                return (m["mu0"], m["mu1"], m["s0"], m["s1"], m["er"],
                        m["eye_h"], rth, n_err, full[-1])

            cache[key] = jax.jit(jax.vmap(one, in_axes=(0, 0, None)))

        bits_dev = jnp.asarray(bits.astype(np.float32))
        seeds = jnp.uint32(np.arange(n_channels, dtype=np.uint32)
                           + np.uint32(seed))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            bits_dev = jax.device_put(
                bits_dev, NamedSharding(mesh, P(axis, None)))
            seeds = jax.device_put(seeds, NamedSharding(mesh, P(axis)))

        mu0, mu1, s0, s1, er, eye_h, rth, n_err, rin_ok = (
            np.asarray(a) for a in jax.device_get(
                cache[key](bits_dev, seeds, self.consts)))
        n_err = n_err.astype(np.int64)
        rin_ok = rin_ok > 0
        if not rin_ok.all():
            bad = np.flatnonzero(~rin_ok)
            _warn_rin(bad.tolist())
        return SimpleNamespace(
            ber=n_err / self.n_bits, n_errors=n_err, threshold=rth,
            mu0=mu0, mu1=mu1, s0=s0, s1=s1, er=er, eye_h=eye_h,
            n_channels=n_channels, tx=bits.astype(np.uint8),
            rin_ok=rin_ok)

    def dsp_wdm_ppm(self, n_channels: int, M: int, decision: str = "soft",
                    bits=None, seed: int = 0, prbs_order: int = 15,
                    mesh=None, axis: str = "wdm", nslots: int = 8192,
                    sps_resamp: Optional[int] = None):
        """M-PPM WDM sweep: ``n_channels`` independent chains + fused PPM
        receivers, vmapped into ONE XLA program — the PPM twin of
        :meth:`dsp_wdm` (a PPM sweep previously required a host loop over
        :meth:`dsp_ppm` calls).

        * ``decision="soft"``: SDD argmax decision + in-graph decode + BER.
        * ``decision="hard"``: per-channel eye metrology (GET_EYE
          reductions on the PD voltage) -> KDE/scan threshold -> slicer ->
          keyed HDD repair -> decode + BER (:func:`_ppm_hard_rx_ingraph`
          vmapped; ``nslots``/``sps_resamp`` size the eye window).

        ``bits``: (n_channels, n_sym*log2(M)) *information* bits (PRBS
        segments by default), host-encoded once with ``PPM_ENCODER``.
        Channel ``c`` uses key stream ``seed + c``.  ``mesh`` shards the
        channel axis like :meth:`dsp_wdm`.
        """
        from .models.ppm import (PPM_ENCODER, positions_to_bits_jax,
                                 sdd_positions_jax)

        decision = decision.lower()
        if decision not in ("soft", "hard"):
            raise ValueError('`decision` must be "hard" or "soft"')
        if n_channels < 1:
            raise ValueError("n_channels must be >= 1")
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

        key = (n_channels, M, decision, nslots, sps_resamp,
               None if mesh is None else (tuple(mesh.axis_names),
                                          mesh.devices.shape))
        cache = getattr(self, "_dsp_wdm_ppm_jitted", None)
        if cache is None:
            cache = self._dsp_wdm_ppm_jitted = {}
        if key not in cache:
            sps = self.params.sps

            def one(slots_c, info_c, seed_c, consts):
                full = self.fn(slots_c, seed_c, consts)
                v, slot_samp = full[:2]
                if decision == "soft":
                    pos = sdd_positions_jax(slot_samp, M)
                    rx_bits = positions_to_bits_jax(pos, M)
                    n_err = jnp.sum(rx_bits != info_c.astype(jnp.uint8))
                    return jnp.nan, n_err, full[-1]
                _, rth, n_err = _ppm_hard_rx_ingraph(
                    v, slot_samp, info_c, M, sps, nslots, sps_resamp,
                    seed_c)
                return rth, n_err, full[-1]

            cache[key] = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None)))

        slots_dev = jnp.asarray(slots_tx)
        info_dev = jnp.asarray(bits.astype(np.float32))
        seeds = jnp.uint32(np.arange(n_channels, dtype=np.uint32)
                           + np.uint32(seed))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            slots_dev = jax.device_put(
                slots_dev, NamedSharding(mesh, P(axis, None)))
            info_dev = jax.device_put(
                info_dev, NamedSharding(mesh, P(axis, None)))
            seeds = jax.device_put(seeds, NamedSharding(mesh, P(axis)))

        rth, n_err, rin_ok = jax.device_get(
            cache[key](slots_dev, info_dev, seeds, self.consts))
        n_err = np.asarray(n_err).astype(np.int64)
        rth = np.asarray(rth, np.float64)
        rin_ok = np.asarray(rin_ok) > 0
        if not rin_ok.all():
            _warn_rin(np.flatnonzero(~rin_ok).tolist())
        return SimpleNamespace(
            rin_ok=rin_ok,
            ber=n_err / (n_sym * k), n_errors=n_err, M=M,
            decision=decision, n_channels=n_channels,
            threshold=(None if np.isnan(rth).all() else rth),
            tx=bits.astype(np.uint8))


def build_link(spec: LinkSpec, n_bits: int,
               params: Optional[SimParams] = None,
               return_field: bool = False, mesh=None,
               time_axis: str = "time", wdm_axis: Optional[str] = "wdm",
               span_mesh=None, span_axis: str = "span"):
    """Compile the full TX->channel->RX chain described by ``spec`` into
    one XLA program for ``n_bits`` slots at the current (or given)
    simulation parameters.

    Pass ``mesh`` (a :class:`jax.sharding.Mesh` with a ``time_axis``
    dimension and optionally a ``wdm_axis``) to build the **sharded**
    fused link instead (:class:`opticomlib_tpu.link_sharded.
    ShardedLinkProgram`): the waveform's sample axis shards over the
    mesh (exact pencil-FFT spectral ops, adaptive SSFM with
    all-reduce(max)), WDM channels ride data-parallel, and the fused
    receivers (``dsp``/``dsp_wdm``) keep everything device-resident.

    Pass ``span_mesh`` (a 1-D mesh, e.g. ``make_span_mesh(8)``) to
    build the **pipelined** fused link instead
    (:class:`opticomlib_tpu.link_pipeline.PipelinedLinkProgram`): the
    channel-stage chain (FIBER+EDFA spans, DBP with undo-gain, DM —
    e.g. config 4's 20x80 km chain) is distributed over the mesh and a
    batch of channels streams through it (``dsp_wdm``), TX and RX
    running channel-parallel on each channel's owner device."""
    params = params if params is not None else gv.params
    if mesh is not None and span_mesh is not None:
        raise ValueError("pass either mesh= (time/wdm sharding) or "
                         "span_mesh= (span pipelining), not both")
    if span_mesh is not None:
        from .link_pipeline import PipelinedLinkProgram
        return PipelinedLinkProgram(spec, n_bits, params, span_mesh,
                                    span_axis=span_axis)
    if mesh is not None:
        from .link_sharded import ShardedLinkProgram
        return ShardedLinkProgram(spec, n_bits, params, mesh,
                                  time_axis=time_axis, wdm_axis=wdm_axis,
                                  return_field=return_field)
    return LinkProgram(spec, n_bits, params, return_field=return_field)
