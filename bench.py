"""Headline benchmark (BASELINE.json metric) + full-chain link throughput.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

* ``metric/value``  — SSFM throughput on the 2^24-sample OOK link (the
  BASELINE.json headline: 50 km NLSE, alpha=0.2, beta2=-21, gamma=1.3,
  phi_max=0.01 adaptive, 20 mW peak -> ~100 steps of 2 FFTs each).
* ``detail.full_chain_samples_per_s`` — the SAME waveform through the
  PUBLIC fused end-to-end program (opticomlib_tpu.link): PRBS bits ->
  DAC pulse shaping -> MZM -> 50 km SSFM -> EDFA(ASE) -> PD(thermal+shot)
  -> Bessel LPF -> slot samples, one XLA program, keyed on-device noise.
* ``detail.b2b_chain_samples_per_s`` — BASELINE config 1 (back-to-back).

``--all`` additionally benches BASELINE configs 3 (PPM M=8), 4 (20x80 km
+ DBP, at 2^20 samples) and 5 (16-WDM-channel batch, per-chip shard) and
writes BENCH_ALL.json.

``vs_baseline`` is the speedup over the locally measured reference
(armando-palacio/opticomlib) NumPy FIBER on this container's CPU
(BASELINE_MEASURED.json; the reference publishes no numbers, BASELINE.md).

All device boundaries are planar float32 (re, im).  Every timed call
ends in ``jax.block_until_ready``.
"""
import json
import os
import sys
import time

import numpy as np


N_BITS = 2**18
SPS = 64
N = N_BITS * SPS  # 2^24 samples
R = 10e9
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.01)
PEAK_W = 0.02


def _time(fn, reps=3):
    """Best wall time of fn() (fn must synchronize internally)."""
    fn()  # warmup / compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_ssfm_headline():
    """SSFM-only throughput at 2^24 samples (round-1 metric, kept as the
    headline for cross-round comparability)."""
    import jax

    from opticomlib_tpu.ops import ssfm

    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, N_BITS)
    A = (np.repeat(bits, SPS) * np.sqrt(PEAK_W)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(N) * R * SPS
    phi_w = ssfm.dispersion_phase(w, CFG["beta_2"], 0.0)
    a_km = ssfm.alpha_per_km(CFG["alpha"])

    Are = jax.device_put(np.ascontiguousarray(A.real))
    Aim = jax.device_put(np.ascontiguousarray(A.imag))
    phi_w = jax.device_put(phi_w)

    maxP0 = float(np.max(A.real**2 + A.imag**2))
    h0 = min(CFG["phi_max"] / (CFG["gamma"] * maxP0), CFG["length"])

    steps_box = {}

    def run():
        out = jax.block_until_ready(ssfm._ssfm_loop(
            Are, Aim, phi_w, CFG["length"], CFG["gamma"],
            CFG["phi_max"], h0, a_km, adaptive=True))
        steps_box["n"] = int(out[2])

    best = _time(run)
    return N / best, {"n_steps": steps_box["n"], "wall_s": round(best, 3)}


def _build_ook_link(stages, n_bits=N_BITS, sps=SPS, P0=16.0):
    """P0=16 dBm with 3 dB MZM loss -> ~20 mW peak launch, matching the
    SSFM-only headline config (PEAK_W) so step counts are comparable."""
    from opticomlib_tpu.link import LinkSpec, build_link
    from opticomlib_tpu.params import SimParams

    params = SimParams.create(sps=sps, R=R, _warn=False)
    spec = LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=P0,
                    pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                    stages=stages, pd_BW=0.75 * R)
    return build_link(spec, n_bits=n_bits, params=params)


def bench_ssfm_equal_accuracy():
    """Equal-ACCURACY headline (VERDICT round-3 #1), two comparisons at
    calibrated settings from EQUAL_ACCURACY.json
    (scripts/calibrate_equal_accuracy.py — relative L2 output error vs
    an o4 h=0.05 truth run, same waveform):

    1. *at the reference's default error* (phi_max=0.01 -> rel err
       ~1.7e-2): the largest o4 step matching that error.  The reference
       default is loose, so the 4th-order win here is modest (~1.3x
       fewer fft+ifft pairs).
    2. *at a tight 8.0e-3 target* (~2.1x tighter than the reference
       default, above the measured float32 accumulation floor; both
       schemes land matched at ~7.6e-3): the 2nd-order scheme's cost
       grows much faster as the target tightens, so this is where the
       algorithmic lever pays (~4x fewer FFT pairs).

    Returns (samples_per_s_at_default_error, detail) where detail also
    carries the tight-target rows and speedup."""
    import jax

    from opticomlib_tpu.ops import ssfm

    cal_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "EQUAL_ACCURACY.json")
    cal = None
    h_match = 2.0   # conservative default if uncalibrated
    if os.path.exists(cal_path):
        with open(cal_path) as f:
            cal = json.load(f)
        if cal.get("o4"):
            h_match = float(cal["o4"]["h"])

    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, N_BITS)
    A = (np.repeat(bits, SPS) * np.sqrt(PEAK_W)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(N) * R * SPS
    phi_w = jax.device_put(ssfm.dispersion_phase(w, CFG["beta_2"], 0.0))
    a_km = ssfm.alpha_per_km(CFG["alpha"])
    Are = jax.device_put(np.ascontiguousarray(A.real))
    Aim = jax.device_put(np.ascontiguousarray(A.imag))
    maxP0 = float(np.max(A.real**2 + A.imag**2))

    def time_o4(h):
        hs = jax.device_put(ssfm.ssfm_step_schedule(CFG["length"], h))

        def run():
            jax.block_until_ready(ssfm._ssfm_scan_o4(
                Are, Aim, phi_w, hs, CFG["gamma"], a_km))

        return _time(run), 3 * len(hs)

    def time_ref(phi_max):
        h0 = min(phi_max / (CFG["gamma"] * maxP0), CFG["length"])
        steps_box = {}

        def run():
            out = jax.block_until_ready(ssfm._ssfm_loop(
                Are, Aim, phi_w, CFG["length"], CFG["gamma"], phi_max,
                h0, a_km, adaptive=True))
            steps_box["n"] = int(out[2])

        return _time(run), steps_box["n"]

    best, pairs = time_o4(h_match)
    detail = {"scheme": "o4", "h_km": h_match, "fft_pairs": pairs,
              "wall_s": round(best, 3)}
    if cal:
        detail["matched_error"] = cal.get("o4", {}).get("error")
        detail["reference_scheme_error"] = \
            cal.get("reference_scheme", {}).get("error")
        detail["calibration"] = cal.get("method")
        tight = cal.get("tight") or {}
        if tight.get("reference_scheme") and tight.get("o4"):
            t_ref, ref_pairs = time_ref(
                float(tight["reference_scheme"]["phi_max"]))
            t_o4, o4_pairs = time_o4(float(tight["o4"]["h"]))
            detail["tight"] = {
                "target_error": tight["target_error"],
                "reference_scheme": {
                    "phi_max": tight["reference_scheme"]["phi_max"],
                    "error": tight["reference_scheme"]["error"],
                    "fft_pairs": ref_pairs,
                    "samples_per_s": round(N / t_ref, 1),
                    "wall_s": round(t_ref, 3)},
                "o4": {"h_km": tight["o4"]["h"],
                       "error": tight["o4"]["error"],
                       "fft_pairs": o4_pairs,
                       "samples_per_s": round(N / t_o4, 1),
                       "wall_s": round(t_o4, 3)},
                "speedup_at_equal_accuracy": round(t_ref / t_o4, 2),
            }
    return N / best, detail


def bench_full_chain():
    """BASELINE config 2 through the public fused link (bits -> RX slots)."""
    import jax
    import jax.numpy as jnp

    from opticomlib_tpu.link import EDFASpec, FiberSpec

    prog = _build_ook_link((FiberSpec(**CFG), EDFASpec(G=10, NF=5)))
    rng = np.random.default_rng(1)
    bits = jnp.asarray(rng.integers(0, 2, N_BITS).astype(np.float32))
    seed = jnp.uint32(7)

    def run():
        jax.block_until_ready(prog.jitted(bits, seed)[:2])

    best = _time(run, reps=2)
    return N / best, {"wall_s": round(best, 3)}


def bench_b2b_chain():
    """BASELINE config 1: back-to-back (no fiber) full chain."""
    import jax
    import jax.numpy as jnp

    prog = _build_ook_link(())
    rng = np.random.default_rng(2)
    bits = jnp.asarray(rng.integers(0, 2, N_BITS).astype(np.float32))
    seed = jnp.uint32(8)

    def run():
        jax.block_until_ready(prog.jitted(bits, seed)[:2])

    best = _time(run, reps=2)
    return N / best, {"wall_s": round(best, 3)}


def bench_ppm(M=8, n_sym=2**15, sps=32):
    """BASELINE config 3: PPM M=8 TX->channel->RX *receiver-complete*
    fused program (chain + SDD argmax decision + decode + BER on device,
    LinkProgram.dsp_ppm; scalars-only readback)."""
    from opticomlib_tpu.link import FiberSpec
    from opticomlib_tpu.ops.prbs import prbs as _prbs

    k = int(np.log2(M))
    bits, _ = _prbs(15, length=n_sym * k)
    n_slots = n_sym * M
    prog = _build_ook_link((FiberSpec(length=20, alpha=0.2, beta_2=-21.0,
                                      gamma=1.3),),
                           n_bits=n_slots, sps=sps)
    box = {}

    def run():
        box["d"] = prog.dsp_ppm(M, decision="soft", bits=bits, seed=3)

    best = _time(run, reps=2)
    return n_slots * sps / best, {"M": M, "ber": box["d"].ber,
                                  "wall_s": round(best, 3)}


def bench_fused_dsp(n_bits=N_BITS):
    """Config 2 receiver-complete: chain + GET_EYE + THRESHOLD_EST +
    slicer + BER as one program (LinkProgram.dsp)."""
    from opticomlib_tpu.link import EDFASpec, FiberSpec
    from opticomlib_tpu.ops.prbs import prbs as _prbs

    prog = _build_ook_link((FiberSpec(**CFG), EDFASpec(G=10, NF=5)),
                           n_bits=n_bits)
    bits, _ = _prbs(15, length=n_bits)
    box = {}

    def run():
        box["d"] = prog.dsp(bits=bits, seed=3)

    best = _time(run, reps=2)
    return n_bits * SPS / best, {"ber": box["d"].ber,
                                 "wall_s": round(best, 3)}


def bench_dbp(n_spans=20, span_km=80.0, n=2**20, sps=16):
    """BASELINE config 4: 20x80 km spans + full-length per-span DBP
    equalizer, adaptive stepping, as ONE fused XLA program — a lax.scan
    over the span axis with the in-jit adaptive while_loop inside (round-2
    ran 40 sequential jit calls with a host scalar readback between every
    span; round 3 fuses them, removing all 40 sync points).  2^20 samples
    (smaller window keeps the bench round under budget; throughput is
    per-sample-step invariant)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from opticomlib_tpu.ops import ssfm

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, n // sps)
    A = (np.repeat(bits, sps) * np.sqrt(0.005)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n) * R * sps
    phi_w = jax.device_put(ssfm.dispersion_phase(w, -21.0, 0.0))
    a_km = ssfm.alpha_per_km(0.2)
    Are = jax.device_put(np.ascontiguousarray(A.real))
    Aim = jax.device_put(np.ascontiguousarray(A.imag))
    g, phi_max = 1.3, 0.05
    gain = np.float32(10 ** (0.2 * span_km / 20))

    @partial(jax.jit, static_argnames=())
    def prog(re, im, phi_w):
        def span(carry, _, sgn):
            A, nst = carry
            if sgn < 0:
                A = A / gain  # undo span gain before back-propagation
            maxP0 = jnp.max(A.real**2 + A.imag**2)
            h0 = jnp.minimum(jnp.float32(phi_max) / (g * maxP0),
                             jnp.float32(span_km))
            A, s = ssfm.ssfm_while_inside(
                A, sgn * phi_w, span_km, sgn * g, phi_max, h0,
                sgn * a_km, adaptive=True)
            if sgn > 0:
                A = A * gain  # transparent EDFA
            return (A, nst + s), None

        A0 = jax.lax.complex(re, im)
        (A1, nst), _ = jax.lax.scan(partial(span, sgn=1.0),
                                    (A0, jnp.int32(0)), None,
                                    length=n_spans)
        (A2, nst), _ = jax.lax.scan(partial(span, sgn=-1.0),
                                    (A1, nst), None, length=n_spans)
        return A2.real, A2.imag, nst

    steps_total = {}

    def run():
        out = jax.block_until_ready(prog(Are, Aim, phi_w))
        steps_total["n"] = int(out[2])

    best = _time(run, reps=2)
    rate = n / best
    return rate, {"n_samples": n, "total_steps": steps_total["n"],
                  "sample_steps_per_s": round(rate * steps_total["n"], 1),
                  "wall_s": round(best, 3)}


def bench_dbp_o4(n_spans=20, span_km=80.0, n=2**20, sps=16):
    """Config 4 with the o4 scheme — the CAPABILITY row, not a speedup
    row: the same 20x80 km + per-span-DBP chain, each span a fixed-step
    Yoshida composition at the h calibrated to an ABSOLUTE round-trip
    residual target (scripts/calibrate_dbp_o4.py ->
    EQUAL_ACCURACY.json["config4"]).  The parity scheme's residual at
    its bench settings is ~sqrt(2) — it does not invert the link at all
    — so no equal-error speedup vs parity is claimed (round-4 advisor
    fix); the honest claim is that o4 inverts where parity cannot.
    Returns None if uncalibrated."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from opticomlib_tpu.ops import ssfm

    cal_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "EQUAL_ACCURACY.json")
    if not os.path.exists(cal_path):
        return None
    with open(cal_path) as f:
        cal = json.load(f).get("config4") or {}
    if not cal.get("o4"):
        return None
    h = float(cal["o4"]["h"])

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, n // sps)
    A = (np.repeat(bits, sps) * np.sqrt(0.005)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n) * R * sps
    phi_w = jax.device_put(ssfm.dispersion_phase(w, -21.0, 0.0))
    a_km = ssfm.alpha_per_km(0.2)
    Are = jax.device_put(np.ascontiguousarray(A.real))
    Aim = jax.device_put(np.ascontiguousarray(A.imag))
    g = 1.3
    gain = np.float32(10 ** (0.2 * span_km / 20))
    hs = jnp.asarray(ssfm.ssfm_step_schedule(span_km, h))

    @partial(jax.jit, static_argnames=())
    def prog(re, im, phi_w):
        def span(A, _, sgn):
            if sgn < 0:
                A = A / gain
            A = ssfm.ssfm_o4_scan_inside(A, sgn * phi_w, hs, sgn * g,
                                         sgn * a_km)
            if sgn > 0:
                A = A * gain
            return A, None

        A0 = jax.lax.complex(re, im)
        A1, _ = jax.lax.scan(partial(span, sgn=1.0), A0, None,
                             length=n_spans)
        A2, _ = jax.lax.scan(partial(span, sgn=-1.0), A1, None,
                             length=n_spans)
        return A2.real, A2.imag

    def run():
        jax.block_until_ready(prog(Are, Aim, phi_w))

    best = _time(run, reps=2)
    pairs = 3 * len(hs) * 2 * n_spans
    return n / best, {
        "n_samples": n, "scheme": "o4", "h_km": h,
        "fft_pairs": pairs, "wall_s": round(best, 3),
        "rt_error": cal["o4"]["rt_error"],
        "rt_target": cal.get("rt_target"),
        "fwd_error_vs_independent_truth": cal["o4"].get("fwd_error"),
        "parity_rt_error": cal["parity"]["rt_error"],
        "capability_note": "o4 inverts the link at the absolute target; "
                           "the parity scheme's residual ~sqrt(2) means "
                           "it cannot invert at its bench settings — no "
                           "speedup-vs-parity is claimed",
        "metric_note": cal.get("metric")}


def bench_wdm_batch(n_ch=16, n_bits=2**18, sps=16):
    """BASELINE config 5, single-chip, through the PUBLIC API:
    ``LinkProgram.dsp_wdm`` runs 16 receiver-complete chains (bits ->
    DAC -> MZM -> 50 km SSFM -> EDFA -> PD -> LPF -> in-graph GET_EYE ->
    THRESHOLD_EST -> slicer -> BER) vmapped into one XLA program;
    scalars-only readback.

    **Size shortfall, stated explicitly:** the defined config is 16 ch x
    2^26 samples SHARDED over N>=2 hosts (BASELINE.json).  One chip's
    HBM cannot hold 16 full-chain 2^26 waveforms, so this row runs the
    largest single-chip fit (16 x 2^22 = 2^26 total samples) and
    `bench_wdm_shard` runs the defined per-chip shard (1 ch x 2^26 —
    what each of 16 chips owns in the sharded run).  The full-size
    sharded program itself is exercised multi-device by
    `dryrun_multichip` (ShardedLinkProgram)."""
    from opticomlib_tpu.link import EDFASpec, FiberSpec
    from opticomlib_tpu.ops.prbs import prbs as _prbs

    n = n_bits * sps
    prog = _build_ook_link((FiberSpec(**CFG), EDFASpec(G=10, NF=5)),
                           n_bits=n_bits, sps=sps)
    bits, _ = _prbs(23, length=n_ch * n_bits)
    bits = np.asarray(bits.data, np.uint8).reshape(n_ch, n_bits)
    box = {}

    def run():
        box["d"] = prog.dsp_wdm(n_ch, bits=bits, seed=5)

    best = _time(run, reps=2)
    return n_ch * n / best, {
        "n_ch": n_ch, "n_per_ch": n, "wall_s": round(best, 3),
        "max_ber": float(np.max(box["d"].ber)),
        "shortfall": "defined size is 16 x 2^26 sharded over >=2 hosts; "
                     "this is the largest single-chip fit (16 x 2^22)"}


def bench_wdm_shard(n_bits=2**20, sps=64):
    """BASELINE config 5's defined PER-CHIP SHARD: one channel x 2^26
    samples — the slice each of 16 chips owns when the full 16 x 2^26
    config shards channels across 16 devices — receiver-complete
    through the public fused program."""
    import jax
    import jax.numpy as jnp

    from opticomlib_tpu.link import EDFASpec, FiberSpec

    n = n_bits * sps  # 2^26
    prog = _build_ook_link((FiberSpec(**CFG), EDFASpec(G=10, NF=5)),
                           n_bits=n_bits, sps=sps)
    rng = np.random.default_rng(6)
    bits = jnp.asarray(rng.integers(0, 2, n_bits).astype(np.float32))
    seed = jnp.uint32(11)

    def run():
        jax.block_until_ready(prog.jitted(bits, seed)[:2])

    best = _time(run, reps=2)
    return n / best, {"n_samples": n, "wall_s": round(best, 3),
                      "what": "1 ch x 2^26 full chain (per-chip shard of "
                              "the 16-chip sharded config)"}


def main():
    run_all = "--all" in sys.argv
    # importing the package turns on the persistent compilation cache
    # (runtime/cache.py: JAX_COMPILATION_CACHE_DIR wins when set)
    import opticomlib_tpu  # noqa: F401

    ssfm_sps, ssfm_detail = bench_ssfm_headline()
    eqacc_sps, eqacc_detail = bench_ssfm_equal_accuracy()
    chain_sps, chain_detail = bench_full_chain()
    b2b_sps, b2b_detail = bench_b2b_chain()

    detail = {
        **ssfm_detail,
        "equal_accuracy_samples_per_s": round(eqacc_sps, 1),
        "equal_accuracy": eqacc_detail,
        "full_chain_samples_per_s": round(chain_sps, 1),
        "full_chain_wall_s": chain_detail["wall_s"],
        "b2b_chain_samples_per_s": round(b2b_sps, 1),
    }

    if run_all:
        ppm_sps, ppm_d = bench_ppm()
        dbp_sps, dbp_d = bench_dbp()
        dbp_o4 = bench_dbp_o4()
        wdm_sps, wdm_d = bench_wdm_batch()
        shard_sps, shard_d = bench_wdm_shard()
        dsp_sps, dsp_d = bench_fused_dsp()
        all_results = {
            "config1_b2b_chain": {"samples_per_s": round(b2b_sps, 1),
                                  **b2b_detail},
            "config2_ssfm_only": {"samples_per_s": round(ssfm_sps, 1),
                                  **ssfm_detail},
            "config2_ssfm_equal_accuracy": {
                "samples_per_s": round(eqacc_sps, 1), **eqacc_detail},
            "config2_full_chain": {"samples_per_s": round(chain_sps, 1),
                                   **chain_detail},
            "config2_full_dsp": {"samples_per_s": round(dsp_sps, 1),
                                 **dsp_d},
            "config3_ppm8_chain": {"samples_per_s": round(ppm_sps, 1),
                                   **ppm_d},
            "config4_dbp_20x80": {"samples_per_s": round(dbp_sps, 1),
                                  **dbp_d},
            **({"config4_dbp_o4_roundtrip": {
                "samples_per_s": round(dbp_o4[0], 1), **dbp_o4[1]}}
               if dbp_o4 else {}),
            "config5_wdm16_per_chip": {"samples_per_s": round(wdm_sps, 1),
                                       **wdm_d},
            "config5_shard_1x2e26": {"samples_per_s": round(shard_sps, 1),
                                     **shard_d},
        }
        # per-config speedups vs the locally measured CPU reference
        # (scripts/measure_reference.py --all)
        base_path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "BASELINE_MEASURED.json")
        if os.path.exists(base_path):
            with open(base_path) as f:
                ref_cfgs = json.load(f).get("configs", {})
            for k, row in all_results.items():
                r = ref_cfgs.get(k) or (
                    ref_cfgs.get("config2_ssfm_only")
                    if k.startswith("config2") else None)
                if r and r.get("samples_per_s"):
                    row["vs_reference_cpu"] = round(
                        row["samples_per_s"] / r["samples_per_s"], 1)
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BENCH_ALL.json"), "w") as f:
            json.dump(all_results, f, indent=1)
        detail["all"] = {k: v["samples_per_s"]
                         for k, v in all_results.items()}

    vs = 0.0
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_MEASURED.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            ref = json.load(f)
        if ref.get("samples_per_s"):
            vs = ssfm_sps / ref["samples_per_s"]
        # denominator provenance (VERDICT round-3 #5): where the blessed
        # CPU reference number came from and how noisy it was
        detail["baseline_denominator"] = {
            "samples_per_s": ref.get("samples_per_s"),
            "measured_at": ref.get("measured_at"),
            "reps": ref.get("reps"),
            "interleaved": ref.get("interleaved"),
            "spread": ref.get("configs", {}).get(
                "config2_ssfm_only", {}).get("spread"),
        }

    print(json.dumps({
        "metric": "ssfm_2e24_ook_throughput",
        "value": round(ssfm_sps, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(vs, 2),
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
