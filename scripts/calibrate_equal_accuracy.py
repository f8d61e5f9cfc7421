"""Equal-accuracy calibration for the SSFM headline (VERDICT round-3 #1).

The reference's only scheme is the 2nd-order frozen-operator symmetric
split step with phi_max-adaptive stepping (reference
devices.py:1156/1172-1196); the repo's headline bench reports throughput
at *step parity* with it.  But the framework also ships higher-order
schemes (``ssfm_scan_o4``: Yoshida 4th-order composition;
``ssfm_local_error``: Sinkin local-error control + Richardson) that reach
the SAME output error with far fewer FFT pairs — the honest competitive
number is throughput at **equal output accuracy**, not equal step count.

Methodology (all on the benchmark hardware, full 2^24-sample config 2):

1. TRUTH: o4 at h = 0.05 km (1000 steps).  Its splitting error scales as
   h^4, so truth error is ~(0.05/2.5)^4 ~ 1e-7 of the candidates'; a
   cross-check against the *local-error* scheme (a genuinely different
   discretization: adaptive true-Strang steps + Richardson
   extrapolation) at tol=1e-5 is reported — it measures the float32
   accumulation floor, the real limit on any float32 run at this size.
2. REFERENCE ERROR: run the reference scheme (phi_max = 0.01 adaptive,
   the bench headline config) and record its relative L2 output error
   vs truth.
3. MATCH: largest o4 step h (grid search) whose error <= the reference
   error; largest ``local_error`` tol likewise.

Writes EQUAL_ACCURACY.json at the repo root; bench.py reads it to bench
the matched schemes as the equal-accuracy headline row.

Usage: python scripts/calibrate_equal_accuracy.py [--n 24]
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_BITS_LOG2 = 18
SPS = 64
R = 10e9
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3)
PHI_MAX = 0.01
PEAK_W = 0.02


def main():
    import jax
    import jax.numpy as jnp

    import opticomlib_tpu  # noqa: F401  (enables the compile cache)
    from opticomlib_tpu.ops import ssfm

    n_bits = 2 ** N_BITS_LOG2
    if "--n" in sys.argv:
        n_bits = 2 ** (int(sys.argv[sys.argv.index("--n") + 1]) - 6)
    n = n_bits * SPS

    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, n_bits)
    A = (np.repeat(bits, SPS) * np.sqrt(PEAK_W)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n) * R * SPS
    phi_w = jax.device_put(ssfm.dispersion_phase(w, CFG["beta_2"], 0.0))
    a_km = ssfm.alpha_per_km(CFG["alpha"])
    Are = jax.device_put(np.ascontiguousarray(A.real))
    Aim = jax.device_put(np.ascontiguousarray(A.imag))

    # while-loop o4 with h as a TRACED scalar: ONE compile serves the
    # whole candidate grid (the scan variant recompiles per step count,
    # which would dominate the calibration)
    @jax.jit
    def _o4_while(re, im, phi_w, h, gamma, alpha):
        x = jax.lax.complex(re, im)
        length = jnp.float32(CFG["length"])
        gamma = jnp.float32(gamma)
        alpha = jnp.float32(alpha)
        w1 = jnp.float32(ssfm._W1)
        w0 = jnp.float32(ssfm._W0)

        # same float32 stall guard as ops/ssfm.py: when the remaining
        # distance drops below ulp(z), z + h == z and the loop would
        # spin — clamp the step to a floor (bounded overshoot < 1e-7 L)
        h_floor = length * jnp.float32(1.5e-7)

        def cond(c):
            _, z, k = c
            return jnp.logical_and(z < length, k < jnp.int32(400_000))

        def body(c):
            x, z, k = c
            hh = jnp.maximum(jnp.minimum(h, length - z), h_floor)
            for wgt in (w1, w0, w1):
                x = ssfm._strang_step(x, phi_w, alpha, hh * wgt, gamma)
            return x, z + hh, k + 1

        x, _, k = jax.lax.while_loop(
            cond, body, (x, jnp.float32(0.0), jnp.int32(0)))
        return x.real, x.imag, k

    def run_o4(h):
        t0 = time.perf_counter()
        re, im, k = _o4_while(Are, Aim, phi_w, jnp.float32(h),
                              CFG["gamma"], a_km)
        out = np.asarray(re) + 1j * np.asarray(im)   # readback = sync
        return out, time.perf_counter() - t0, 3 * int(k)

    def run_ref():
        maxP0 = float(np.max(A.real ** 2 + A.imag ** 2))
        h0 = min(PHI_MAX / (CFG["gamma"] * maxP0), CFG["length"])
        t0 = time.perf_counter()
        re, im, steps = ssfm._ssfm_loop(Are, Aim, phi_w, CFG["length"],
                                        CFG["gamma"], PHI_MAX, h0, a_km,
                                        adaptive=True)
        out = np.asarray(re) + 1j * np.asarray(im)
        return out, time.perf_counter() - t0, int(steps)

    def run_le(tol, h0):
        t0 = time.perf_counter()
        re, im, steps = ssfm._ssfm_local_error_loop(
            Are, Aim, phi_w, CFG["length"], CFG["gamma"], tol, h0, a_km)
        out = np.asarray(re) + 1j * np.asarray(im)
        return out, time.perf_counter() - t0, 3 * int(steps)

    def rel_err(x, ref):
        return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))

    print(f"[calibrate] n = 2^{int(np.log2(n))} samples", flush=True)
    truth, t_truth, _ = run_o4(0.05)
    print(f"[calibrate] truth (o4 h=0.05): {t_truth:.1f} s", flush=True)
    # cross-check truth against a genuinely DIFFERENT discretization
    # family (round-4 advisor fix: o4-vs-o4 shares splitting-error
    # structure): the local-error scheme = adaptive true-Strang steps +
    # Richardson extrapolation
    xchk, _, _ = run_le(1e-5, h0=1.0)
    truth_xcheck = rel_err(xchk, truth)
    print(f"[calibrate] truth cross-check (local_error tol=1e-5): "
          f"{truth_xcheck:.3g}", flush=True)

    def run_ref_at(phi_max):
        maxP0 = float(np.max(A.real ** 2 + A.imag ** 2))
        h0 = min(phi_max / (CFG["gamma"] * maxP0), CFG["length"])
        t0 = time.perf_counter()
        re, im, steps = ssfm._ssfm_loop(Are, Aim, phi_w, CFG["length"],
                                        CFG["gamma"], phi_max, h0, a_km,
                                        adaptive=True)
        out = np.asarray(re) + 1j * np.asarray(im)
        return out, time.perf_counter() - t0, int(steps)

    ref_out, t_ref, ref_steps = run_ref()
    ref_error = rel_err(ref_out, truth)
    print(f"[calibrate] reference scheme (phi_max={PHI_MAX}): "
          f"{ref_steps} steps, {t_ref:.2f} s, rel err {ref_error:.3g}",
          flush=True)

    o4_match = None
    for h in (12.5, 10.0, 8.0, 6.25, 5.0, 4.0, 3.0, 2.5, 2.0, 1.5, 1.0):
        out, t, ffts = run_o4(h)
        e = rel_err(out, truth)
        print(f"[calibrate] o4 h={h}: {ffts} FFT-pairs, {t:.2f} s, "
              f"rel err {e:.3g}", flush=True)
        if e <= ref_error:
            o4_match = {"h": h, "error": e, "fft_pairs": ffts,
                        "wall_s": round(t, 3)}
            break

    le_match = None
    for tol in (3e-4, 1e-4, 3e-5, 1e-5):
        out, t, ffts = run_le(tol, h0=5.0)
        e = rel_err(out, truth)
        print(f"[calibrate] local_error tol={tol}: {ffts} FFT-pairs, "
              f"{t:.2f} s, rel err {e:.3g}", flush=True)
        if e <= ref_error:
            le_match = {"tol": tol, "error": e, "fft_pairs": ffts,
                        "wall_s": round(t, 3)}
            break

    # ---- tight-accuracy comparison: where the 4th-order scheme's
    # advantage actually lives.  The target is 8.0e-3 — ~2.1x tighter
    # than the reference default and above the float32 accumulation
    # floor (measured at 2^24: the cross-scheme truth check is 3.0e-3
    # and o4 plateaus at ~7e-3 regardless of h — per-step float32
    # rounding random-walks to a few 1e-3 relative L2; targets below
    # the floor are not meaningfully reachable by EITHER scheme in
    # float32, and a target AT the floor straddles run-to-run noise,
    # which round 4's 7.6e-3 target did). ----
    TIGHT = 8.0e-3
    tight_ref = None
    for pm in (0.004, 0.002, 0.001, 0.0005, 0.00025):
        out, t, steps = run_ref_at(pm)
        e = rel_err(out, truth)
        print(f"[calibrate] TIGHT ref phi_max={pm}: {steps} FFT-pairs, "
              f"{t:.2f} s, rel err {e:.3g}", flush=True)
        if e <= TIGHT:
            tight_ref = {"phi_max": pm, "error": e, "fft_pairs": steps,
                         "wall_s": round(t, 3)}
            break
    tight_o4 = None
    for h in (1.25, 1.0, 0.8, 0.625, 0.5, 0.4, 0.3):
        out, t, ffts = run_o4(h)
        e = rel_err(out, truth)
        print(f"[calibrate] TIGHT o4 h={h}: {ffts} FFT-pairs, {t:.2f} s, "
              f"rel err {e:.3g}", flush=True)
        if e <= TIGHT:
            tight_o4 = {"h": h, "error": e, "fft_pairs": ffts,
                        "wall_s": round(t, 3)}
            break

    result = {
        "config": {**CFG, "phi_max": PHI_MAX, "sps": SPS, "R": R,
                   "peak_W": PEAK_W, "n_samples": n},
        "truth": {"scheme": "o4", "h": 0.05,
                  "cross_check_scheme": "local_error tol=1e-5",
                  "cross_check_rel_err": truth_xcheck},
        "reference_scheme": {"phi_max": PHI_MAX, "n_steps": ref_steps,
                             # one fft+ifft pair per step
                             "fft_pairs": ref_steps,
                             "error": ref_error,
                             "wall_s": round(t_ref, 3)},
        "o4": o4_match,
        "local_error": le_match,
        "tight": {"target_error": TIGHT, "reference_scheme": tight_ref,
                  "o4": tight_o4},
        "method": "largest step/tol whose relative L2 output error vs an "
                  "o4 h=0.05 truth run is <= the reference scheme's "
                  "error at phi_max=0.01 (same waveform, same hardware)",
    }
    path = os.path.join(ROOT, "EQUAL_ACCURACY.json")
    if os.path.exists(path):
        # preserve entries owned by other calibrators (e.g. "config4"
        # from scripts/calibrate_dbp_o4.py)
        old = json.load(open(path))
        old.update(result)
        result = old
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[calibrate] wrote {path}")


if __name__ == "__main__":
    main()
