"""Run the optical-link simulator once on the GPU, through its public entry
points, and check what comes out.

    python chip_smoke.py          one GPU: phases staged, fused, reference,
                                  fft_len, step, complex_io
    python chip_smoke.py --four   four GPUs of one host: the time-sharded
                                  fused link, channel-sharded WDM receivers
                                  and the span pipeline, each against the
                                  same work on one card; no other phase

It exits non-zero, without printing a result line, when the default JAX
device is not a GPU or when any phase fails.  Each phase prints one line
``phase <name> {...}`` with the card's name and power limit; the last
line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.

The phase functions take their sizes as arguments, so the tests run them
at small sizes on the CPU.  Run from the root of a checkout: the float64
NumPy reference stepper is imported from ``tests/ssfm_reference.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

R = 10e9
CONFIG2 = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
               phi_max=0.01)
SPAN80 = dict(alpha=0.2, beta_2=-21.0, beta_3=0.0, gamma=1.3)


def card_labels() -> list:
    """``name, power.limit`` of each card, from nvidia-smi in a child
    process that does not import JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def _timed(fn, reps: int = 5):
    """Best and median wall time [s] of ``fn()`` (which must end in
    ``block_until_ready``), after one untimed warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), float(np.median(ts))


def _peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def _config2_spec(stages=None, noise=True):
    from opticomlib_tpu.link import EDFASpec, FiberSpec, LinkSpec

    if stages is None:
        stages = (FiberSpec(**CONFIG2), EDFASpec(G=10, NF=5 if noise
                                                 else None))
    return LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
                    pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                    stages=tuple(stages), pd_BW=0.75 * R,
                    include_thermal=noise, include_shot=noise)


# ----------------------------------------------------------------------
# one card
# ----------------------------------------------------------------------
def phase_staged(Ns=(2**10, 2**16)):
    """The README quickstart as written, at each ``N`` (sps = 64).  BER
    must be 0; on a device that reports memory, the device's peak bytes
    after FIBER must cover the propagated field (re + im float32), which
    shows the split-step ran there."""
    import jax

    from opticomlib_tpu import gv, ook
    from opticomlib_tpu.devices import DAC, FIBER, LASER, MZM, PD, PRBS

    dev = jax.devices()[0]
    out = {}
    for N in Ns:
        t0 = time.perf_counter()
        gv(sps=64, R=10e9, wavelength=1550e-9, Vpi=5, N=N)

        tx = PRBS(order=9, len=gv.N)
        v = DAC(tx, Vpp=gv.Vpi, offset=-gv.Vpi/2, pulse_shape="gaussian")
        mod = MZM(LASER(P0=5), v, bias=-gv.Vpi/2, Vpi=gv.Vpi, loss_dB=3,
                  ER_dB=26)
        fib = FIBER(mod, length=50, alpha=0.2, beta_2=-20, gamma=2)
        peak = _peak_bytes(dev)
        pdo = PD(fib, BW=gv.R*0.75, r=1, include_noise="all")

        rx, eye, rth = ook.DSP(pdo)
        ber = ook.BER_analizer("counter", Tx=tx, Rx=rx)
        wall = time.perf_counter() - t0

        n = N * 64
        if dev.platform == "gpu" and (peak is None or peak < 8 * n):
            raise AssertionError(
                f"N={N}: device peak {peak} B after FIBER is below the "
                f"{8 * n} B field: the split-step did not run on {dev}")
        if float(ber) != 0.0:
            raise AssertionError(f"N={N}: BER {float(ber)} != 0")
        out[f"N={N}"] = {"samples": n, "ber": float(ber),
                         "threshold": float(rth), "wall_s": wall,
                         "fiber_s": fib.execution_time,
                         "device_peak_bytes_after_fiber": peak}
    gv.default()
    return out


def phase_fused(n_bits=2**18, sps=64, seed=3):
    """BASELINE config 2 through ``build_link(...).dsp``: TX -> 50 km
    adaptive SSFM -> EDFA -> PD -> LPF -> eye -> threshold -> BER as one
    program.  The SSFM step count comes from the same adaptive loop run
    alone on the launched field (``return_field`` of the link without
    stages)."""
    import jax
    import jax.numpy as jnp

    from opticomlib_tpu.link import build_link
    from opticomlib_tpu.ops import ssfm
    from opticomlib_tpu.params import SimParams

    dev = jax.devices()[0]
    params = SimParams.create(sps=sps, R=R, _warn=False)
    n = n_bits * sps
    prog = build_link(_config2_spec(), n_bits=n_bits, params=params)
    t0 = time.perf_counter()
    d = prog.dsp(seed=seed)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = prog.dsp(seed=seed)
    warm = time.perf_counter() - t0
    if not np.isfinite(d.threshold) or d.ber != 0.0:
        raise AssertionError(f"config 2: BER {d.ber}, threshold "
                             f"{d.threshold}")

    # the adaptive split-step alone, on the field config 2 launches
    b2b = build_link(_config2_spec(stages=()), n_bits=n_bits,
                     params=params, return_field=True)
    bits = jnp.asarray(d.tx.to_numpy(np.float32))
    launch = b2b.jitted(bits, jnp.uint32(seed))
    re, im = launch[2], launch[3]
    w = 2 * np.pi * np.fft.fftfreq(n, 1 / params.fs)
    phi_w = jnp.asarray(ssfm.dispersion_phase(w, CONFIG2["beta_2"], 0.0))
    maxP0 = float(jnp.max(re * re + im * im))
    h0 = ssfm.adaptive_h0(CONFIG2["phi_max"], CONFIG2["gamma"], maxP0,
                          CONFIG2["length"])
    a_km = ssfm.alpha_per_km(CONFIG2["alpha"])

    def loop():
        return jax.block_until_ready(ssfm._ssfm_loop(
            re, im, phi_w, CONFIG2["length"], CONFIG2["gamma"],
            CONFIG2["phi_max"], h0, a_km, adaptive=True))

    steps = int(loop()[2])
    best, _ = _timed(loop, reps=3)
    return {"samples": n, "ber": d.ber, "n_errors": d.n_errors,
            "threshold": d.threshold, "ssfm_steps": steps,
            "dsp_first_call_s": first, "dsp_warm_s": warm,
            "ssfm_only_s": best, "ssfm_only_samples_per_s": n / best,
            "device_peak_bytes": _peak_bytes(dev)}


def _roundtrip_error(x, k, device):
    """Relative L2 error of ``k`` complex64 fft -> ifft round trips of
    ``x`` on ``device``: the FFT library's own rounding, accumulated."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a: jax.lax.fori_loop(
        0, k, lambda i, y: jnp.fft.ifft(jnp.fft.fft(y)), a))
    y = f(jax.device_put(x.astype(np.complex64), device))
    return float(np.linalg.norm(np.asarray(y) - x) / np.linalg.norm(x))


def phase_reference(n=2**20, sps=16, length=80.0, h_ref=0.5, h_o4=2.0):
    """The SSFM on the default device and on the CPU (both complex64)
    against the float64 NumPy stepper, for the fixed-step ``reference``
    scheme and for ``o4`` on the same step schedule.  Config 4's window:
    one 80 km span, ``n`` samples at 5 mW peak.

    The yardstick is the CPU's float32 error.  cuFFT's float32 round trip
    loses accuracy faster than the CPU's FFT, so the same number of bare
    fft -> ifft round trips is measured on both devices in this call, and
    the device may reach at most twice the CPU's error scaled by that
    ratio: the split-step must add no error beyond what its FFT library
    explains (a TF32 contraction or a wrong step would add far more)."""
    import jax

    from opticomlib_tpu.ops import ssfm

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import ssfm_reference as ref64

    rng = np.random.default_rng(4)
    A = (np.repeat(rng.integers(0, 2, n // sps), sps)
         * np.sqrt(0.005)).astype(np.complex64)
    w = 2 * np.pi * np.fft.fftfreq(n, 1 / (R * sps))
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    runs = {
        "reference": (lambda: ssfm.ssfm_propagate(A, w, length, h=h_ref,
                                                  **SPAN80),
                      dict(h=h_ref, scheme="reference"), 1),
        "o4": (lambda: ssfm.ssfm_scan_o4(A, w, length, h=h_o4, **SPAN80),
               dict(h=h_o4, scheme="o4"), 3),
    }
    out = {"samples": n, "length_km": length,
           "precision": "complex64 (float32) SSFM and FFTs on the device "
                        "and on the CPU, no matmul; complex128 NumPy "
                        "reference"}
    for name, (run, kw, pairs_per_step) in runs.items():
        A64 = A.astype(np.complex128)
        truth, n_steps = ref64.propagate(A64, w, length, **SPAN80, **kw)
        err_dev = ref64.rel_l2(run(), truth)
        with jax.default_device(cpu):
            err_cpu = ref64.rel_l2(run(), truth)
        k = n_steps * pairs_per_step
        rt_dev = _roundtrip_error(A64, k, dev)
        rt_cpu = _roundtrip_error(A64, k, cpu)
        fft_ratio = max(1.0, rt_dev / rt_cpu)
        bound = 2 * err_cpu * fft_ratio
        out[name] = {"h_km": kw["h"], "steps": n_steps, "fft_pairs": k,
                     "rel_l2_device": err_dev, "rel_l2_cpu_f32": err_cpu,
                     "device_over_cpu": err_dev / err_cpu,
                     "fft_roundtrips_rel_l2_device": rt_dev,
                     "fft_roundtrips_rel_l2_cpu": rt_cpu,
                     "bound": bound}
        if not err_dev <= bound:
            raise AssertionError(
                f"{name}: device error {err_dev:.3e} exceeds twice the "
                f"CPU float32 error {err_cpu:.3e} times the FFT round-trip "
                f"ratio {fft_ratio:.2f}")
    return out


def phase_fft_len(n_bits=2**18, sps=64, fir_taps=1025):
    """``fft_convolve_same`` at config 2's width with power-of-two and
    with 5-smooth padding: the staged DAC's Gaussian pulse (span
    ``n_bits - 4``) and a FIR low-pass of ``fir_taps``.  Both paddings
    must give the same convolution."""
    import jax
    import jax.numpy as jnp

    from opticomlib_tpu.ops import pulses

    n = n_bits * sps
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=n).astype(np.float32))
    shapes = {
        "dac": pulses.gauss_pulse(span=n_bits - 4, sps=sps).real,
        "fir_lpf": np.hanning(fir_taps),
    }
    out = {}
    for name, taps in shapes.items():
        h = jnp.asarray(np.asarray(taps, np.float32))
        m = h.shape[-1]
        row = {"x": n, "taps": m}
        ys = []
        for tag, nfft in (("pow2", 1 << (n + m - 2).bit_length()),
                          ("smooth5", pulses._next_fast_len(n + m - 1))):
            f = jax.jit(lambda a, b, nfft=nfft:
                        pulses._fft_convolve(a, b, nfft))
            t0 = time.perf_counter()
            f = f.lower(x, h).compile()
            compile_s = time.perf_counter() - t0
            ys.append(np.asarray(f(x, h)))
            best, med = _timed(lambda: f(x, h).block_until_ready())
            row[tag] = {"nfft": nfft, "best_ms": best * 1e3,
                        "median_ms": med * 1e3, "compile_s": compile_s}
        scale = float(np.max(np.abs(ys[0])))
        if not np.max(np.abs(ys[0] - ys[1])) <= 1e-4 * scale:
            raise AssertionError(f"{name}: paddings disagree")
        row["rule_pads_to"] = pulses._next_fast_len(n + m - 1)
        out[name] = row
    return out


def phase_step(n=2**24, iters=20):
    """Time one SSFM step (NL-L-NL with a precomputed linear factor) and
    the bare FFT+IFFT pair at ``n`` samples, each as ``iters`` iterations
    of a ``fori_loop`` in one program (per-iteration time reported),
    compile time separately."""
    import jax
    import jax.numpy as jnp

    from opticomlib_tpu.ops import ssfm

    rng = np.random.default_rng(6)
    A = jnp.asarray(((rng.normal(size=n) + 1j * rng.normal(size=n))
                     * 0.1).astype(np.complex64))
    w = 2 * np.pi * np.fft.fftfreq(n, 1 / (R * 64))
    phi_w = jnp.asarray(ssfm.dispersion_phase(w, CONFIG2["beta_2"], 0.0))
    alpha = jnp.float32(ssfm.alpha_per_km(CONFIG2["alpha"]))
    h = jnp.float32(0.5)
    gamma = jnp.float32(CONFIG2["gamma"])
    E = ssfm._lin_factor(phi_w, alpha, h)

    def pair(a):
        return jnp.fft.ifft(jnp.fft.fft(a))

    def step(a, E):
        return ssfm._nl_l_nl_step(a, None, alpha, h, gamma, E=E)

    out = {"samples": n, "iters": iters}
    for name, body in (("fft_pair", lambda a, E: pair(a)),
                       ("ssfm_step", step)):
        f = jax.jit(lambda a, E, body=body: jax.lax.fori_loop(
            0, iters, lambda i, x: body(x, E), a))
        t0 = time.perf_counter()
        f = f.lower(A, E).compile()
        compile_s = time.perf_counter() - t0
        best, med = _timed(lambda: f(A, E).block_until_ready(), reps=3)
        if not np.isfinite(np.asarray(f(A, E)[:16])).all():
            raise AssertionError(f"{name}: non-finite output")
        out[name] = {"per_iter_ms": best / iters * 1e3,
                     "per_iter_median_ms": med / iters * 1e3,
                     "compile_s": compile_s}
    out["step_over_pair"] = (out["ssfm_step"]["per_iter_ms"]
                             / out["fft_pair"]["per_iter_ms"])
    return out


def phase_complex_io(n=4096):
    """Whether a complex64 array crosses host->device, a jit boundary
    and device->host intact."""
    import jax

    rng = np.random.default_rng(7)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    xd = jax.device_put(x)
    back = np.asarray(xd)
    y = jax.jit(lambda a: a * np.complex64(1 - 2j))(xd)
    res = {"dtype_on_device": str(xd.dtype),
           "device": str(next(iter(y.devices()))),
           "host_roundtrip_exact": bool(np.array_equal(back, x)),
           "jit_in_out_matches": bool(np.allclose(
               np.asarray(y), x * np.complex64(1 - 2j), rtol=1e-6))}
    if not (res["host_roundtrip_exact"] and res["jit_in_out_matches"]):
        raise AssertionError(f"complex64 boundary: {res}")
    return res


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------
def phase_four_time_sharded(n_bits=2**20, sps=64, seeds=(1, 2, 3)):
    """Config 2 with the sample axis sharded over 4 devices (pencil FFT)
    against the same spec on one device.  Noise off: the PD voltages
    agree to 1e-4 of full scale (float32 FFT rounding of two different
    FFT decompositions over ~100 adaptive steps).  Noise on: noise is
    drawn block-locally, so the draws differ; the BERs must be equal and
    the mean thresholds over ``seeds`` within five standard errors."""
    import jax

    from opticomlib_tpu.link import build_link
    from opticomlib_tpu.parallel.fiber import make_link_mesh
    from opticomlib_tpu.params import SimParams

    mesh = make_link_mesh(n_wdm=1, n_time=4)
    params = SimParams.create(sps=sps, R=R, _warn=False)
    bits = np.random.default_rng(8).integers(0, 2, n_bits).astype(
        np.float32)
    out = {"samples": n_bits * sps, "mesh": dict(mesh.shape)}

    quiet = _config2_spec(noise=False)
    t0 = time.perf_counter()
    v4 = build_link(quiet, n_bits, params=params, mesh=mesh).run(
        bits=bits, seed=0).v
    out["noiseless_sharded_s"] = time.perf_counter() - t0
    v1 = build_link(quiet, n_bits, params=params).run(
        bits=bits, seed=0).v.to_numpy()
    err = float(np.max(np.abs(v4 - v1)) / np.max(np.abs(v1)))
    out["noiseless_max_err_over_scale"] = err
    if not err <= 1e-4:
        raise AssertionError(f"time-sharded waveform differs: {err:.3e}")

    spec = _config2_spec()
    p4 = build_link(spec, n_bits, params=params, mesh=mesh)
    p1 = build_link(spec, n_bits, params=params)
    r4 = [p4.dsp(seed=s) for s in seeds]
    t0 = time.perf_counter()
    p4.dsp(seed=seeds[0])
    out["dsp_sharded_warm_s"] = time.perf_counter() - t0
    r1 = [p1.dsp(seed=s) for s in seeds]
    t0 = time.perf_counter()
    p1.dsp(seed=seeds[0])
    out["dsp_one_device_warm_s"] = time.perf_counter() - t0
    th4 = np.array([r.threshold for r in r4])
    th1 = np.array([r.threshold for r in r1])
    se = np.sqrt(th4.var(ddof=1) / len(seeds) + th1.var(ddof=1)
                 / len(seeds))
    out.update(ber_sharded=[r.ber for r in r4],
               ber_one_device=[r.ber for r in r1],
               threshold_sharded=th4.tolist(),
               threshold_one_device=th1.tolist(), threshold_se=float(se))
    if [r.ber for r in r4] != [r.ber for r in r1]:
        raise AssertionError("time-sharded BER differs from one device")
    if not abs(th4.mean() - th1.mean()) <= 5 * se + 1e-6 * abs(th1.mean()):
        raise AssertionError("time-sharded threshold outside the spread")
    return out


def phase_four_wdm(n_bits=2**18, sps=64, n_ch=4):
    """``dsp_wdm`` with the channel axis sharded over 4 devices against
    the unsharded vmapped ``dsp_wdm`` at the same seeds."""
    import jax
    from jax.sharding import Mesh

    from opticomlib_tpu.link import build_link
    from opticomlib_tpu.params import SimParams

    params = SimParams.create(sps=sps, R=R, _warn=False)
    prog = build_link(_config2_spec(), n_bits, params=params)
    mesh = Mesh(np.array(jax.devices()[:4]), ("wdm",))
    t0 = time.perf_counter()
    a = prog.dsp_wdm(n_ch, seed=0, mesh=mesh)
    first = time.perf_counter() - t0
    b = prog.dsp_wdm(n_ch, seed=0)
    np.testing.assert_array_equal(a.ber, b.ber)
    np.testing.assert_allclose(a.threshold, b.threshold, rtol=1e-4,
                               atol=1e-7)
    return {"channels": n_ch, "samples_per_channel": n_bits * sps,
            "ber": np.asarray(a.ber).tolist(),
            "threshold_sharded": np.asarray(a.threshold).tolist(),
            "threshold_one_device": np.asarray(b.threshold).tolist(),
            "sharded_first_call_s": first}


def phase_four_pipeline(n_bits=2**17, sps=8, n_spans=4):
    """``build_link(..., span_mesh=make_span_mesh(4))`` on a fiber+EDFA /
    DBP stage list (``n_spans`` of each, ``n_bits * sps`` samples per
    channel, PD noise off) against the same stages run in order on one
    device."""
    from opticomlib_tpu.link import (DBPSpec, EDFASpec, FiberSpec,
                                     LinkSpec, RepeatSpec, build_link)
    from opticomlib_tpu.parallel.pipeline import make_span_mesh
    from opticomlib_tpu.params import SimParams

    params = SimParams.create(sps=sps, R=R, _warn=False)
    stages = (
        RepeatSpec(n_spans, (FiberSpec(length=5, alpha=0.2, beta_2=-21.0,
                                       gamma=1.3, h=1.0),
                             EDFASpec(G=1.0))),
        RepeatSpec(n_spans, (DBPSpec(length=5, alpha=0.2, beta_2=-21.0,
                                     gamma=1.3, h=1.0,
                                     undo_gain_dB=1.0),)),
    )
    spec = LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
                    pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                    stages=stages, pd_BW=7.5e9, include_thermal=False,
                    include_shot=False)
    t0 = time.perf_counter()
    sw_p = build_link(spec, n_bits, params=params,
                      span_mesh=make_span_mesh(4)).dsp_wdm(4, seed=0)
    first = time.perf_counter() - t0
    sw_s = build_link(spec, n_bits, params=params).dsp_wdm(
        4, bits=sw_p.tx, seed=0)
    np.testing.assert_array_equal(sw_p.ber, sw_s.ber)
    np.testing.assert_allclose(sw_p.threshold, sw_s.threshold, rtol=1e-4,
                               atol=1e-6)
    return {"channels": 4, "samples_per_channel": n_bits * sps,
            "ber": np.asarray(sw_p.ber).tolist(),
            "threshold_pipelined": np.asarray(sw_p.threshold).tolist(),
            "threshold_one_device": np.asarray(sw_s.threshold).tolist(),
            "pipelined_first_call_s": first}


PHASES_ONE = {"staged": phase_staged, "fused": phase_fused,
              "reference": phase_reference, "fft_len": phase_fft_len,
              "step": phase_step, "complex_io": phase_complex_io}
PHASES_FOUR = {"time_sharded": phase_four_time_sharded,
               "wdm_sharded": phase_four_wdm,
               "span_pipeline": phase_four_pipeline}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU phases instead")
    args = ap.parse_args(argv)

    import jax

    import opticomlib_tpu  # noqa: F401  (turns on the compile cache)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: the default JAX device is {devs[0]}, not a "
              f"GPU", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    cards = card_labels()
    for i, c in enumerate(cards):
        print(f"card {i}: {c}", flush=True)
    label = cards[0]
    for name, fn in (PHASES_FOUR if args.four else PHASES_ONE).items():
        t0 = time.perf_counter()
        res = fn()
        res["phase_s"] = time.perf_counter() - t0
        print(f"phase {name} {json.dumps(res)} | card: {label}", flush=True)
    print(f"card: {label}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
