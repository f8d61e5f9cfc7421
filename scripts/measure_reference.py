"""Measure the reference (armando-palacio/opticomlib) FIBER throughput on
this host's CPU — the comparison baseline for bench.py (the reference
publishes no numbers; BASELINE.md mandates measuring locally).

Denominator hygiene (VERDICT round-3 #5): NumPy timing on a shared
container varies with load, and a single-sample denominator made the
headline ``vs_baseline`` swing 2x round-over-round with the accelerator number
unchanged.  So this script:

* runs every config ``--reps`` times (default 3), **interleaved**
  (config1 rep1, config2 rep1, ..., config1 rep2, ...) so slow phases of
  background load spread across configs instead of biasing one;
* records the per-run wall times and ``os.getloadavg()`` before each
  rep as provenance;
* reports the **median** wall time per config;
* treats an existing BASELINE_MEASURED.json as a FROZEN blessed
  denominator: without ``--bless`` the script measures and prints but
  refuses to overwrite; with ``--bless`` the previous blessed record is
  kept under ``"previous"`` (a history list) in the new file.

Usage:
    python scripts/measure_reference.py [--all] [--reps N] [--bless]
"""
import json
import os
import statistics
import sys
import time
import types

sys.path.insert(0, "/root/reference")
# pympler is absent in this image; the reference only uses it for a
# pretty-printed sizeof, so a zero stub is behavior-neutral here.
m = types.ModuleType("pympler")
a = types.ModuleType("pympler.asizeof")
a.asizeof = lambda x: 0
m.asizeof = a
sys.modules["pympler"] = m
sys.modules["pympler.asizeof"] = a

import numpy as np  # noqa: E402
from opticomlib import gv, optical_signal  # noqa: E402
from opticomlib.devices import FIBER  # noqa: E402

OUT_PATH = "/root/repo/BASELINE_MEASURED.json"

# Bench config (BASELINE.json config 2 flavor): 2^24-sample OOK waveform,
# 50 km NLSE with dispersion + Kerr + attenuation, adaptive steps.
N_BITS = 2**18
SPS = 64
N = N_BITS * SPS  # 2^24 samples
CFG = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3, phi_max=0.01)
PEAK_W = 0.02  # 20 mW peak -> ~130 adaptive steps


# Each builder returns (meta, run): ``run()`` sets the reference's global
# gv itself (runs are interleaved across configs, and gv is mutable
# process state) and executes one full measurement.
def config2():
    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, N_BITS)
    x = np.repeat(bits, SPS).astype(np.float32) * np.sqrt(PEAK_W)
    op = optical_signal(x.astype(np.complex64))

    def run():
        gv(sps=SPS, R=10e9, N=N_BITS)
        FIBER(op, **CFG)

    return {"what": "FIBER 50 km NLSE adaptive", "n_samples": N}, run


def config1():
    """Back-to-back full chain at bench.py's config-1 size (2^18 bits x
    64 sps): PRBS->DAC->LASER->MZM->PD(LPF) — the reference's staged
    pipeline, no fiber (examples/ook_transmission_fiber_simulation.py
    without the FIBER stage)."""
    from opticomlib.devices import DAC, LASER, MZM, PD, PRBS

    def run():
        gv(sps=SPS, R=10e9, N=N_BITS)
        tx = PRBS(order=15, len=N_BITS)
        v = DAC(tx, Vpp=5, offset=-2.5, pulse_shape="gaussian")
        mod = MZM(LASER(P0=16), v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=26)
        PD(mod, BW=gv.R * 0.75, include_noise="all")

    return {"what": "b2b chain PRBS->DAC->LASER->MZM->PD",
            "n_samples": N}, run


def config3(n_sym=2**15, M=8, sps=32):
    """PPM M=8 chain at bench.py's config-3 size: encoder->DAC->
    20 km FIBER->PD->soft DSP."""
    from opticomlib import binary_sequence
    from opticomlib.devices import DAC, PD
    from opticomlib.ppm import DSP, PPM_ENCODER

    n_slots = n_sym * M
    rng = np.random.default_rng(3)
    bits = binary_sequence(rng.integers(0, 2, n_sym * 3))

    def run():
        gv(sps=sps, R=10e9, N=n_slots, M=M)
        tx = PPM_ENCODER(bits, M)
        v = DAC(tx, Vpp=1, pulse_shape="gaussian")
        # ~20 mW peak launch — the SAME power as bench.py's config-3 fused
        # chain (P0=16 dBm, 3 dB MZM loss), so the adaptive step counts
        # match and the ratio compares equal work
        x = optical_signal(np.asarray(v.signal) * np.sqrt(0.02))
        y = FIBER(x, length=20, alpha=0.2, beta_2=-21.0, gamma=1.3)
        pd = PD(y, BW=gv.R * 0.75, include_noise="all")
        DSP(pd, M, decision="soft")

    return {"what": "PPM8 chain encoder->DAC->FIBER 20km->PD->soft DSP, "
                    "20 mW launch (matches the fused chain)",
            "n_samples": n_slots * sps}, run


def config4(n=2**20, sps=16, n_spans=20, span_km=80.0):
    """20x80 km + per-span DBP at bench.py's config-4 size."""
    from opticomlib.devices import DBP

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, n // sps)
    A = (np.repeat(bits, sps) * np.sqrt(0.005)).astype(np.complex64)
    gain = 10 ** (0.2 * span_km / 20)

    def run():
        gv(sps=sps, R=10e9, N=n // sps)
        x = optical_signal(A)
        for _ in range(n_spans):
            x = FIBER(x, length=span_km, alpha=0.2, beta_2=-21.0,
                      gamma=1.3, phi_max=0.05)
            x = optical_signal(np.asarray(x.signal) * gain)
        for _ in range(n_spans):
            x = optical_signal(np.asarray(x.signal) / gain)
            DBPed = DBP(x, length=span_km, alpha=0.2, beta_2=-21.0,
                        gamma=1.3, phi_max=0.05)
            x = DBPed

    return {"what": f"{n_spans}x{span_km:.0f} km + per-span DBP",
            "n_samples": n}, run


def config5(n_ch=16, n_bits=2**18, sps=16, n_measured=4):
    """16-channel WDM sweep at bench.py's config-5 per-chip size and
    WORK: per channel, the same receiver-complete chain bench.py's
    `dsp_wdm` runs (PRBS bits -> DAC -> LASER 16 dBm -> MZM -> 50 km
    adaptive FIBER -> PD -> ook.DSP).  The reference has no batch axis —
    channels run as a host loop, embarrassingly independent — so
    ``n_measured`` channels are timed and scaled to ``n_ch`` (recorded
    in "what" and "scale")."""
    from opticomlib.devices import DAC, LASER, MZM, PD, PRBS
    from opticomlib import ook

    def run():
        gv(sps=sps, R=10e9, N=n_bits)
        for c in range(n_measured):
            tx = PRBS(order=15, len=n_bits)
            v = DAC(tx, Vpp=5, offset=-2.5, pulse_shape="gaussian")
            mod = MZM(LASER(P0=16), v, bias=-2.5, Vpi=5, loss_dB=3,
                      ER_dB=26)
            y = FIBER(mod, length=50.0, alpha=0.2, beta_2=-21.0,
                      gamma=1.3)
            pd = PD(y, BW=gv.R * 0.75, include_noise="all")
            ook.DSP(pd)

    return {"what": f"16x WDM receiver-complete chains (matches dsp_wdm "
                    f"work); {n_measured} of {n_ch} independent channels "
                    "timed and scaled",
            "n_samples": n_ch * n_bits * sps,
            "scale": n_ch / n_measured}, run


def measure(builders, reps):
    """Interleaved repetition: all configs rep 1, all configs rep 2, ...
    Median wall per config + per-run provenance."""
    built = [(name, *builder()) for name, builder in builders]
    walls = {name: [] for name, _, _ in built}
    loads = []
    for r in range(reps):
        loads.append(list(os.getloadavg()))
        for name, _, run in built:
            print(f"[rep {r + 1}/{reps}] {name} ...", flush=True)
            t0 = time.perf_counter()
            run()
            walls[name].append(time.perf_counter() - t0)
    configs = {}
    for name, meta, _ in built:
        w = walls[name]
        med = statistics.median(w)
        scale = meta.pop("scale", 1.0)
        configs[name] = {
            **meta,
            "wall_s": med * scale,
            "samples_per_s": meta["n_samples"] / (med * scale),
            "runs_wall_s": [round(x, 3) for x in w],
            "spread": round((max(w) - min(w)) / med, 3),
        }
        print(json.dumps({name: configs[name]}), flush=True)
    return configs, loads


def main():
    run_all = "--all" in sys.argv
    bless = "--bless" in sys.argv
    reps = (int(sys.argv[sys.argv.index("--reps") + 1])
            if "--reps" in sys.argv else 3)

    builders = [("config2_ssfm_only", config2)]
    if run_all:
        builders = [("config1_b2b_chain", config1),
                    ("config3_ppm8_chain", config3),
                    ("config4_dbp_20x80", config4),
                    ("config5_wdm16_per_chip", config5),
                    ("config2_ssfm_only", config2)]

    configs, loads = measure(builders, reps)

    result = {
        "what": "reference opticomlib FIBER, NumPy CPU backend",
        "config": CFG,
        "n_samples": N,
        "peak_power_W": PEAK_W,
        "host": "bench container CPU",
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "reps": reps,
        "interleaved": True,
        "loadavg_per_rep": loads,
        "cpu_count": os.cpu_count(),
        "configs": configs,
    }
    c2 = configs.get("config2_ssfm_only")
    if c2:
        result["wall_s"] = c2["wall_s"]
        result["samples_per_s"] = c2["samples_per_s"]
    print(json.dumps({k: v for k, v in result.items() if k != "configs"}))

    if os.path.exists(OUT_PATH) and not bless:
        print(f"{OUT_PATH} exists — the blessed denominator is FROZEN; "
              "not overwriting.  Re-run with --bless to deliberately "
              "re-measure (the old record is archived under 'previous').",
              file=sys.stderr)
        return
    if os.path.exists(OUT_PATH):
        with open(OUT_PATH) as f:
            old = json.load(f)
        prev = old.pop("previous", [])
        prev.append(old)
        result["previous"] = prev
    with open(OUT_PATH, "w") as f:
        json.dump(result, f, indent=2)
    print(f"blessed -> {OUT_PATH}")


if __name__ == "__main__":
    main()
