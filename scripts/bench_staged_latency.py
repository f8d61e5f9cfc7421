"""Measure staged-path (drop-in API) wall-clock per device on the default
backend — the workflow of reference examples/ook_transmission_fiber_simulation.py
at small N, where per-program compile/dispatch cost dominates.

Usage:
    python scripts/bench_staged_latency.py [--cpu] [--json OUT]

Prints one line per stage plus a total; with --json, appends a JSON record
to OUT (used for the before/after table in docs/performance.md).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the in-process CPU backend before any jax use")
    ap.add_argument("--json", default=None)
    ap.add_argument("--N", type=int, default=2**10)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from opticomlib_tpu import gv
    from opticomlib_tpu.devices import PRBS, DAC, LASER, MZM, FIBER, PD
    from opticomlib_tpu.models import ook
    t_import = time.perf_counter() - t_start

    gv(sps=64, R=10e9, wavelength=1550e-9, Vpi=5, N=args.N)

    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        stages[name] = round(time.perf_counter() - t0, 3)
        print(f"  {name:10s} {stages[name]:8.3f} s", flush=True)
        return out

    print(f"import: {t_import:.2f} s  backend={jax.default_backend()}",
          flush=True)
    tx = timed("PRBS", lambda: PRBS(order=9, len=gv.N))
    v = timed("DAC", lambda: DAC(tx, Vpp=gv.Vpi, offset=-gv.Vpi / 2,
                                 pulse_shape="gaussian"))
    las = timed("LASER", lambda: LASER(P0=5))
    mod = timed("MZM", lambda: MZM(las, v, bias=-gv.Vpi / 2, Vpi=gv.Vpi,
                                   loss_dB=3, ER_dB=26))
    fib = timed("FIBER", lambda: FIBER(mod, length=50, alpha=0.2,
                                       beta_2=-20, gamma=2))
    pdo = timed("PD", lambda: PD(fib, BW=gv.R * 0.75, r=1,
                                 include_noise="all"))
    rx_eye_rth = timed("ook.DSP", lambda: ook.DSP(pdo))
    rx = rx_eye_rth[0]
    ber = timed("BER", lambda: ook.BER_analizer("counter", Tx=tx, Rx=rx))

    total = time.perf_counter() - t_start
    print(f"TOTAL {total:.2f} s  (ber={float(ber):.2e})", flush=True)

    if args.json:
        rec = {"N": args.N, "backend": jax.default_backend(),
               "cpu_forced": args.cpu,
               "import_s": round(t_import, 2), "stages": stages,
               "total_s": round(total, 2), "ber": float(ber)}
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    sys.exit(main())
