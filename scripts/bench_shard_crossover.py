"""Pencil-FFT vs overlap-save crossover measurement for the sharded SSFM
(round-5, VERDICT item 4: the 'pencil' default was chosen from expected-
cost arithmetic, not measurement).

Benches ``ssfm_sharded`` with both ``shard_method``s on the 8-virtual-
device CPU mesh at n in {2^20, 2^22, 2^24} for two physics shapes:

* config-2-like: h=1.0 (halo ~109 samples/side), and
* config-4-span-like: h=0.5 — the halo scales linearly with h, so this
  is the SMALLER-halo shape (~55/side) with ~3x the step count.

The relevant structural quantity is ``2H / block``: overlap-save does a
local FFT of ``block + 2H`` samples per device per step (plus 2 ppermute
of H samples), while pencil does an exact distributed FFT (2 all_to_all
of the whole block).  When ``2H/block`` is small, overlap's FFT is
barely larger than the block and it wins on interconnect; as the halo
approaches the block, overlap loses both accuracy and speed.

Writes CROSSOVER.json at the repo root (docs/performance.md cites it)
and prints the per-cell table.  ``shard_method='auto'`` uses the
measured threshold (see opticomlib_tpu/parallel/fiber.py).

Usage: [XLA_FLAGS=...count=8] python scripts/bench_shard_crossover.py
       [--sizes 20,22,24] [--reps 3] [--devices]

Without ``--devices`` it measures on the 8-virtual-device CPU mesh; with
it, on the default devices (e.g. the GPUs of one host).
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")


def main():
    import jax

    # the 8-virtual-device CPU mesh unless --devices asks for the
    # default devices
    if "--devices" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from opticomlib_tpu.parallel.fiber import make_link_mesh, ssfm_sharded
    from opticomlib_tpu.parallel.halo import halo_width

    sizes = [20, 22, 24]
    reps = 3
    if "--sizes" in sys.argv:
        sizes = [int(s) for s in
                 sys.argv[sys.argv.index("--sizes") + 1].split(",")]
    if "--reps" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--reps") + 1])

    mesh = make_link_mesh(n_wdm=1, n_time=len(jax.devices()))
    n_dev = len(jax.devices())
    fs = 10e9 * 64

    # per-step cost is what crosses over, so short spans at the same h
    # measure the same ratio with 4x fewer steps (12/25 steps per run
    # instead of 50/160 — the 8-thread virtual mesh is slow)
    shapes = {
        "config2": dict(length=12.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                        h=1.0),
        "config4_span": dict(length=12.0, alpha=0.2, beta_2=-21.0,
                             gamma=1.3, h=0.5),
    }

    cells = []
    for log2n in sizes:
        n = 1 << log2n
        rng = np.random.default_rng(7)
        A0 = ((rng.normal(size=n) + 1j * rng.normal(size=n))
              .astype(np.complex64) * np.sqrt(0.01))
        for shape_name, kw in shapes.items():
            block = n // n_dev
            H = halo_width(kw["h"], kw["beta_2"], 0.0, fs)
            row = {"n_log2": log2n, "shape": shape_name,
                   "halo_H": H, "block": block,
                   "halo_frac": round(2 * H / block, 4)}
            for method in ("pencil", "overlap"):
                def run():
                    return ssfm_sharded(A0, mesh, fs=fs, method=method,
                                        **kw).block_until_ready()

                run()  # warmup/compile
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    run()
                    times.append(time.perf_counter() - t0)
                row[method] = {"wall_s": round(min(times), 3),
                               "samples_per_s":
                                   round(n / min(times), 1)}
            row["overlap_speedup"] = round(
                row["pencil"]["wall_s"] / row["overlap"]["wall_s"], 3)
            cells.append(row)
            print(f"[crossover] n=2^{log2n} {shape_name:13s} "
                  f"2H/block={row['halo_frac']:.3f}  "
                  f"pencil {row['pencil']['wall_s']:7.3f}s  "
                  f"overlap {row['overlap']['wall_s']:7.3f}s  "
                  f"overlap_speedup={row['overlap_speedup']}", flush=True)

    out = {
        "backend": jax.default_backend(),
        "n_devices": n_dev,
        "fs": fs,
        "reps": reps,
        "cells": cells,
        "method": "min wall over reps, compile excluded; halo_frac = "
                  "2H/block (the structural cost ratio 'auto' keys on)",
    }
    with open(os.path.join(ROOT, "CROSSOVER.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"[crossover] wrote CROSSOVER.json")


if __name__ == "__main__":
    main()
