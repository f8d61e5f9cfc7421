"""Higher-order SSFM schemes: accuracy per FFT.

Propagates a Gaussian pulse 40 km and compares the reference 2nd-order
frozen-operator scheme, the 4th-order Yoshida composition, and Sinkin
local-error adaptive stepping against a fine-step oracle — reporting the
error each achieves per FFT pair spent.

Run: python examples/higher_order_ssfm.py
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
import numpy as np

from opticomlib_tpu.ops import ssfm

n, fs, p0 = 4096, 640e9, 0.05
t = np.arange(n) / fs
A = (np.sqrt(p0) * np.exp(-(((t - t.mean()) / 15e-12) ** 2) / 2)
     ).astype(np.complex64)
w = 2 * np.pi * np.fft.fftfreq(n) * fs
cfg = dict(alpha=0.2, beta_2=-21.0, gamma=1.3)
L = 40.0

oracle = ssfm.ssfm_scan_o4(A, w, L, h=L / 1024, **cfg)


def err(x):
    return float(np.linalg.norm(x - oracle) / np.linalg.norm(oracle))


print(f"{'scheme':<28}{'FFT pairs':>10}{'rel. error':>14}")
for h_div in (16, 64):
    out = ssfm.ssfm_propagate(A, w, L, h=L / h_div, **cfg)
    print(f"{'reference o2, h=L/%d' % h_div:<28}{h_div:>10}{err(out):>14.2e}")
for h_div in (4, 16):
    out = ssfm.ssfm_scan_o4(A, w, L, h=L / h_div, **cfg)
    print(f"{'Yoshida o4,   h=L/%d' % h_div:<28}{3 * h_div:>10}"
          f"{err(out):>14.2e}")
for tol in (1e-3, 1e-4):
    out, steps = ssfm.ssfm_local_error(A, w, L, tol=tol, **cfg)
    print(f"{'local error, tol=%.0e' % tol:<28}{3 * steps:>10}"
          f"{err(out):>14.2e}")
for tol in (1e-4, 1e-6):
    out = ssfm.ssfm_o4_auto(A, w, L, tol=tol, **cfg)
    print(f"{'o4 auto,     tol=%.0e' % tol:<28}{'(self)':>10}"
          f"{err(out):>14.2e}")

# the self-tuning o4 is what FIBER(method="o4") / FiberSpec(method="o4")
# run when no fixed h is given — no calibration script needed
from opticomlib_tpu import gv
from opticomlib_tpu.devices import DBP, FIBER
from opticomlib_tpu.signals import OpticalSignal

gv(sps=16, R=10e9, N=n // 16)
fwd = FIBER(OpticalSignal(A), length=L, method="o4", tol=1e-5, **cfg)
back = DBP(fwd, length=L, method="o4", tol=1e-5, **cfg)
rt = float(np.linalg.norm(back.to_numpy() - A) / np.linalg.norm(A))
print(f"\nFIBER/DBP method='o4' (self-tuning) round trip: {rt:.2e}")
