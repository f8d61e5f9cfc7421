"""Dispersion-managed fused link: N spans of [FIBER -> DM -> EDFA] compiled
as ONE XLA program via ``RepeatSpec`` (one ``lax.scan`` over the span block,
not N unrolled copies), checked sample-for-sample against the staged device
chain (reference devices.py:945-1035 DM; examples/
ook_transmission_fiber_simulation.py per-span pattern).

Run: python examples/dispersion_managed_link.py
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
import numpy as np

from opticomlib_tpu import gv
from opticomlib_tpu.link import (DMSpec, EDFASpec, FiberSpec, LinkSpec,
                                 RepeatSpec, build_link)

gv(sps=16, R=10e9, wavelength=1550e-9, N=2**12)

N_SPANS, L, ALPHA, B2, GAMMA = 8, 80.0, 0.2, -21.0, 1.3

span = (
    FiberSpec(length=L, alpha=ALPHA, beta_2=B2, gamma=GAMMA, h=1.0),
    DMSpec(D=-B2 * L),                  # in-line dispersion compensation
    EDFASpec(G=ALPHA * L, NF=5),        # transparent gain + ASE
)

spec = LinkSpec(
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5,
    P0=5, loss_dB=3, ER_dB=26,
    stages=(RepeatSpec(N_SPANS, span),),
    pd_BW=7.5e9,
)

prog = build_link(spec, n_bits=gv.N)
res = prog.dsp(seed=11)                # fully fused RX: eye+threshold+BER
print(f"{N_SPANS} x {L:.0f} km dispersion-managed link, one XLA program")
print(f"BER = {res.ber:.2e}   threshold = {res.threshold:.4f}")
print(res.eye)

# --- noiseless cross-check: fused RepeatSpec == staged device chain ---
from opticomlib_tpu.devices import DAC, DM, EDFA, LASER, MZM, FIBER  # noqa: E402
from opticomlib_tpu.ops.prbs import prbs  # noqa: E402
import jax.numpy as jnp  # noqa: E402

spec_nl = LinkSpec(
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
    loss_dB=3, ER_dB=26,
    stages=(RepeatSpec(N_SPANS, (
        FiberSpec(length=L, alpha=ALPHA, beta_2=B2, gamma=GAMMA, h=1.0),
        DMSpec(D=-B2 * L), EDFASpec(G=ALPHA * L))),),  # NF=None: no ASE
    pd_BW=7.5e9, include_thermal=False, include_shot=False)
prog_nl = build_link(spec_nl, n_bits=gv.N, return_field=True)
bits, _ = prbs(9, length=gv.N)
out = prog_nl.jitted(jnp.asarray(np.asarray(bits.data, np.float32)),
                     jnp.uint32(0))
fused_field = np.asarray(out[2]) + 1j * np.asarray(out[3])

# staged chain on the fused TX field (b2b program reproduces the TX)
spec_tx = LinkSpec(pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5,
                   Vpi=5, P0=5, loss_dB=3, ER_dB=26, pd_BW=7.5e9,
                   include_thermal=False, include_shot=False)
prog_tx = build_link(spec_tx, n_bits=gv.N, return_field=True)
out_tx = prog_tx.jitted(jnp.asarray(np.asarray(bits.data, np.float32)),
                        jnp.uint32(0))
from opticomlib_tpu.signals import OpticalSignal  # noqa: E402
f = OpticalSignal(np.asarray(out_tx[2]) + 1j * np.asarray(out_tx[3]))
for _ in range(N_SPANS):
    f = FIBER(f, length=L, alpha=ALPHA, beta_2=B2, gamma=GAMMA, h=1.0)
    f = DM(f, D=-B2 * L)
    f = OpticalSignal(np.asarray(f.signal) * 10 ** (ALPHA * L / 20),
                      n_pol=f.n_pol)
staged_field = np.asarray(f.signal).ravel()

err = np.max(np.abs(fused_field - staged_field)) / np.max(np.abs(staged_field))
print(f"fused RepeatSpec vs staged chain: max rel err = {err:.2e}")
# 8 x 80 km at h=1 km is 1280 float32 FFTs; the fused scan (one compiled
# graph) and the 8 separately-compiled staged programs round differently,
# and the gap depends on the platform's FFT rounding (~1e-5 on CPU).
assert err < 5e-3
