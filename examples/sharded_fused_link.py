"""Sharded fused link: the whole TX -> channel -> RX chain as ONE XLA
program over a ('wdm', 'time') device mesh — the BASELINE north-star
shape, through the public API.

Runs on the default devices (e.g. the GPUs of one host) and sizes the
mesh to ``len(jax.devices())``.  To rehearse on 8 virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/sharded_fused_link.py
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from opticomlib_tpu.link import (EDFASpec, FiberSpec, LinkSpec,  # noqa: E402
                                 build_link)
from opticomlib_tpu.params import SimParams  # noqa: E402

params = SimParams.create(sps=16, R=10e9, _warn=False)
spec = LinkSpec(
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5,
    P0=5, loss_dB=3, ER_dB=26,
    stages=(FiberSpec(length=50, alpha=0.2, beta_2=-21.0, gamma=1.3),
            EDFASpec(G=10, NF=5)),
    pd_BW=7.5e9,
)

# --- WDM channels x time-sharded waveforms over a (n_wdm, n_time) mesh
# (4 x 2 on 8 devices, 2 x 2 on 4) ---
n_dev = len(jax.devices())
n_time = 2 if n_dev % 2 == 0 else 1
n_wdm = n_dev // n_time
mesh = Mesh(np.array(jax.devices()).reshape(n_wdm, n_time), ("wdm", "time"))
prog = build_link(spec, n_bits=2**12, params=params, mesh=mesh)

sweep = prog.dsp_wdm(n_wdm, seed=0)  # fused receivers, scalars-only readback
print("mesh:", dict(mesh.shape))
print("per-channel BER:      ", sweep.ber)
print("per-channel threshold:", np.round(sweep.threshold, 4))

# --- all devices on the time axis for one long channel ---
mesh_t = Mesh(np.array(jax.devices()), ("time",))
prog_t = build_link(spec, n_bits=2**13, params=params, mesh=mesh_t)
r = prog_t.dsp(seed=1)
print(f"time-sharded single channel: BER={r.ber}  ER={r.eye.er:.1f} dB")
assert r.ber == prog_t.dsp(seed=1).ber  # keyed noise: bit-reproducible
