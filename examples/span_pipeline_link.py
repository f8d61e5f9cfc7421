"""Pipeline-parallel multi-span link.

Each device owns one fiber span (+ transparent EDFA); a batch of
independent waveforms (WDM channels / Monte-Carlo shots) streams through
the spans as pipeline microbatches over `ppermute`.

Runs on the default devices (e.g. the GPUs of one host), one span per
device for up to 4 devices.  To rehearse on 8 virtual CPU devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/span_pipeline_link.py
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
import jax
import numpy as np  # noqa: E402

from opticomlib_tpu.parallel.pipeline import (  # noqa: E402
    make_span_mesh, span_pipeline,
)

S = min(4, len(jax.devices()))      # spans == devices
B, n, fs = 8, 4096, 160e9

rng = np.random.default_rng(0)
bits = rng.integers(0, 2, (B, n // 16))
A = (np.repeat(bits, 16, axis=-1) * np.sqrt(0.01)).astype(np.complex64)

out = span_pipeline(A, make_span_mesh(S), fs=fs, span_length=80.0,
                    alpha=0.2, beta_2=-21.0, gamma=1.3, h=1.0)
out = np.asarray(out)

print(f"{S}-span x 80 km link, {B} microbatches of {n} samples")
print(f"pipeline utilization: {B / (B + S - 1):.0%}")
print(f"mean output power:    {np.mean(np.abs(out) ** 2) * 1e3:.3f} mW "
      f"(transparent link, input {np.mean(np.abs(A) ** 2) * 1e3:.3f} mW)")

# ---------------------------------------------------------------------
# Round 4: the PUBLIC pipelined fused link — the same capability through
# the LinkSpec vocabulary.  build_link(span_mesh=) distributes a
# heterogeneous stage chain (here: 4x FIBER+EDFA spans followed by 4x
# per-span DBP with undo-gain, the BASELINE config-4 shape) over the
# mesh and streams a WDM batch of channels through it; TX and the fused
# OOK receivers run channel-parallel on each channel's owner device.
# ---------------------------------------------------------------------
from opticomlib_tpu.link import (  # noqa: E402
    DBPSpec, EDFASpec, FiberSpec, LinkSpec, RepeatSpec, build_link,
)
from opticomlib_tpu.params import SimParams  # noqa: E402

params = SimParams.create(sps=8, R=10e9, _warn=False)
spec = LinkSpec(
    Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
    pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
    stages=(
        RepeatSpec(4, (FiberSpec(length=80, alpha=0.2, beta_2=-21.0,
                                 gamma=1.3, h=1.0),
                       EDFASpec(G=16.0))),
        RepeatSpec(4, (DBPSpec(length=80, alpha=0.2, beta_2=-21.0,
                               gamma=1.3, h=1.0, undo_gain_dB=16.0),)),
    ))
prog = build_link(spec, n_bits=1024, params=params,
                  span_mesh=make_span_mesh(S))
sweep = prog.dsp_wdm(2 * S, seed=0, nslots=1024)
print(f"pipelined fused link: {2 * S} channels through 8 segments on "
      f"{S} devices, BER = {sweep.ber.tolist()}")
