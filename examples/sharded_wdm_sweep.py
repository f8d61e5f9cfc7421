"""Sharded WDM sweep: channels x time-blocks over a device mesh
(BASELINE config 5, scaled to the devices available).

It scales the mesh to the default devices (``len(jax.devices())``, e.g.
the GPUs of one host).  To rehearse on 8 virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/sharded_wdm_sweep.py
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
import numpy as np
import jax

from opticomlib_tpu.ops import ssfm
from opticomlib_tpu.parallel.fiber import (
    make_link_mesh, shard_waveform, ssfm_sharded,
)

n_dev = len(jax.devices())
n_wdm = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
n_time = n_dev // n_wdm
print(f"devices: {n_dev} -> mesh ('wdm'={n_wdm}, 'time'={n_time})")

FS = 160e9
N = 2**16  # BASELINE config 5 defines 2**26 per channel
rng = np.random.default_rng(0)

# one waveform per WDM channel
from scipy.ndimage import gaussian_filter1d
A = np.stack([
    gaussian_filter1d(
        np.repeat(rng.integers(0, 2, N // 16).astype(float), 16), 4) * 0.2
    for _ in range(n_wdm)]).astype(np.complex64)

mesh = make_link_mesh(n_wdm=n_wdm, n_time=n_time)
A_sharded = shard_waveform(A, mesh)

kw = dict(length=20, alpha=0.2, beta_2=-21, gamma=1.3, h=0.5)
out = ssfm_sharded(A_sharded, mesh, fs=FS, **kw)  # exact pencil FFT

# verify channel 0 against the single-device engine
w = 2 * np.pi * np.fft.fftfreq(N) * FS
single = np.asarray(ssfm.ssfm_propagate(A[0], w, **kw))
err = np.max(np.abs(np.asarray(out)[0] - single)) / np.max(np.abs(single))
print(f"sharded vs single-device relative error: {err:.2e}")
print("powers per channel [W]:",
      [float(np.mean(np.abs(np.asarray(out)[c]) ** 2))
       for c in range(n_wdm)])
