"""opticomlib_tpu — optical communications simulation framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the pure-NumPy
reference package ``opticomlib``:
the full transmit -> channel -> receive chain — PRBS, DAC pulse shaping,
MZM/PM modulation, split-step Fourier NLSE fiber propagation, DBP
equalization, PIN detection, Bessel filtering, eye/BER metrology — plus what
the reference never had: a sharded multi-device runtime
(:mod:`opticomlib_tpu.parallel`) that scales the waveform sample axis and
WDM channels over a ``jax.sharding.Mesh`` with overlap-save halo exchange.

Top-level API mirrors the reference's star-exports
(reference opticomlib/__init__.py:1-2): the type system + utility layer,
with ``devices``, ``ook``, ``ppm`` as submodules.
"""
from __future__ import annotations

from logging import DEBUG, INFO, WARNING

import numpy as np
from numpy import ndarray
from numpy.fft import fft, ifft, fftfreq, fftshift, ifftshift
from scipy.constants import c, e, h, k as kB, pi

from .params import SimParams, GlobalVariables, global_variables, gv
from .signals import (
    NULL, NULLType, Array_Like, RealNumber, ComplexNumber,
    BinarySequence, ElectricalSignal, OpticalSignal,
    binary_sequence, electrical_signal, optical_signal,
)
from .eyediag import Eye, eye, EyeShowOptions, eyediagram
from .logger import HierLogger, hlog
from .utils.analysis import (
    db, dbm, idb, idbm, gaus, Q, phase, tau_g, dispersion, rcos, si, norm,
    nearest, nearest_index, shortest_int, dec2bin, str2array, tic, toc,
    get_time, bode, get_psd, phase_estimator,
    apply_optimized_gaussian_filter,
)
from .utils.theory import (
    p_ase, average_voltages, noise_variances, optimum_threshold, theory_BER,
)
from .ops.pulses import (
    nrz_pulse, gauss_pulse, rcos_pulse, upfir, fft_convolve_same,
    resample_fft,
)

from . import devices  # noqa: E402
from . import lab      # noqa: E402
from . import link     # noqa: E402
from . import ook      # noqa: E402
from . import ppm      # noqa: E402
from . import rng      # noqa: E402
from .runtime.cache import enable_cache, cache_dir  # noqa: E402
from .runtime.cache import _maybe_enable_from_env as _cache_env  # noqa: E402

_cache_env()
del _cache_env

__version__ = "0.1.0"

__all__ = [
    "SimParams", "GlobalVariables", "global_variables", "gv",
    "NULL", "NULLType", "Array_Like", "RealNumber", "ComplexNumber",
    "BinarySequence", "ElectricalSignal", "OpticalSignal",
    "binary_sequence", "electrical_signal", "optical_signal",
    "Eye", "eye", "EyeShowOptions", "eyediagram",
    "db", "dbm", "idb", "idbm", "gaus", "Q", "phase", "tau_g", "dispersion",
    "rcos", "si", "norm", "nearest", "nearest_index", "shortest_int",
    "dec2bin", "str2array", "tic", "toc", "get_time", "bode", "get_psd",
    "phase_estimator", "apply_optimized_gaussian_filter",
    "HierLogger", "hlog",
    "p_ase", "average_voltages", "noise_variances", "optimum_threshold",
    "theory_BER",
    "nrz_pulse", "gauss_pulse", "rcos_pulse", "upfir", "fft_convolve_same",
    "resample_fft",
    "devices", "lab", "link", "ook", "ppm", "rng", "np", "ndarray",
    # reference-script drop-in convenience re-exports
    # (reference opticomlib/__init__.py star-exports these via typing/utils;
    # docstring examples use `from opticomlib import gv, np, plt` and
    # `gv(verbose=DEBUG)`)
    "DEBUG", "INFO", "WARNING",
    "c", "e", "h", "kB", "pi",
    "fft", "ifft", "fftfreq", "fftshift", "ifftshift",
    "sizeof", "enable_cache", "cache_dir",
]


def sizeof(obj) -> int:
    """Deep in-memory size of an object in bytes.

    Reference parity: `from pympler.asizeof import asizeof as sizeof`
    (reference opticomlib/typing.py:13). Uses pympler when available,
    otherwise a recursive ``sys.getsizeof`` walk that also counts ndarray
    buffers (pympler is not a dependency of this framework).
    """
    try:
        from pympler.asizeof import asizeof
        return int(asizeof(obj))
    except (ImportError, TypeError):
        pass
    import sys as _sys
    seen = set()

    def _walk(o):
        if id(o) in seen:
            return 0
        seen.add(id(o))
        size = _sys.getsizeof(o, 0)
        if isinstance(o, np.ndarray):
            size += o.nbytes
        elif isinstance(o, dict):
            size += sum(_walk(k) + _walk(v) for k, v in o.items())
        elif isinstance(o, (list, tuple, set, frozenset)):
            size += sum(_walk(i) for i in o)
        elif hasattr(o, "__dict__"):
            size += _walk(vars(o))
        return size

    return _walk(obj)

# matplotlib is exported lazily for reference-script parity
# (`from opticomlib import plt`); importing it eagerly would slow down
# headless compute jobs.
def __getattr__(name):
    if name == "plt":
        import matplotlib
        import matplotlib.pyplot as plt
        return plt
    raise AttributeError(f"module 'opticomlib_tpu' has no attribute {name!r}")
