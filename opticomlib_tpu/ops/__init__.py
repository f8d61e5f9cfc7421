"""Compute kernels: JAX/XLA implementations of the hot paths."""
from . import eyeana, filters, prbs, pulses, ssfm  # noqa: F401
