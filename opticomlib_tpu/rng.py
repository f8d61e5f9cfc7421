"""Keyed randomness for device-side noise generation.

The reference draws every noise realization from NumPy's *global* legacy
RNG on the host (reference devices.py:485-506, 930-936, 1521-1527) — not
reproducible across library versions and a host->device transfer per draw.
This package (SURVEY §7.4) uses ``jax.random`` with explicit,
splittable keys so that

* noise is generated **on-device** (no host RNG + transfer on the hot path),
* the same seed always produces the same waveform (counter-based Threefry,
  stable across devices and library versions),
* the fused link program (:mod:`opticomlib_tpu.link`) can thread one key
  through every noisy stage inside a single jit.

Three ways to get keyed noise, in precedence order:

1. pass ``key=`` (a ``jax.random`` key or an int seed) to a device call
   (``LASER``, ``EDFA``, ``PD``);
2. seed the global stream: ``gv(seed=42)`` or ``rng.seed(42)`` — devices
   then draw consecutive keys from it (reproducible whole-script runs);
3. do neither — devices fall back to the reference's legacy NumPy behavior.
"""
from __future__ import annotations

from typing import Optional, Union

import jax
import numpy as np

__all__ = ["seed", "clear", "is_seeded", "next_key", "resolve", "KeyLike"]

KeyLike = Union[int, jax.Array]

_stream: Optional[jax.Array] = None


def seed(n: int) -> None:
    """Seed the global key stream (also reachable as ``gv(seed=n)``)."""
    global _stream
    _stream = jax.random.key(int(n))


def clear() -> None:
    """Disable the global stream (devices revert to legacy NumPy noise)."""
    global _stream
    _stream = None


def is_seeded() -> bool:
    return _stream is not None


def next_key() -> jax.Array:
    """Draw the next key from the global stream (advances the stream)."""
    global _stream
    if _stream is None:
        raise RuntimeError(
            "global RNG stream not seeded; call rng.seed(n) or gv(seed=n)")
    _stream, sub = jax.random.split(_stream)
    return sub


def as_key(key: KeyLike) -> jax.Array:
    """Coerce an int seed or key array to a jax.random key.

    Accepts any integral scalar (Python int, np.uint32, np.int64, ...) —
    a NumPy integer passed through untouched would hit jax.random.split
    with a 'not a PRNG key' error far from the caller."""
    if isinstance(key, (int, np.integer)):
        return jax.random.key(int(key))
    return key


def resolve(key: Optional[KeyLike]) -> Optional[jax.Array]:
    """Resolve a device's ``key=`` argument.

    Explicit ``key`` wins; else the global stream if seeded; else ``None``
    (caller should use the legacy NumPy path).
    """
    if key is not None:
        return as_key(key)
    if is_seeded():
        return next_key()
    return None
