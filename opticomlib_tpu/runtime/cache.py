"""Persistent XLA compilation cache.

The framework's whole design is "one big XLA program" (the fused link,
the sharded solvers), so a process pays one large compile per program
shape.  The compile is deterministic in the program, so it should be
paid **once per machine**, not once per process: this module wires up
JAX's persistent compilation cache, which keys serialized executables by
(HLO, compile options, backend) and replays them on later runs.

Where the cache lives, in order of precedence:

1. ``JAX_COMPILATION_CACHE_DIR`` — JAX's own variable.  When it is set,
   nothing in this package (``enable_cache``, ``bench.py``,
   ``chip_smoke.py``) sets another directory;
2. ``OPTICOMLIB_TPU_CACHE=/path/to/dir`` or the ``directory`` argument of
   :func:`opticomlib_tpu.enable_cache`;
3. :data:`DEFAULT_CACHE_DIR`, the fixed directory ``.jax_cache`` at the
   root of the checkout (git-ignored).  The path is part of the cache's
   key, so it never depends on a temp name, pid or time.

The cache is on by default: importing the package enables it.
``OPTICOMLIB_TPU_CACHE=0`` (or ``off``/``false``/``no``) opts out.

No counterpart exists in the reference (pure NumPy, nothing to compile).
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["enable_cache", "cache_dir", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_enabled_dir: Optional[str] = None

# env values that mean "yes, default directory" / "no, keep disabled" —
# matched case-insensitively; anything else is taken as a directory path.
# An UNSET/empty variable means "on" (default-on cache); only an explicit
# off-value disables it.
_ENV_ON = ("", "1", "true", "yes", "on")
_ENV_OFF = ("0", "false", "no", "off")


def _env_kind(value: str) -> str:
    """Classify an OPTICOMLIB_TPU_CACHE value as 'on', 'off' or 'path'."""
    v = value.strip().lower()
    if v in _ENV_ON:
        return "on"
    if v in _ENV_OFF:
        return "off"
    return "path"


def enable_cache(directory: Optional[str] = None,
                 min_compile_time_secs: float = 0.2) -> str:
    """Turn on JAX's persistent compilation cache.

    The directory is ``$JAX_COMPILATION_CACHE_DIR`` whenever that is set
    (it wins over ``directory``); else ``directory``; else
    ``$OPTICOMLIB_TPU_CACHE`` when set to a path; else
    :data:`DEFAULT_CACHE_DIR`.  Programs whose compile takes at least
    ``min_compile_time_secs`` are persisted (set 0 to persist
    everything).  Safe to call more than once.  Returns the directory in
    use.
    """
    global _enabled_dir
    jax_env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if jax_env:
        directory = jax_env
    elif directory is None:
        env = os.environ.get("OPTICOMLIB_TPU_CACHE", "")
        directory = env if _env_kind(env) == "path" else DEFAULT_CACHE_DIR
    directory = os.path.abspath(os.path.expanduser(directory))
    os.makedirs(directory, exist_ok=True)

    import jax

    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time_secs))
    # cache every entry regardless of serialized size
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _enabled_dir = directory
    return directory


def cache_dir() -> Optional[str]:
    """Directory of the active persistent cache, or None when disabled."""
    return _enabled_dir


def _maybe_enable_from_env() -> None:
    """Auto-enable the persistent cache on package import (DEFAULT-ON;
    ``OPTICOMLIB_TPU_CACHE=0`` opts out unless JAX's own
    ``JAX_COMPILATION_CACHE_DIR`` is set, which JAX honors regardless)."""
    if (not os.environ.get("JAX_COMPILATION_CACHE_DIR")
            and _env_kind(os.environ.get("OPTICOMLIB_TPU_CACHE", ""))
            == "off"):
        return
    try:
        enable_cache()
    except OSError as e:  # unwritable/invalid path must not break import
        import warnings
        warnings.warn(
            f"persistent compilation cache not enabled ({e}); continuing "
            f"without it.", RuntimeWarning, stacklevel=2)
