"""Profiling hooks: the device-aware upgrade of the reference's homemade
wall-clock timers (reference utils.py:293-340 — ``tic``/``toc`` brackets
every device and stores ``execution_time`` on results, which this package
keeps for API parity).

Adds structured device-level tracing via ``jax.profiler`` so hot paths
can be inspected in TensorBoard / Perfetto instead of eyeballing
wall-clock numbers.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

__all__ = ["trace", "annotate", "DeviceTimer"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device trace for the enclosed block.

    View with TensorBoard (``tensorboard --logdir <logdir>``) or load the
    .trace files into Perfetto.  A runtime that cannot trace raises; the
    block is never silently run untraced.
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name the enclosed region in the device trace
    (``jax.profiler.TraceAnnotation``); no-op outside a trace."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class DeviceTimer:
    """Wall-clock timer around device work.

    JAX dispatch is asynchronous, so call :meth:`sync` on the outputs
    before the block ends.  Use as a context manager::

        with DeviceTimer() as t:
            out_re, out_im = my_jitted(x_re, x_im)
            t.sync(out_re, out_im)
        print(t.elapsed)
    """

    def __init__(self):
        self.elapsed: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    @staticmethod
    def sync(*arrays):
        """Wait for the programs producing ``arrays``; returns them."""
        import jax

        return jax.block_until_ready(arrays[0] if len(arrays) == 1
                                     else arrays)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
