"""Multi-host initialization for runs that span several GPU hosts.

The sharded runtime (``ssfm_sharded``, ``ShardedLinkProgram``,
``span_pipeline``) is written against a :class:`jax.sharding.Mesh` and
works unchanged across hosts: ``jax.devices()`` returns the GLOBAL
device list once the distributed runtime is initialized, the meshes
built by :func:`opticomlib_tpu.parallel.fiber.make_link_mesh` then span
hosts, and XLA routes the collectives (``all_to_all`` pencil
transposes, ``ppermute`` halos, ``pmax`` adaptive reductions) over
NVLink within a host and the network across hosts — no code changes.

This module only wraps the standard bring-up so a multi-host run is one
call per process.  GPU hosts discover nothing from the environment:
pass the coordinator's address, the process count and this process's
index explicitly:

    # on every host (same script, per-host process_id):
    from opticomlib_tpu.parallel import initialize_multihost, make_link_mesh
    initialize_multihost("host0:12345", num_processes=4, process_id=i)
    mesh = make_link_mesh(n_wdm=4)               # global devices
    prog = build_link(spec, n_bits, mesh=mesh)   # same API as 1 host
    sweep = prog.dsp_wdm(16, seed=0)

Sizing guidance (BASELINE config 5, 16 ch x 2^26): shard channels over
hosts ('wdm' across the network — embarrassingly parallel, no cross-host
traffic) and the time axis within each host ('time' over NVLink), i.e.
``make_link_mesh(n_wdm=n_hosts, n_time=devices_per_host)``.  Keep the
pencil-FFT ``all_to_all`` inside a host; only scalars cross hosts.

The mesh semantics are tested on the 8-device virtual CPU mesh (tests/)
and with two CPU processes (tests/test_multihost.py).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["initialize_multihost"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Initialize JAX's distributed runtime (idempotent) and return the
    global device count.

    Pass the coordinator's ``host:port`` (for one host,
    ``localhost:<free port>``), the number of processes and this
    process's index; JAX discovers none of them on GPU hosts.
    """
    import jax

    # jax.distributed.initialize raises on a second call (its message
    # varies across versions and never says "already initialized"), so
    # idempotency is an explicit state check, not message matching.
    already = False
    if hasattr(jax.distributed, "is_initialized"):
        already = jax.distributed.is_initialized()
    else:  # older jax: the client slot is the ground truth
        from jax._src import distributed as _dist
        already = getattr(_dist.global_state, "client", None) is not None
    if not already:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return len(jax.devices())
