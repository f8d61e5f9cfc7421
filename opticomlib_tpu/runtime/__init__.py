"""Runtime services: checkpoint/resume for long propagations, profiling
hooks.  The reference has no simulation checkpointing (SURVEY.md §5.4 —
its closest analogues are FIBER's ``return_steps`` trajectory capture and
lab HDF5 persistence); this subsystem is new capability required for the
multi-span / multi-host configurations (BASELINE config 4: 20x80 km DBP).
"""
from .cache import enable_cache, cache_dir
from .checkpoint import (
    PropagationCheckpointer, span_chain_resumable,
    ssfm_propagate_resumable,
)

__all__ = ["PropagationCheckpointer", "ssfm_propagate_resumable",
           "span_chain_resumable", "enable_cache", "cache_dir"]
