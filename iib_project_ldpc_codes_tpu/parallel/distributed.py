"""Multi-host orchestration helpers.

The reference scales across hosts as independent HPC array jobs reduced
offline (SURVEY.md section 2).  Here it is ONE ``jax.distributed`` job:
every host runs the same program in one process that owns all of that
host's cards (a JAX process reserves most of a card's memory, so a card
takes no second process), the global mesh spans all processes' devices,
Monte Carlo counters psum across the whole mesh inside the chunk kernel
(NCCL within and between hosts), and only process 0 writes results --
replacing tools/combine_data.py with a collective.

Single-process runs (one card, or all cards of one host) work unchanged:
``initialize()`` is a no-op when no coordinator is configured.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join (or skip) a jax.distributed job.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    when arguments are omitted.  Returns True if distributed mode is
    active.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    kwargs = {}
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address, **kwargs)
    return True


def is_primary() -> bool:
    """Is this the process that should write results (process 0)?"""
    return jax.process_index() == 0


def global_mesh(axis_name: str = "batch"):
    """One-axis mesh over every device of every process."""
    from .mesh import make_mesh

    return make_mesh(jax.devices(), axis_name)


def save_result_primary(result, directory: Optional[str] = None
                        ) -> Optional[str]:
    """Write the (already psum-reduced) result on process 0 only."""
    from ..utils.results import save_result

    if not is_primary():
        return None
    return save_result(result, directory)
