"""Processes that share the ensemble's members.

Counterpart of `crowded_scenes_ensemble_classification_tpu/parallel/distributed.py`
(lines 25-54).  The reference fanned the k·(k−1) members out as
independent Slurm jobs (launch_train_ensemble.py:144-158).  There
`jax.distributed.initialize` joins processes; here `torch.distributed`
over gloo does, for what JAX does across processes only: which process
trains which members, and reductions on the host.  Activations never
cross processes: within a process the mesh (`core.mesh`) drives its
positions, and NCCL, which refuses two ranks on one card, is not used.

Every process runs the same code with its own rank; a group is joined at
`tcp://<coordinator_address>` with a finite timeout, so a process whose
peer never comes fails instead of waiting forever.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

import torch.distributed as dist

from ..core.config import split_pairs

DEFAULT_TIMEOUT_S = 120.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the gloo group of `num_processes` processes at
    `coordinator_address` ("host:port") as rank `process_id`.  A no-op in
    the single-process case (JAX distributed.py:32-33) and when this
    process already belongs to a group."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, num_processes and process_id")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown_distributed() -> None:
    """Leave the group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count_index() -> Tuple[int, int]:
    """(processes, this process's rank): those of the group this process
    joined, else (1, 0) (`jax.process_count()`, `jax.process_index()`)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_multi_process() -> bool:
    return process_count_index()[0] > 1


def my_member_assignments(folds_number: int) -> List[Tuple[int, int]]:
    """This process's share of the k·(k−1) (test, val) members: every n-th
    of `split_pairs`, from its rank on (JAX distributed.py:45-54)."""
    n, p = process_count_index()
    return [pair for i, pair in enumerate(split_pairs(folds_number)) if i % n == p]
