"""Processes that share the ensemble's members.

Counterpart of `crowded_scenes_ensemble_classification_tpu/parallel/distributed.py`
(lines 25-54).  The reference fanned the k·(k−1) members out as
independent Slurm jobs (launch_train_ensemble.py:144-158).  There
`jax.distributed.initialize` joins processes; here `torch.distributed`
over gloo does, for what JAX does across processes: which process trains
which members, and reductions on the host.  Activations never cross
processes, only sums of them: within a process the mesh (`core.mesh`)
drives its positions, and NCCL, which refuses two ranks on one card, is
not used.

Every process runs the same code with its own rank; a group is joined at
`tcp://<coordinator_address>` with a finite timeout, so a process whose
peer never comes fails instead of waiting forever.

`ProcessSum` is what a data-parallel train step adds up over processes
when its data axis continues across them (`train.engine.make_train_step(
processes=)`): the BatchNorm sums (differentiably), the loss's normaliser,
the metrics and the gradients, each staged through the host.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

import torch
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


class _SumOverProcesses(torch.autograd.Function):
    """all_reduce(SUM) of a tensor through the host, differentiable: the
    gradient of a sum every process holds is the sum of their gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _host_sum(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _host_sum(grad, ctx.group), None


def _host_sum(x: torch.Tensor, group) -> torch.Tensor:
    staged = x.detach().to("cpu", copy=True)
    dist.all_reduce(staged, group=group)
    return staged.to(x.device)


class ProcessSum:
    """Sums over the processes of a gloo group, for a data-parallel step
    whose data axis continues across processes (JAX's GSPMD step over a
    mesh of several processes' devices).  Every sum is staged through the
    host, so the group's tensors may lie on the card or the CPU.  All
    processes must make the same calls in the same order."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessSum needs a torch.distributed group: call initialize_distributed first")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def row_span(self, rows: int) -> Tuple[int, int]:
        """(this process's first row, the global rows) of a batch of which
        this process holds `rows`, the processes' rows in rank order."""
        counts = torch.zeros(self.size, dtype=torch.int64)
        counts[self.rank] = rows
        dist.all_reduce(counts, group=self.group)
        return int(counts[:self.rank].sum()), int(counts.sum())

    def __call__(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The tensors summed over the processes, differentiably, in one
        collective (float64 on the wire: exact for every f32 sum)."""
        flat = torch.cat([t.reshape(-1).double() for t in tensors])
        total = _SumOverProcesses.apply(flat, self.group)
        out, at = [], 0
        for t in tensors:
            out.append(total[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def values(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor summed over the processes, outside autograd."""
        return _host_sum(t, self.group)

    def grads(self, params) -> None:
        """Each parameter's `.grad` replaced by its sum over the processes,
        in one collective; parameters with no gradient stay without one."""
        with_grad = [p for p in params if p.grad is not None]
        if not with_grad:
            return
        total = _host_sum(torch.cat([p.grad.reshape(-1).double() for p in with_grad]), self.group)
        at = 0
        for p in with_grad:
            p.grad.copy_(total[at:at + p.numel()].view(p.grad.shape))
            at += p.numel()
