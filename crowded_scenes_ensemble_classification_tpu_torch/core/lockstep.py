"""Data-parallel positions in lockstep: the global batch's BatchNorm moments and row draws.

JAX's data-parallel step is one GSPMD program: its train-mode BatchNorm
reduces over the global batch, and every random draw is of the global
batch's shape, so the sharded step computes what the unsharded one does.
Here one controller drives the positions of a data mesh (`core.mesh`), and
the model code stays the unsharded code: each position runs its shard's
forward on a thread of its own (`run_positions`), and the threads meet once
a BatchNorm layer (`Lockstep.sum`), where position 0 adds up their partial
sums in position order and every position takes the total back onto its
device.  Autograd records each step (the `.to()` moves and the additions
are differentiable), so the gradients flow through the summed moments as
they do under GSPMD.  A thread learns its place in the global batch from
`current_shard()`: `models.common.KerasBatchNorm3d` reads it to normalise by
the global moments, and C3D's dropout to draw its rows of the global mask.

Position 0's thread does every sum, so the autograd nodes of a step are
made in the same threads in the same order each time, and two processes
that run one step (`parallel.distributed.ProcessSum`, given as `across`)
issue their collectives, in the backward pass as well, in one order.

The threads live as long as the process, position i of every step on
the same thread: what PyTorch keeps a thread (cuDNN's execution plans
among it) is made in the first step only, and each thread's autograd
sequence numbers, which order the backward pass, follow the same history
in every process.

Not `nn.SyncBatchNorm`: it needs an NCCL group, and NCCL refuses two ranks
on one card, where the positions of a one-card mesh sit.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class Shard:
    """A position's place in one data-parallel step: rows [start, start +
    rows) of a global batch of `total` rows, on `device`, meeting the other
    positions at `lockstep`.  The one position with `updates_running_stats`
    updates the BatchNorm running statistics, once a step."""

    position: int
    device: torch.device
    start: int
    rows: int
    total: int
    lockstep: "Lockstep"
    updates_running_stats: bool = False


def current_shard() -> Optional[Shard]:
    """The calling thread's `Shard` inside `run_positions`, else None (an
    unsharded call)."""
    return getattr(_local, "shard", None)


class Lockstep:
    """The rendezvous of `n` positions.  `across`, when given, adds up a
    list of tensors over processes, differentiably (`parallel.distributed.
    ProcessSum`): the data axis continues in other processes."""

    def __init__(self, n: int, across: Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None):
        self.n = n
        self.across = across
        self._slots: List[Any] = [None] * n
        self._total: Optional[List[torch.Tensor]] = None
        self._barrier = threading.Barrier(n)

    def sum(self, position: int, values: Sequence[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
        """Every position's `values` added up elementwise, in position order
        on position 0's device (then over processes), and moved to
        `device`.  Every position calls it with values of the same shapes."""
        self._slots[position] = list(values)
        self._barrier.wait()  # every position's values are in
        if position == 0:
            try:
                home = self._slots[0][0].device
                total = [sum(slot[i].to(home) for slot in self._slots) for i in range(len(values))]
                self._total = self.across(total) if self.across is not None else total
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()  # the total is ready; no position writes again before all have read it
        return [t.to(device) for t in self._total]

    def abort(self) -> None:
        self._barrier.abort()


class _Workers:
    """n threads that live as long as the process, thread i running
    position i of every step."""

    def __init__(self, n: int):
        self.queues = [queue.SimpleQueue() for _ in range(n)]
        for i, q in enumerate(self.queues):
            threading.Thread(target=self._serve, args=(q,), name=f"position-{i}-of-{n}", daemon=True).start()

    @staticmethod
    def _serve(q: queue.SimpleQueue) -> None:
        while True:
            fn, done = q.get()
            fn()
            done.set()

    def run(self, fns: Sequence[Callable[[], None]]) -> None:
        """fns[i] on thread i, all at once; returns when all have returned
        (they must not raise)."""
        done = [threading.Event() for _ in fns]
        for q, fn, d in zip(self.queues, fns, done):
            q.put((fn, d))
        for d in done:
            d.wait()


_workers: Dict[int, _Workers] = {}
_workers_lock = threading.Lock()


def _workers_for(n: int) -> _Workers:
    with _workers_lock:
        if n not in _workers:
            _workers[n] = _Workers(n)
        return _workers[n]


def run_positions(fn: Callable[[Shard], Any], shards: Sequence[Shard]) -> list:
    """fn(shard) for every shard, shard i on the process's thread i for
    this many positions (module docstring), where `current_shard()` names
    it, with the caller's grad mode and, on a card, the shard's device
    current.  Returns the results in position order; an error in any
    position stops the others at their next rendezvous and is raised
    here."""
    results: list = [None] * len(shards)
    errors: list = []
    grad = torch.is_grad_enabled()

    def target(shard: Shard) -> None:
        _local.shard = shard
        try:
            with torch.set_grad_enabled(grad):
                if shard.device.type == "cuda":
                    with torch.cuda.device(shard.device):
                        results[shard.position] = fn(shard)
                else:
                    results[shard.position] = fn(shard)
        except BaseException as e:  # noqa: BLE001 (re-raised by the caller below)
            errors.append((shard.position, e))
            shard.lockstep.abort()
        finally:
            _local.shard = None

    _workers_for(len(shards)).run([lambda s=s: target(s) for s in shards])
    if errors:
        first = [e for _, e in sorted(errors, key=lambda pe: pe[0]) if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or [errors[0][1]])[0]
    return results
