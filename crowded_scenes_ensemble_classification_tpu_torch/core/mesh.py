"""The device mesh: named axes over positions that each hold a torch device.

Counterpart of `crowded_scenes_ensemble_classification_tpu/core/mesh.py`
(lines 26-88).  There a `jax.sharding.Mesh` lays named axes over devices
and one controller drives them all (`shard_map`, `NamedSharding`).  Here
one controller drives them too: a `Mesh` is a grid of *positions*, each
holding a `torch.device`, and positions may share a device, as the JAX
tests' virtual CPU devices share one host.  A mesh of 4 positions on
`cuda:0` runs the sharded forms on one card (one position after another);
with more cards the positions take `cuda:0..n-1` and a transfer between
positions becomes a device-to-device copy.  Axes:

- ``data``   — batch (data-parallel) axis;
- ``member`` — ensemble-member axis (`ensemble.members.make_member_forward`);
- ``time``   — frame axis of a long clip (`parallel.temporal_halo`).

A sharded tensor is a list of per-position tensors along one axis
(`shard_batch`, `gather`).  JAX's `batch_sharding`, `replicated` and
`member_sharding` return `NamedSharding`s, which have no torch object:
the lists take their place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Named axes over a grid of positions: `devices` is a numpy object
    array of `torch.device`s of shape `tuple(shape.values())`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, *axes: str) -> np.ndarray:
        """The devices of the positions along `axes`, in that order, every
        other axis at its first position (JAX shard_map's view of a spec
        sharded on `axes`, the rest replicated); an axis the mesh lacks
        counts as one position."""
        present = [a for a in self.axis_names if a in axes]
        index = tuple(slice(None) if a in axes else 0 for a in self.axis_names)
        sub = np.array(self.devices[index], dtype=object)  # a 0-d array when every axis is indexed
        sub = np.transpose(sub, [present.index(a) for a in axes if a in present])
        return sub.reshape([self.shape.get(a, 1) for a in axes])

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of the positions along `axis` (`grid(axis)`)."""
        return list(self.grid(axis))


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises without one (no CPU fallback: a
    caller that wants the CPU names it)."""
    from ..utils.device import require_cuda

    require_cuda()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" is the current card, as a tensor
    placed there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(
    axes: Sequence[Tuple[str, int]] = (("data", -1),),
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Build a mesh from (axis_name, size) pairs (JAX core/mesh.py:26-51).

    A size of ``-1`` means "all remaining positions" (at most one axis may
    use it).  `devices` lists one device a position; None means every
    visible CUDA device.  `[torch.device("cuda:0")] * 4` puts 4 positions on
    one card; `[torch.device("cpu")] * 4` on the CPU."""
    devices = [_indexed(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    sizes = [s for _, s in axes]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may have size -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), tuple(name for name, _ in axes))


def data_parallel_mesh(devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    return make_mesh((("data", -1),), devices)


def ensemble_mesh(num_members: int, devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """2-D (member, data) mesh: members spread over positions, the remaining
    positions split the batch within a member group (JAX core/mesh.py:58-69).
    With a member count that does not divide the positions, the member axis
    folds to 1: a pure data mesh."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if n % max(num_members, 1) == 0 and num_members <= n:
        return make_mesh((("member", num_members), ("data", -1)), devices)
    return make_mesh((("member", 1), ("data", -1)), devices)


def split_positions(x: torch.Tensor, devices: Sequence[torch.device], dim: int = 0) -> List[torch.Tensor]:
    """x cut into len(devices) equal slices along `dim`, slice i on
    devices[i] (moved only where it lies elsewhere).  A size that does not
    divide raises."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not divide over {n} positions")
    return [part.to(dev) for part, dev in zip(torch.chunk(x, n, dim=dim), devices)]


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """One tensor a position along `axis`: its slice of dim 0 on its device
    (JAX core/mesh.py:86-88)."""
    return split_positions(x, mesh.axis_devices(axis), dim=0)


def gather(shards: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards concatenated along `dim` in position order, on the first
    position's device."""
    device = shards[0].device
    return torch.cat([s.to(device) for s in shards], dim=dim)
