"""Time-sharded long clips with halo exchange.

Counterpart of `crowded_scenes_ensemble_classification_tpu/parallel/temporal_halo.py`
(lines 29-243).  The time axis of a long clip is split over the positions
of one mesh axis (`core.mesh`): position i holds frames [i·T/n, (i+1)·T/n).
Before every temporal conv or pool each shard takes the boundary frames
it needs from its neighbours, so the sharded stack equals the unsharded
one.  A *time-sharded tensor* is the list of per-position shards, NTHWC
with time on axis 1, as JAX's public tensors are (`shard_time`,
`core.mesh.gather(shards, dim=1)`).

There `lax.ppermute` moves the halo frames over ICI inside `shard_map`;
here each shard's neighbours' frames are sliced and moved to its position's
device with `.to()` (no copy where positions share a device), and the
parts joined with `cat`: every step is differentiable, so gradients flow
back through the exchange (`parallel.halo_train`).  Positions run one
after another, so on one card the sharded forms are not faster: they
bound the memory a position holds.

The convs are cuDNN convs, as JAX's are XLA convs outside any Pallas
kernel: temporal VALID over the halo-padded shard, spatial TF-SAME with
its asymmetric pads.  The (3,3,3)/(1,1,1) pool runs the hand-written
max-pool kernel (`ops/kernels/maxpool.max_pool_3x3x3_same`) on the
halo-padded shard and drops its first and last frame: SAME on the padded
shard equals temporal VALID over the halo for every kept frame.  The
time-sharded I3D trunk works on NCDHW shards (channels_last_3d memory, the
port's model layout) and exchanges along their axis 2.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.mesh import Mesh, split_positions
from ..models.common import KERAS_BN_EPS, _pad, max_pool_3d, same_pads, to_ncdhw, to_nthwc
from ..models.i3d import _BLOCK_GROUPS, I3DTrunk
from ..ops.kernels.maxpool import max_pool_3x3x3_same

Shards = List[torch.Tensor]
NTHWC_TIME, NCDHW_TIME = 1, 2


def shard_time(x: torch.Tensor, mesh: Mesh, axis: str = "time") -> Shards:
    """NTHWC x → its time-sharded form over `axis` (JAX in_specs
    `P(None, axis)`): T/n frames a position, on its device.  T must divide."""
    return split_positions(x, mesh.axis_devices(axis), dim=NTHWC_TIME)


def _exchange(shards: Sequence[torch.Tensor], left: int, right: int, fill: float, dim: int) -> Shards:
    """Each shard with `left` frames of its left neighbour before it and
    `right` of its right neighbour after it along `dim`; the outer edges
    get `fill`."""
    if left == 0 and right == 0:
        return list(shards)
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        t = x.shape[dim]
        if left > t or right > t:
            raise ValueError(f"a halo of ({left}, {right}) frames exceeds the local shard length {t}")
        parts = []
        if left:
            edge = x.narrow(dim, 0, left)
            parts.append(torch.full_like(edge, fill) if i == 0
                         else shards[i - 1].narrow(dim, shards[i - 1].shape[dim] - left, left).to(x.device))
        parts.append(x)
        if right:
            edge = x.narrow(dim, 0, right)
            parts.append(torch.full_like(edge, fill) if i == n - 1
                         else shards[i + 1].narrow(dim, 0, right).to(x.device))
        out.append(torch.cat(parts, dim=dim))
    return out


def halo_exchange(shards: Sequence[torch.Tensor], left: int, right: int | None = None,
                  fill: float = 0.0) -> Shards:
    """Pad each NTHWC shard's time axis with `left` frames from its left
    neighbour and `right` (default `left`) from its right neighbour (JAX
    temporal_halo.py:29-65).  The outer edges get `fill`: 0 matches TF-SAME
    conv padding, −inf a max pool's."""
    return _exchange(shards, left, left if right is None else right, fill, NTHWC_TIME)


def _temporal_halo(kt: int, st: int, shards: Sequence[torch.Tensor], dim: int) -> Tuple[int, int]:
    """The (left, right) halo of a TF-SAME window of kt frames at stride st
    over the global axis (JAX temporal_halo.py:86-95); every shard's length
    must be a multiple of st, so output phases align across shards."""
    for x in shards:
        if x.shape[dim] % st:
            raise ValueError(f"local shard length {x.shape[dim]} not divisible by stride {st}")
    total = max(kt - st, 0)
    return total // 2, total - total // 2


def _spatial_pads(x: torch.Tensor, window, strides) -> List[Tuple[int, int]]:
    """TF-SAME (before, after) pads of the H and W axes of an NCDHW tensor."""
    return [same_pads(int(n), k, s) for n, k, s in zip(x.shape[3:], window[1:], strides[1:])]


def _placed(kernel: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """kernel on a shard's device in its dtype (differentiable)."""
    return lambda x: kernel.to(device=x.device, dtype=x.dtype)


def _conv(shards: Sequence[torch.Tensor], kernel_shape, weight_for: Callable[[torch.Tensor], torch.Tensor],
          strides) -> Shards:
    """One TF-SAME conv of NCDHW time-sharded shards with a (F, C, kt, kh,
    kw) kernel, `weight_for(shard)` giving it on that shard's device."""
    strides = tuple(strides)
    pad_l, pad_r = _temporal_halo(int(kernel_shape[2]), strides[0], shards, NCDHW_TIME)
    out = []
    for x in _exchange(shards, pad_l, pad_r, 0.0, NCDHW_TIME):
        ph, pw = _spatial_pads(x, kernel_shape[2:], strides)
        # F.conv3d pads symmetrically: pad the TF-SAME excess after, the rest in the conv
        x = _pad(x, [(0, 0), (0, ph[1] - ph[0]), (0, pw[1] - pw[0])])
        out.append(F.conv3d(x, weight_for(x), stride=strides, padding=(0, ph[0], pw[0])))
    return out


def _pool(shards: Sequence[torch.Tensor], window, strides) -> Shards:
    """TF-SAME max pool of NCDHW time-sharded shards with −inf temporal
    halos: (3,3,3)/(1,1,1) on the max-pool kernel, the other windows by
    `models.common.max_pool_3d` (temporal VALID over the halo, spatial
    SAME)."""
    window, strides = tuple(window), tuple(strides)
    pad_l, pad_r = _temporal_halo(window[0], strides[0], shards, NCDHW_TIME)
    padded = _exchange(shards, pad_l, pad_r, float("-inf"), NCDHW_TIME)
    if window == (3, 3, 3) and strides == (1, 1, 1):
        # the kernel reads contiguous NTHWC: free for channels_last_3d shards
        return [to_ncdhw(max_pool_3x3x3_same(to_nthwc(x))[:, 1:-1]) for x in padded]
    out = []
    for x, shard in zip(padded, shards):
        x = _pad(x, [(0, 0)] + _spatial_pads(shard, window, strides), value=float("-inf"))
        out.append(max_pool_3d(x, window, strides, padding="VALID"))
    return out


def halo_conv3d(shards: Sequence[torch.Tensor], kernel: torch.Tensor, strides: Tuple[int, int, int]) -> Shards:
    """One TF-SAME conv3d of time-sharded NTHWC shards with the port's
    (F, C, kt, kh, kw) kernel, temporal stride 1 or more (JAX
    temporal_halo.py:68-103): the asymmetric SAME pads of the global time
    axis become asymmetric halos; each shard's length must be a multiple of
    the temporal stride."""
    return [to_nthwc(y) for y in _conv([to_ncdhw(x) for x in shards], kernel.shape, _placed(kernel), strides)]


def halo_max_pool3d(shards: Sequence[torch.Tensor], window: Tuple[int, int, int],
                    strides: Tuple[int, int, int]) -> Shards:
    """TF-SAME MaxPool3D of time-sharded NTHWC shards (JAX
    temporal_halo.py:145-175): −inf temporal halos, spatial SAME locally;
    covers I3D's (1,3,3)/(1,2,2), (3,3,3)/(1,1,1) (the max-pool kernel),
    (3,3,3)/(2,2,2) and (2,2,2)/(2,2,2)."""
    return [to_nthwc(y) for y in _pool([to_ncdhw(x) for x in shards], window, strides)]


def time_sharded_conv_stack(mesh: Mesh, kernels: Sequence[torch.Tensor],
                            time_axis: str = "time") -> Callable[[Sequence[torch.Tensor]], Shards]:
    """fn(shards) applying a ReLU-separated stack of stride-1 TF-SAME conv3d
    layers to NTHWC shards over `time_axis` (JAX temporal_halo.py:116-142);
    equal to the unsharded stack."""
    devices = mesh.axis_devices(time_axis)

    def fn(shards: Sequence[torch.Tensor]) -> Shards:
        _check_positions(shards, devices)
        x = [to_ncdhw(s.to(d)) for s, d in zip(shards, devices)]
        for k in kernels:
            x = [F.relu(y) for y in _conv(x, k.shape, _placed(k), (1, 1, 1))]
        return [to_nthwc(y) for y in x]

    return fn


def _check_positions(shards: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> None:
    if len(shards) != len(devices):
        raise ValueError(f"{len(shards)} shards for {len(devices)} positions")


def _conv_bn_layers(trunk: I3DTrunk) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """(conv weight, BN mean, var, bias) of every ConvBN of the trunk by its
    path; the stem's canonical 7³ weight whatever its form."""
    layers = {}
    for name, module in trunk.named_modules():
        if hasattr(module, "conv") and hasattr(module, "bn"):
            bn = module.bn
            layers[name] = (module.conv.weight.detach(), bn.running_mean, bn.running_var, bn.bias.detach())
    return layers


def time_sharded_i3d_trunk(mesh: Mesh, trunk: I3DTrunk, time_axis: str = "time",
                           bn_eps: float = KERAS_BN_EPS) -> Callable[[Sequence[torch.Tensor]], Shards]:
    """The inference-mode I3D trunk (`models.i3d.I3DTrunk`, any stem form:
    its canonical `Conv3d_1a_7x7` weight is used) over a time-sharded long
    clip (JAX temporal_halo.py:178-243): every temporal conv and pool runs
    with halo exchange, the rest locally, and BN is the eval formula
    (y − mean)·rsqrt(var + eps) + bias in f32.  Returns fn(shards) →
    shards: NTHWC (N, T/n, H, W, 3) clips, one a position on its device, to
    (N, T/(8n), H/32, W/32, 1024) features equal to the unsharded trunk's.
    T/n must be even at the stem and at each stride-2 temporal pool (T=64
    over 8 positions, T=32 over 4).  The computation runs in the shards'
    dtype; weights are cast to it once a (device, dtype)."""
    devices = mesh.axis_devices(time_axis)
    layers = _conv_bn_layers(trunk)
    placed: Dict[Tuple[torch.device, torch.dtype], Dict[str, Tuple[torch.Tensor, ...]]] = {}

    def params(x: torch.Tensor, name: str) -> Tuple[torch.Tensor, ...]:
        key = (x.device, x.dtype)
        if key not in placed:
            placed[key] = {
                n: (w.to(device=x.device, dtype=x.dtype).contiguous(memory_format=torch.channels_last_3d),
                    *(t.to(device=x.device, dtype=torch.float32).view(1, -1, 1, 1, 1) for t in (m, v, b)))
                for n, (w, m, v, b) in layers.items()
            }
        return placed[key][name]

    def conv_bn(x: Shards, name: str, strides=(1, 1, 1)) -> Shards:
        out = []
        for y in _conv(x, layers[name][0].shape, lambda s: params(s, name)[0], strides):
            _, mean, var, bias = params(y, name)
            y = ((y.float() - mean) * torch.rsqrt(var + bn_eps) + bias).relu()
            out.append(y.to(x[0].dtype).contiguous(memory_format=torch.channels_last_3d))
        return out

    def block(x: Shards, name: str) -> Shards:
        b0 = conv_bn(x, f"{name}.b0_1x1")
        b1 = conv_bn(conv_bn(x, f"{name}.b1_1x1"), f"{name}.b1_3x3")
        b2 = conv_bn(conv_bn(x, f"{name}.b2_1x1"), f"{name}.b2_3x3")
        b3 = conv_bn(_pool(x, (3, 3, 3), (1, 1, 1)), f"{name}.b3_1x1")
        return [torch.cat(parts, dim=1) for parts in zip(b0, b1, b2, b3)]

    def fn(shards: Sequence[torch.Tensor]) -> Shards:
        _check_positions(shards, devices)
        x = [to_ncdhw(s.to(d)) for s, d in zip(shards, devices)]
        x = conv_bn(x, "Conv3d_1a_7x7", (2, 2, 2))
        x = _pool(x, (1, 3, 3), (1, 2, 2))
        x = conv_bn(x, "Conv3d_2b_1x1")
        x = conv_bn(x, "Conv3d_2c_3x3")
        x = _pool(x, (1, 3, 3), (1, 2, 2))
        for pool, names in _BLOCK_GROUPS:
            if pool is not None:
                x = _pool(x, *pool)
            for name in names:
                x = block(x, name)
        return [to_nthwc(y) for y in x]

    return fn
