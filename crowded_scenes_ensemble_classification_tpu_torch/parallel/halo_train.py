"""Training on time-sharded long clips.

Counterpart of `crowded_scenes_ensemble_classification_tpu/parallel/halo_train.py`
(lines 39-135):

- train-mode BatchNorm reduces over the global (N, T, H, W): the sums of
  y and y² over every position's shard are added up on the first
  position's device (JAX `lax.psum` over the time axis), in f32, and the
  moments are flax's: mean = Σy/n and the biased var = Σy²/n − mean²
  (Keras eps 1e-3, scale=False);
- gradients come from autograd through the halo exchange (slices, `.to()`
  and `cat`, `parallel.temporal_halo`) and through the summed statistics,
  so the sharded step's gradients equal the unsharded step's.

The port's `KerasBatchNorm3d` is not used here: in train mode it would
normalise each shard by its own moments.  The (3,3,3)/(1,1,1) pool runs
the max-pool kernel and its gradient the gradient kernel
(`csec::max_pool_3x3x3_same_backward`, through the op's autograd).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.mesh import Mesh
from ..models.common import KERAS_BN_EPS, KERAS_BN_MOMENTUM, to_ncdhw, to_nthwc
from .temporal_halo import Shards, _check_positions, _conv, _placed, _pool


def _conv_bn_relu_train(shards: Sequence[torch.Tensor], kernel: torch.Tensor, bias: torch.Tensor, strides,
                        eps: float) -> Tuple[Shards, torch.Tensor, torch.Tensor]:
    """`halo_conv_bn_relu_train` on NCDHW shards."""
    ys = _conv(shards, kernel.shape, _placed(kernel), strides)
    home = ys[0].device
    s = sum(y.float().sum(dim=(0, 2, 3, 4)).to(home) for y in ys)
    ss = sum(y.float().square().sum(dim=(0, 2, 3, 4)).to(home) for y in ys)
    count = sum(y.numel() // y.shape[1] for y in ys)
    mean = s / count
    var = ss / count - mean.square()
    scale = torch.rsqrt(var + eps)
    out = []
    for y in ys:
        m, r, b = (t.to(y.device).view(1, -1, 1, 1, 1) for t in (mean, scale, bias))
        out.append(F.relu((y.float() - m) * r + b).to(y.dtype))
    return out, mean, var


def halo_conv_bn_relu_train(shards: Sequence[torch.Tensor], kernel: torch.Tensor, bias: torch.Tensor,
                            strides: Tuple[int, int, int] = (1, 1, 1), eps: float = KERAS_BN_EPS):
    """One train-mode conv3d_bn of time-sharded NTHWC shards with the
    port's (F, C, kt, kh, kw) kernel → (relu(bn(conv(x))) shards, batch
    mean, batch var), the moments those of the gathered tensor (JAX
    halo_train.py:39-58), on the first position's device."""
    out, mean, var = _conv_bn_relu_train([to_ncdhw(x) for x in shards], kernel, bias, strides, eps)
    return [to_nthwc(y) for y in out], mean, var


LayerSpec = Dict  # {"strides": (st, sh, sw), "pool": Optional[(window, strides)]}


def make_time_sharded_convbn_train_step(mesh: Mesh, layer_specs: Sequence[LayerSpec], time_axis: str = "time",
                                        eps: float = KERAS_BN_EPS):
    """A train step over a ConvBN (+ optional max pool) stack with the time
    axis sharded over `time_axis` (JAX halo_train.py:61-120).

    step(params, x_shards, target_shards) → (loss, grads, batch_stats):
      params: a tuple of {"kernel": (F, C, kt, kh, kw), "bias": (F,)} a
        layer, on the first position's device;
      x_shards, target_shards: NTHWC, time-sharded over the mesh;
      loss: the global MSE (a 0-d tensor);
      grads: the tree of params, equal to the unsharded step's;
      batch_stats: a tuple of {"mean", "var"} batch moments a layer.

    Apply the Keras running-stat update outside (`update_running_stats`)."""
    devices = mesh.axis_devices(time_axis)

    def step(params, x_shards: Sequence[torch.Tensor], target_shards: Sequence[torch.Tensor]):
        _check_positions(x_shards, devices)
        leaves = tuple({k: p[k].detach().requires_grad_(True) for k in ("kernel", "bias")} for p in params)
        with torch.enable_grad():
            h = [to_ncdhw(x.to(d)) for x, d in zip(x_shards, devices)]
            stats = []
            for spec, layer in zip(layer_specs, leaves):
                h, mean, var = _conv_bn_relu_train(h, layer["kernel"], layer["bias"],
                                                   tuple(spec.get("strides", (1, 1, 1))), eps)
                stats.append({"mean": mean.detach(), "var": var.detach()})
                pool = spec.get("pool")
                if pool is not None:
                    h = _pool(h, pool[0], pool[1])
            home = leaves[0]["kernel"].device
            se = sum((y.float() - to_ncdhw(t.to(y.device)).float()).square().sum().to(home)
                     for y, t in zip(h, target_shards))
            loss = se / sum(y.numel() for y in h)
            flat = [layer[k] for layer in leaves for k in ("kernel", "bias")]
            grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        return loss.detach(), tuple({"kernel": next(it), "bias": next(it)} for _ in leaves), tuple(stats)

    return step


def update_running_stats(running: Sequence[Dict], batch: Sequence[Dict], momentum: float = KERAS_BN_MOMENTUM):
    """The Keras/flax running average of each layer's BN moments (JAX
    halo_train.py:123-135): momentum·running + (1 − momentum)·batch."""
    return tuple(
        {
            "mean": momentum * r["mean"] + (1.0 - momentum) * b["mean"],
            "var": momentum * r["var"] + (1.0 - momentum) * b["var"],
        }
        for r, b in zip(running, batch)
    )
