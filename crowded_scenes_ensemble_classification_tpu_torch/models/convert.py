"""flax → torch variable conversion for the ported model families.

The flax tree is `{'params': ..., 'batch_stats': ...}` with numpy leaves
(convert jax arrays with `np.asarray` first, so this module needs no JAX).
Key for key (flax path `trunk/Mixed_3b/b0_1x1/conv/kernel` becomes
`trunk.Mixed_3b.b0_1x1.conv.weight`):

- conv kernels (kt, kh, kw, in, out) DHWIO → OIDHW; Dense kernels
  (in, out) → `Linear.weight` (out, in); biases as they are;
- `bn/bias`, `bn/mean`, `bn/var` → BatchNorm `bias`, `running_mean`,
  `running_var`; `bn/scale` (R3D's full-affine BN) → `weight`, and where
  the reference has no gamma (I3D's scale=False) the weight is a fixed 1;
- the int8 state, when the variables have it: `qstats/.../act_absmax` →
  the site's `act_absmax` (f32), `qparams/.../k8` (int8 DHWIO) → `k8`
  (int8 OIDHW) and `qparams/.../sw` → `sw` (f32), whatever `dtype` is.

Each family's converter refuses a key its family does not have; the
port's `load_state_dict(strict=True)` then checks names and shapes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _walk(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict or flax FrozenDict
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(variables: Dict, family: str, bn_scale: bool, conv_bias: bool,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The shared walk: `bn_scale` says whether the family's BatchNorms
    carry a trained gamma, `conv_bias` whether its convs carry a bias;
    floating values come out in `dtype`."""
    _tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables["params"]):
        *mod, name = path
        key = ".".join(mod)
        is_bn = mod[-1] == "bn"
        if name == "kernel" and leaf.ndim == 5 and not is_bn:
            out[f"{key}.weight"] = _tensor(leaf.transpose(4, 3, 0, 1, 2))
        elif name == "kernel" and leaf.ndim == 2 and not is_bn:  # Dense
            out[f"{key}.weight"] = _tensor(leaf.T)
        elif name == "bias" and is_bn:
            out[f"{key}.bias"] = _tensor(leaf)
            if not bn_scale:
                out[f"{key}.weight"] = torch.ones(leaf.shape, dtype=dtype)
            out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif name == "scale" and is_bn and bn_scale:
            out[f"{key}.weight"] = _tensor(leaf)
        elif name == "bias" and (conv_bias or mod[-1] == "predictions"):  # the I3D head's Dense
            out[f"{key}.bias"] = _tensor(leaf)
        else:
            raise KeyError(f"unexpected flax param for {family}: {'/'.join(path)}")
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, name = path
        if name not in stats or mod[-1] != "bn":
            raise KeyError(f"unexpected flax batch stat for {family}: {'/'.join(path)}")
        out[f"{'.'.join(mod)}.{stats[name]}"] = _tensor(leaf)
    for path, leaf in _walk(variables.get("qstats", {})):
        if path[-1] != "act_absmax":
            raise KeyError(f"unexpected flax qstat for {family}: {'/'.join(path)}")
        out[".".join(path)] = torch.tensor(np.float32(leaf))
    for path, leaf in _walk(variables.get("qparams", {})):
        *mod, name = path
        if name == "k8" and leaf.ndim == 5:
            out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(leaf.transpose(4, 3, 0, 1, 2)))
        elif name == "sw":
            out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(leaf, dtype=np.float32))
        else:
            raise KeyError(f"unexpected flax qparam for {family}: {'/'.join(path)}")
    return out


def i3d_state_dict_from_flax(variables: Dict, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """flax I3D variables (numpy leaves) → the port's I3D `state_dict`:
    bias-free convs, BN without gamma, `predictions`."""
    return _convert(variables, "I3D", bn_scale=False, conv_bias=False, dtype=dtype)


def i3d_kinetics_state_dict_from_flax(variables: Dict, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """flax I3DKinetics variables → the port's `I3DKinetics` state dict: the
    I3D trunk's rules, and the `Conv3d_6a_1x1` conv head with its bias."""
    out = _convert(variables, "I3D_KINETICS", bn_scale=False, conv_bias=True, dtype=dtype)
    for key in out:
        if key.endswith(".bias") and not key.startswith("Conv3d_6a_1x1.") and ".bn." not in key:
            raise KeyError(f"unexpected flax param for I3D_KINETICS: {key}")
    return out


def two_stream_state_dict_from_flax(variables: Dict, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """flax TwoStreamI3D variables → the port's `state_dict`: the I3D rules
    under the `rgb_trunk/` and `flow_trunk/` prefixes, and `predictions`."""
    out = _convert(variables, "TWOSTREAM_I3D", bn_scale=False, conv_bias=False, dtype=dtype)
    for key in out:
        if not key.startswith(("rgb_trunk.", "flow_trunk.", "predictions.")):
            raise KeyError(f"unexpected flax param for TWOSTREAM_I3D: {key}")
    return out


def c3d_state_dict_from_flax(variables: Dict, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """flax C3D variables → the port's C3D `state_dict`: conv1…conv5b
    kernels and biases, fc6/fc7/fc8; no BatchNorm."""
    if variables.get("batch_stats"):
        raise KeyError("unexpected flax batch stats for C3D: it has no BatchNorm")
    return _convert(variables, "C3D", bn_scale=False, conv_bias=True, dtype=dtype)


def r3d_state_dict_from_flax(variables: Dict, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """flax R3D variables → the port's R3D `state_dict`: convs and
    shortcut projections with bias, full-affine BN (`scale` → `weight`)."""
    return _convert(variables, "R3D", bn_scale=True, conv_bias=True, dtype=dtype)


def state_dict_from_flax(model_type: str, variables: Dict,
                         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The converter of `model_type`'s family (or 'I3D_KINETICS', the
    with-top Kinetics I3D); floating values in `dtype` (float32, what every
    module holds its master weights in, unless asked)."""
    if model_type == "I3D":
        return i3d_state_dict_from_flax(variables, dtype)
    if model_type == "I3D_KINETICS":
        return i3d_kinetics_state_dict_from_flax(variables, dtype)
    if model_type == "TWOSTREAM_I3D":
        return two_stream_state_dict_from_flax(variables, dtype)
    if model_type == "C3D":
        return c3d_state_dict_from_flax(variables, dtype)
    if model_type.startswith("R3D_"):
        return r3d_state_dict_from_flax(variables, dtype)
    raise ValueError(f"Unknown model_type {model_type!r}")
