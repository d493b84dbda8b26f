"""flax → torch variable conversion for the ported I3D.

The flax tree is `{'params': ..., 'batch_stats': ...}` with numpy leaves
(convert jax arrays with `np.asarray` first, so this module needs no JAX).
Key for key (flax path `trunk/Mixed_3b/b0_1x1/conv/kernel` becomes
`trunk.Mixed_3b.b0_1x1.conv.weight`):

- conv kernels (kt, kh, kw, in, out) DHWIO → OIDHW;
- `bn/bias`, `bn/mean`, `bn/var` → BatchNorm `bias`, `running_mean`,
  `running_var`; the reference's absent gamma (scale=False) is a fixed 1;
- `predictions/kernel` (in, out) → `Linear.weight` (out, in).
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


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def i3d_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax I3D variables (numpy leaves) → the port's I3D `state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables["params"]):
        *mod, name = path
        key = ".".join(mod)
        if name == "kernel" and mod[-1] == "conv":
            out[f"{key}.weight"] = _tensor(leaf.transpose(4, 3, 0, 1, 2))
        elif name == "kernel":  # Dense
            out[f"{key}.weight"] = _tensor(leaf.T)
        elif name == "bias" and mod[-1] == "bn":
            out[f"{key}.bias"] = _tensor(leaf)
            out[f"{key}.weight"] = torch.ones(leaf.shape, dtype=torch.float32)
            out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif name == "bias":
            out[f"{key}.bias"] = _tensor(leaf)
        else:
            raise KeyError(f"unexpected flax param {'/'.join(path)}")
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, name = path
        if name not in stats:
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        out[f"{'.'.join(mod)}.{stats[name]}"] = _tensor(leaf)
    return out
