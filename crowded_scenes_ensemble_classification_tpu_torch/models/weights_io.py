"""Keras-HDF5 weights for the pretrained model families: reading, writing
and conversion to the port's state dicts.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/weights_io.py`
(all of it).  The reference loads pretrained checkpoints in the Keras 2.2.4
HDF5 layout: C3D sports1M (train.py:1672-1678), I3D Kinetics/ImageNet per
stream (train.py:41-57, 808, 830-835), TwoStream one file per stream
(train.py:989-997); R3D trains from scratch, but a Keras-layout R3D
checkpoint converts too.

The converters are numpy only and build the same flax-shaped tree
(`{'params': ..., 'batch_stats': ...}`) as the JAX converters, leaf for
leaf: Keras Conv3D kernels (kt, kh, kw, in, out) are flax's DHWIO, so
conversion is re-labelling; BatchNorm maps gamma/beta → scale/bias and the
moving statistics → batch_stats mean/var (I3D's BNs have no gamma,
train.py:665).  `state_dict_from_keras` takes such a tree through
`models/convert.state_dict_from_flax`, so one key mapping serves flax
variables and Keras checkpoints.  The converters take layer dicts
(`{layer: {weight: array}}`), not files: h5py is imported only by
`read_keras_h5` and `write_keras_h5`, so a machine without it converts
layer dicts all the same.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .convert import state_dict_from_flax
from .i3d import INCEPTION_SPECS
from .r3d import R3D_PRESETS

Layers = Dict[str, Dict[str, np.ndarray]]

# ----------------------------------------------------------------------
# Keras h5 files (JAX weights_io.py:34-72)
# ----------------------------------------------------------------------


def read_keras_h5(path: str) -> Layers:
    """→ {layer_name: {weight_basename: array}}.  Handles both the
    `model_weights/` wrapper (full-model saves) and flat weight files, and
    strips the `:0` tensor suffixes."""
    import h5py

    out: Layers = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                parts = [p for p in name.split("/") if p]
                base = parts[-1].split(":")[0]
                layer = parts[-2] if len(parts) >= 2 else parts[0]
                out.setdefault(layer, {})[base] = np.asarray(obj)

        root.visititems(visit)
    return out


def write_keras_h5(path: str, layers: Layers) -> str:
    """Write `layers` in the Keras 2.x weight layout: each dataset at
    `layer/layer/base:0`, the path Keras' `load_weights` resolves from the
    layer group's `weight_names`."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [k.encode() for k in layers]
        for layer, weights in layers.items():
            g = f.create_group(layer) if layer not in f else f[layer]
            names = []
            for base, arr in weights.items():
                full = f"{layer}/{base}:0"
                g.create_dataset(full, data=np.asarray(arr))
                names.append(full.encode())
            g.attrs["weight_names"] = names
    return path


def _put(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _get(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ----------------------------------------------------------------------
# C3D (JAX weights_io.py:79-119)
# ----------------------------------------------------------------------

C3D_CONV_LAYERS = ("conv1", "conv2", "conv3a", "conv3b", "conv4a", "conv4b", "conv5a", "conv5b")
C3D_DENSE_LAYERS = ("fc6", "fc7", "fc8")


def c3d_variables_from_keras(
    h5_layers: Layers,
    num_classes: Optional[int] = None,
    head_init: Optional[np.ndarray] = None,
    head_bias: Optional[np.ndarray] = None,
) -> Dict:
    """Keras C3D layers → flax-shaped variables.  When `num_classes`
    differs from the checkpoint's fc8 width, the head is replaced (the
    reference's pop-softmax surgery, train.py:1672-1678) by
    head_init/head_bias, flax-shaped (in, out) and (out,), or zeros."""
    params = {name: {"kernel": _f32(h5_layers[name]["kernel"]), "bias": _f32(h5_layers[name]["bias"])}
              for name in C3D_CONV_LAYERS + C3D_DENSE_LAYERS}
    if num_classes is not None and num_classes != params["fc8"]["kernel"].shape[-1]:
        fan_in = params["fc8"]["kernel"].shape[0]
        params["fc8"] = {
            "kernel": np.zeros((fan_in, num_classes), np.float32) if head_init is None else head_init,
            "bias": np.zeros((num_classes,), np.float32) if head_bias is None else head_bias,
        }
    return {"params": params}


def c3d_variables_to_keras(variables: Dict) -> Layers:
    params = variables["params"]
    return {name: {"kernel": np.asarray(params[name]["kernel"]), "bias": np.asarray(params[name]["bias"])}
            for name in C3D_CONV_LAYERS + C3D_DENSE_LAYERS}


# ----------------------------------------------------------------------
# I3D (JAX weights_io.py:126-279)
# ----------------------------------------------------------------------

# trunk module name → reference Keras layer stem (the stream suffix and
# _conv/_bn are appended by conv3d_bn, train.py:646-650)
_I3D_STEM_LAYERS = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")

# branch-module name → reference conv name infix in each Mixed block
_BRANCH_INFIX = {
    "b0_1x1": "0a_1x1",
    "b1_1x1": "1a_1x1",
    "b1_3x3": "1b_3x3",
    "b2_1x1": "2a_1x1",
    "b2_3x3": "2b_3x3",
    "b3_1x1": "3b_1x1",
}


def _i3d_layer_map(stream_suffix: str) -> Dict[Tuple[str, ...], str]:
    """{trunk-relative module path: Keras layer stem}."""
    mapping = {(name,): name + stream_suffix for name in _I3D_STEM_LAYERS}
    for block in INCEPTION_SPECS:
        short = block.split("_")[1]  # "3b" …
        for branch, infix in _BRANCH_INFIX.items():
            mapping[(block, branch)] = f"Conv3d_{short}_{infix}{stream_suffix}"
    return mapping


def i3d_trunk_variables_from_keras(h5_layers: Layers, stream: str = "rgb") -> Tuple[Dict, Dict]:
    """→ (params, batch_stats) of one I3D trunk."""
    params: Dict = {}
    stats: Dict = {}
    for mod_path, stem in _i3d_layer_map("_" + stream).items():
        conv, bn = h5_layers[stem + "_conv"], h5_layers[stem + "_bn"]
        _put(params, mod_path + ("conv",), {"kernel": _f32(conv["kernel"])})
        _put(params, mod_path + ("bn",), {"bias": _f32(bn["beta"])})
        _put(stats, mod_path + ("bn",), {"mean": _f32(bn["moving_mean"]), "var": _f32(bn["moving_variance"])})
    return params, stats


def i3d_variables_from_keras(h5_layers: Layers, stream: str = "rgb", num_classes: Optional[int] = None) -> Dict:
    """A single-stream I3D: the trunk under 'trunk', and the 'predictions'
    Dense when the checkpoint has one of `num_classes` outputs (or any, when
    num_classes is None)."""
    params, stats = i3d_trunk_variables_from_keras(h5_layers, stream)
    variables = {"params": {"trunk": params}, "batch_stats": {"trunk": stats}}
    if "predictions" in h5_layers:
        dense = h5_layers["predictions"]
        k = _f32(dense["kernel"])
        if num_classes is None or k.shape[-1] == num_classes:
            variables["params"]["predictions"] = {"kernel": k, "bias": _f32(dense["bias"])}
    return variables


def i3d_trunk_variables_to_keras(params: Dict, stats: Dict, stream: str = "rgb") -> Layers:
    layers: Layers = {}
    for mod_path, stem in _i3d_layer_map("_" + stream).items():
        bn_p, bn_s = _get(params, mod_path + ("bn",)), _get(stats, mod_path + ("bn",))
        layers[stem + "_conv"] = {"kernel": np.asarray(_get(params, mod_path + ("conv",))["kernel"])}
        layers[stem + "_bn"] = {
            "beta": np.asarray(bn_p["bias"]),
            "moving_mean": np.asarray(bn_s["mean"]),
            "moving_variance": np.asarray(bn_s["var"]),
        }
    return layers


def i3d_variables_to_keras(variables: Dict, stream: str = "rgb") -> Layers:
    layers = i3d_trunk_variables_to_keras(variables["params"]["trunk"], variables["batch_stats"]["trunk"], stream)
    if "predictions" in variables["params"]:
        d = variables["params"]["predictions"]
        layers["predictions"] = {"kernel": np.asarray(d["kernel"]), "bias": np.asarray(d["bias"])}
    return layers


def i3d_kinetics_variables_from_keras(h5_layers: Layers, stream: str = "rgb") -> Dict:
    """A with-top Kinetics checkpoint → `I3DKinetics` variables: the trunk
    and the `Conv3d_6a_1x1` 1×1×1 conv head with a bias and no BN
    (reference train.py:1196-1213)."""
    params, stats = i3d_trunk_variables_from_keras(h5_layers, stream)
    head = h5_layers[f"Conv3d_6a_1x1_{stream}_conv"]
    params = {"trunk": params, "Conv3d_6a_1x1": {"conv": {"kernel": _f32(head["kernel"]), "bias": _f32(head["bias"])}}}
    return {"params": params, "batch_stats": {"trunk": stats}}


def twostream_variables_from_keras(rgb_h5_layers: Layers, flow_h5_layers: Layers) -> Dict:
    """Two per-stream checkpoints → TwoStreamI3D variables: the trunks only;
    the fusion Dense trains fresh (reference train.py:989-1009)."""
    rgb_p, rgb_s = i3d_trunk_variables_from_keras(rgb_h5_layers, "rgb")
    flow_p, flow_s = i3d_trunk_variables_from_keras(flow_h5_layers, "flow")
    return {
        "params": {"rgb_trunk": rgb_p, "flow_trunk": flow_p},
        "batch_stats": {"rgb_trunk": rgb_s, "flow_trunk": flow_s},
    }


def merge_pretrained(init_variables: Dict, pretrained: Dict) -> Dict:
    """Overlay pretrained subtrees onto fresh variables (a leaf the
    checkpoint lacks, a new head for one, keeps its fresh value); a leaf
    both define with two shapes raises (JAX weights_io.py:282-310)."""

    def overlay(dst, src):
        if not isinstance(src, dict):
            return src
        out = dict(dst) if isinstance(dst, dict) else {}
        for k, v in src.items():
            out[k] = overlay(out.get(k, {}), v)
        return out

    def check(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in b:
                if k in a:
                    check(a[k], b[k], f"{path}/{k}")
        elif hasattr(a, "shape") and hasattr(b, "shape") and tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"shape mismatch at {path}: {a.shape} vs {b.shape}")

    merged = {col: overlay(init_variables[col], pretrained.get(col, {})) for col in init_variables}
    for col in merged:
        check(init_variables.get(col, {}), pretrained.get(col, {}), col)
    return merged


# ----------------------------------------------------------------------
# R3D (JAX weights_io.py:318-437)
# ----------------------------------------------------------------------


def _r3d_layer_walk(depth: int):
    """(module path, Keras auto-name, kind) triples in the reference's
    construction order (Resnet3DBuilder.build, train.py:1483-1516).  The
    reference names no R3D layer, so Keras 2.2.4 auto-names them per type
    with fresh-session counters (conv3d_1…, batch_normalization_1…,
    dense_1); per block: [pre-activation BN] → conv(s), the `_shortcut3d`
    projection conv last (train.py:1324-1346, 1368-1425)."""
    kind, reps = R3D_PRESETS[depth]
    counts = {"conv": 0, "bn": 0}
    entries = []

    def add(path, what):
        counts[what] += 1
        entries.append((path, f"{'conv3d' if what == 'conv' else 'batch_normalization'}_{counts[what]}", what))

    add(("conv1",), "conv")
    add(("stem_bnrelu", "bn"), "bn")
    in_ch = 64
    for s, r in enumerate(reps):
        out_ch = 64 * 2**s * (4 if kind == "bottleneck" else 1)
        for i in range(r):
            blk = f"stage{s}_block{i}"
            if not (s == 0 and i == 0):
                add((blk, "preact1", "bn"), "bn")
            add((blk, "conv1"), "conv")
            add((blk, "preact2", "bn"), "bn")
            add((blk, "conv2"), "conv")
            if kind == "bottleneck":
                add((blk, "preact3", "bn"), "bn")
                add((blk, "conv3"), "conv")
            if (i == 0 and s != 0) or in_ch != out_ch:
                add((blk, "shortcut", "proj"), "conv")
            in_ch = out_ch
    add(("final_bnrelu", "bn"), "bn")
    entries.append((("predictions",), "dense_1", "dense"))
    return entries


def r3d_variables_from_keras(h5_layers: Layers, depth: int, num_classes: Optional[int] = None) -> Dict:
    """A Keras-layout R3D checkpoint → flax-shaped variables.  A head of
    another width than `num_classes` is dropped, so the fresh one stays
    (the C3D pop-softmax convention)."""
    params: Dict = {}
    stats: Dict = {}
    for path, name, kind in _r3d_layer_walk(depth):
        w = h5_layers[name]
        if kind in ("conv", "dense"):
            if kind == "dense" and num_classes is not None and np.asarray(w["kernel"]).shape[-1] != num_classes:
                continue
            _put(params, path + ("kernel",), _f32(w["kernel"]))
            _put(params, path + ("bias",), _f32(w["bias"]))
        else:  # full-affine BN (Keras BatchNormalization defaults)
            _put(params, path + ("scale",), _f32(w["gamma"]))
            _put(params, path + ("bias",), _f32(w["beta"]))
            _put(stats, path + ("mean",), _f32(w["moving_mean"]))
            _put(stats, path + ("var",), _f32(w["moving_variance"]))
    return {"params": params, "batch_stats": stats}


def r3d_variables_to_keras(variables: Dict, depth: int) -> Layers:
    """The inverse of r3d_variables_from_keras."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    layers: Layers = {}
    for path, name, kind in _r3d_layer_walk(depth):
        if kind in ("conv", "dense"):
            layers[name] = {"kernel": np.asarray(_get(params, path + ("kernel",))),
                            "bias": np.asarray(_get(params, path + ("bias",)))}
        else:
            layers[name] = {
                "gamma": np.asarray(_get(params, path + ("scale",))),
                "beta": np.asarray(_get(params, path + ("bias",))),
                "moving_mean": np.asarray(_get(stats, path + ("mean",))),
                "moving_variance": np.asarray(_get(stats, path + ("var",))),
            }
    return layers


# ----------------------------------------------------------------------
# Keras layers → the port's state dict
# ----------------------------------------------------------------------


def state_dict_from_keras(
    model_type: str,
    layers: Layers,
    flow_layers: Optional[Layers] = None,
    num_classes: Optional[int] = None,
    include_top: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The port's state dict of what a checkpoint of `model_type` holds: its
    flax-shaped variables, as the JAX converters build them, through
    `models.convert.state_dict_from_flax`.  C3D keeps its head verbatim;
    I3D keeps a 'predictions' Dense of `num_classes` outputs, or with
    include_top the Kinetics head (an `I3DKinetics` state dict); TwoStream
    takes the rgb stream's layers and `flow_layers`; R3D drops a head of
    another width.  The keys of a fresh head the checkpoint lacks are
    absent: `models.pretrained.load_pretrained` overlays the result onto a
    module."""
    if include_top and model_type != "I3D":
        raise ValueError("include_top applies to I3D only (the Kinetics classification top)")
    if model_type == "C3D":
        variables = c3d_variables_from_keras(layers)
    elif model_type == "I3D":
        variables = (i3d_kinetics_variables_from_keras(layers) if include_top
                     else i3d_variables_from_keras(layers, num_classes=num_classes))
    elif model_type == "TWOSTREAM_I3D":
        if flow_layers is None:
            raise ValueError("TWOSTREAM_I3D needs the flow stream's layers")
        variables = twostream_variables_from_keras(layers, flow_layers)
    elif model_type.startswith("R3D_"):
        variables = r3d_variables_from_keras(layers, int(model_type.split("_")[1]), num_classes=num_classes)
    else:
        raise ValueError(f"no Keras conversion for {model_type!r}")
    return state_dict_from_flax("I3D_KINETICS" if include_top else model_type, variables, dtype)
