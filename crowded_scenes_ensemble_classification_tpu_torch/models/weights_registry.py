"""The pretrained-weight registry and the one-call Keras conversion.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/weights_registry.py`
(lines 1-63 and 108-198): the reference's I3D Kinetics/ImageNet URL tables
(train.py:41-57), the file names Keras caches them under (train.py:775-804,
941-962), the C3D sports1M file name (train.py:1673), and the conversion of
a Keras-layout checkpoint into a file the port loads.  Nothing is
downloaded: `placed_weights` resolves a registry name to the file placed
by hand where JAX `fetch_weights` caches its download (JAX
weights_registry.py:64-80), and raises with that path when it is absent
(the download is left out: no network, ROADMAP Queue 1 item 8).

A converted file is a torch state dict (`torch.save`, usually `.pt`),
written atomically, that `load_converted` and `models.pretrained.
load_pretrained` read.  It is the port's counterpart of the JAX package's
`.msgpack` of flax variables; a `.msgpack` is not read here (it needs flax).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch

from .weights_io import Layers, read_keras_h5, state_dict_from_keras

WEIGHTS_NAME = (
    "rgb_kinetics_only",
    "flow_kinetics_only",
    "rgb_imagenet_and_kinetics",
    "flow_imagenet_and_kinetics",
)

_RELEASE = "https://github.com/dlpbc/keras-kinetics-i3d/releases/download/v0.2"

# with the classification top (reference train.py:44-49)
WEIGHTS_PATH = {
    "rgb_kinetics_only": f"{_RELEASE}/rgb_inception_i3d_kinetics_only_tf_dim_ordering_tf_kernels.h5",
    "flow_kinetics_only": f"{_RELEASE}/flow_inception_i3d_kinetics_only_tf_dim_ordering_tf_kernels.h5",
    "rgb_imagenet_and_kinetics": f"{_RELEASE}/rgb_inception_i3d_imagenet_and_kinetics_tf_dim_ordering_tf_kernels.h5",
    "flow_imagenet_and_kinetics": f"{_RELEASE}/flow_inception_i3d_imagenet_and_kinetics_tf_dim_ordering_tf_kernels.h5",
}

# without it (reference train.py:52-57): what the Crowd-11 fine-tune loads
WEIGHTS_PATH_NO_TOP = {name: url.replace("_tf_kernels.h5", "_tf_kernels_no_top.h5")
                       for name, url in WEIGHTS_PATH.items()}

# C3D sports1M: the reference expects a local file (train.py:1673)
SPORTS1M_FILENAME = "sports1M_weights_tf.h5"

Source = Union[str, Layers]


def cached_filename(name: str, include_top: bool) -> str:
    """The file name the reference passes to Keras' get_file
    (train.py:775-804)."""
    return f"i3d_inception_{name}{'' if include_top else '_no_top'}.h5"


def default_cache_dir() -> str:
    """Where a placed checkpoint is looked for by default: the counterpart
    of Keras' ~/.keras/models (get_file cache_subdir='models')."""
    return os.environ.get(
        "CROWDED_SCENES_TPU_WEIGHTS_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "crowded_scenes_tpu", "models"),
    )


def placed_weights(name: str, include_top: bool = False, cache_dir: Optional[str] = None) -> str:
    """The local h5 path of registry checkpoint `name`, placed by hand in
    `cache_dir` (`default_cache_dir()` when None) under the reference's
    file name.  Raises KeyError for an unknown name and FileNotFoundError,
    naming the path to place the file at, when it is absent."""
    if name not in WEIGHTS_NAME:
        raise KeyError(f"unknown weights name {name!r}; known: {WEIGHTS_NAME}")
    path = os.path.join(cache_dir or default_cache_dir(), cached_filename(name, include_top))
    if not os.path.exists(path):
        url = (WEIGHTS_PATH if include_top else WEIGHTS_PATH_NO_TOP)[name]
        raise FileNotFoundError(f"{path} is not placed: download {url} elsewhere and place it at {path} "
                                "(the port downloads nothing, ROADMAP Queue 1 item 8)")
    return path


def keras_layers(source: Source) -> Layers:
    """A Keras checkpoint's layer dict: `source` itself, or read from the
    h5 file it names."""
    return source if isinstance(source, dict) else read_keras_h5(source)


def convert_keras_checkpoint(
    model_type: str,
    out_path: str,
    rgb_h5: Optional[Source] = None,
    flow_h5: Optional[Source] = None,
    num_classes: Optional[int] = None,
    include_top: bool = False,
) -> Tuple[str, Dict[str, torch.Tensor]]:
    """Convert reference-format Keras checkpoint(s) (h5 paths or layer
    dicts) into one state-dict file at `out_path` → (out_path, state dict).

    model_type: C3D | I3D | TWOSTREAM_I3D | R3D_{18,34,50,101,152}.  C3D
    keeps its checkpoint head (sports1M's 487-way fc8): the head surgery
    happens at load time (`models.pretrained`).  num_classes filters I3D's
    'predictions' Dense and R3D's head.  include_top (I3D only) converts a
    with-top Kinetics checkpoint into an `I3DKinetics` state dict."""
    if include_top and model_type != "I3D":
        raise ValueError("include_top only applies to I3D (the Kinetics classification top, "
                         "reference train.py:1196-1213): C3D keeps its fc8, TwoStream loads no-top trunks")
    if rgb_h5 is None:
        raise ValueError(f"{model_type} conversion needs the rgb checkpoint")
    if model_type == "TWOSTREAM_I3D" and flow_h5 is None:
        raise ValueError("TWOSTREAM_I3D conversion needs the rgb and the flow checkpoints")
    state = state_dict_from_keras(model_type, keras_layers(rgb_h5),
                                  None if flow_h5 is None else keras_layers(flow_h5),
                                  num_classes=num_classes, include_top=include_top)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, out_path)
    return out_path, state


def load_converted(path: str) -> Dict[str, torch.Tensor]:
    """A state-dict file written by `convert_keras_checkpoint`, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
