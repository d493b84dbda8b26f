"""Pretrained checkpoints onto a model: the reference's `train_load_model`
factory semantics (train.py:1619-1772) for the port's modules.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/pretrained.py`
(`load_pretrained_variables`, lines 28-112).  Per family:

- C3D: a sports1M checkpoint; a head of another width than the model's is
  dropped and the fresh one kept (the pop-softmax surgery,
  train.py:1672-1678);
- I3D: a Kinetics/ImageNet checkpoint into the trunk, and its
  'predictions' Dense when it has the model's width (train.py:1633-1652);
  an `I3DKinetics` module takes a with-top checkpoint whole;
- TWOSTREAM_I3D: one checkpoint per stream into the two trunks, the fusion
  Dense fresh (train.py:989-1009), or one converted file holding both;
- R3D_*: the reference trains from scratch (train.py:1683-1707), so no
  checkpoint is a no-op; a Keras-layout one loads like the others.

A checkpoint is a Keras h5 path, its layer dict (`weights_io.
read_keras_h5`'s form, which needs no h5py), or a converted state-dict file
(`weights_registry.convert_keras_checkpoint`, a path ending in `.pt`).
`build_with_condition` (JAX pretrained.py:115-134) builds an experiment's
seeded model and applies its training condition.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.config import ExperimentConfig
from ..utils.device import resolve_device
from .i3d import I3DKinetics
from .registry import ModelBundle, build_model
from .weights_io import state_dict_from_keras
from .weights_registry import Source, keras_layers, load_converted

CONVERTED_SUFFIX = ".pt"


def _is_converted(source: Optional[Source]) -> bool:
    return isinstance(source, str) and source.endswith(CONVERTED_SUFFIX)


def _checkpoint_state(
    model_type: str,
    module: nn.Module,
    num_classes: int,
    rgb_h5: Optional[Source] = None,
    flow_h5: Optional[Source] = None,
) -> Dict[str, torch.Tensor]:
    """What the checkpoint gives `module` (of `model_type`, `num_classes`
    outputs): a state dict of the keys it overwrites; empty where the
    family loads none (R3D without a checkpoint).  Mixed inputs are refused:
    a converted TwoStream file is the single combined file."""
    if _is_converted(flow_h5):
        raise ValueError("flow_h5 must be a Keras checkpoint, not a converted file: converted TwoStream "
                         "weights are a single combined file (both trunks); pass it as rgb_h5 and omit flow_h5")
    if _is_converted(rgb_h5):
        state = load_converted(rgb_h5)
        if model_type == "TWOSTREAM_I3D":
            if flow_h5 is not None:
                raise ValueError("a converted TWOSTREAM_I3D file is the single combined file: flow_h5 must "
                                 "not also be given (it would be ignored)")
            if not any(k.startswith("flow_trunk.") for k in state):
                raise ValueError(f"{rgb_h5} has no flow_trunk: the flow stream would keep its fresh weights. "
                                 "Convert the combined checkpoint (convert_keras_checkpoint('TWOSTREAM_I3D', "
                                 "..., rgb_h5=..., flow_h5=...))")
    elif rgb_h5 is None and model_type.startswith("R3D_"):
        return {}
    else:
        if rgb_h5 is None or (model_type == "TWOSTREAM_I3D" and flow_h5 is None):
            raise ValueError(f"{model_type} pretrained needs "
                             f"{'the rgb and flow checkpoints' if model_type == 'TWOSTREAM_I3D' else 'a checkpoint'}")
        state = state_dict_from_keras(model_type, keras_layers(rgb_h5),
                                      None if flow_h5 is None else keras_layers(flow_h5),
                                      num_classes=num_classes, include_top=isinstance(module, I3DKinetics))
    if model_type == "C3D" and "fc8.weight" in state and state["fc8.weight"].shape[0] != num_classes:
        state = {k: v for k, v in state.items() if not k.startswith("fc8.")}
    return state


def load_pretrained(
    model_type: str,
    module: nn.Module,
    num_classes: int,
    rgb_h5: Optional[Source] = None,
    flow_h5: Optional[Source] = None,
) -> nn.Module:
    """Overlay a checkpoint onto `module`'s own (fresh) state dict and load
    the result strictly (JAX pretrained.py:28-112): a key the checkpoint
    lacks keeps its fresh value, a key both hold with two shapes raises,
    and a key the module lacks raises.  Values take the module's dtypes.
    Returns `module`."""
    fresh = module.state_dict()
    state = _checkpoint_state(model_type, module, num_classes, rgb_h5, flow_h5)
    for k, v in state.items():
        if k in fresh and tuple(fresh[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(fresh[k].shape)} vs {tuple(v.shape)}")
    module.load_state_dict({**fresh, **state}, strict=True)
    return module


def build_with_condition(
    config: ExperimentConfig,
    seed: int = 0,
    rgb_h5: Optional[Source] = None,
    flow_h5: Optional[Source] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    trainable: bool = True,
) -> Tuple[ModelBundle, Dict[str, torch.Tensor]]:
    """(bundle, its state dict) honouring `config.training_condition`, the
    train_load_model dispatch (train.py:1619-1710): the model's weights drawn
    on `device` (the card when None) from a generator seeded by `seed`
    (_SCRATCH), then the checkpoints overlaid by `load_pretrained`
    (_PRETRAINED).  A trainable bundle computing in `dtype` by default."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    bundle = build_model(config.model_type, config.num_classes, dtype=dtype, device=device, generator=generator,
                         trainable=trainable)
    if config.training_condition == "_PRETRAINED":
        load_pretrained(config.model_type, bundle.module, config.num_classes, rgb_h5, flow_h5)
    return bundle, bundle.module.state_dict()
