"""Model factory: one place that maps a model_type string to a built model
with its canonical clip geometry.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/registry.py`
(`ModelBundle`, `build_model`, `predict_proba`, lines 24-97).  There a
bundle is a stateless flax module and the variables travel apart; here the
module holds its weights, so a bundle is one member.  Only I3D is ported;
the other families raise `NotImplementedError` (ROADMAP Queue 1 item 4).
`build_model` puts the model on the card unless the caller names a device.

Two kinds of bundle.  An inference bundle (the default) holds conv and
dense weights in `dtype` (`cast_for_inference`) and is in eval mode.  A
trainable bundle (`trainable=True`) keeps every weight in float32, the
master weights the optimizer updates, and computes in `dtype` by a cast of
each weight in the forward (`I3D.compute_dtype`; the convs' weights are
held in channels_last_3d, so the cast copies come out in it): the JAX
package's `dtype=bfloat16, param_dtype=float32`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..core.config import ClipSpec, clip_spec
from ..utils.device import resolve_device
from .common import cast_for_inference
from .i3d import I3D


@dataclasses.dataclass
class ModelBundle:
    """A built model with its clip geometry; `trainable` when it holds f32
    master weights (see the module docstring)."""

    model_type: str
    module: nn.Module
    clip: ClipSpec
    num_classes: int
    two_stream: bool
    trainable: bool = False

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def dummy_batch(self, batch_size: int = 1, dtype: torch.dtype = torch.float32) -> Dict:
        """Zeros of the model's input shape on the model's device."""
        return {"rgb": torch.zeros((batch_size,) + self.clip.rgb_shape, dtype=dtype, device=self.device)}

    def apply(self, batch: Dict, train: bool = False) -> torch.Tensor:
        """(B, C) float32 logits of `batch['rgb']`, NTHWC clips, with the
        module in train mode (BatchNorm on batch statistics, updating its
        running ones) or eval mode.  Training needs a trainable bundle."""
        if train and not self.trainable:
            raise ValueError("this bundle holds inference weights; build it with trainable=True to train")
        if self.module.training != train:
            self.module.train(train)
        return self.module(batch["rgb"])


def build_model(
    model_type: str,
    num_classes: int = 11,
    dtype: torch.dtype = torch.float32,
    device=None,
    generator: Optional[torch.Generator] = None,
    trainable: bool = False,
    **model_kwargs,
) -> ModelBundle:
    """A random-init model (weights from `generator`) on `device`: the card
    when None, which raises without one.  By default an inference bundle in
    eval mode, conv and dense weights in `dtype` (`cast_for_inference`);
    with `trainable`, f32 master weights computing in `dtype`, in train
    mode.  model_kwargs forward to the module (I3D's stem_impl, s2d_stem,
    stem_prestaged)."""
    spec = clip_spec(model_type)  # only I3D resolves
    device = resolve_device(device)
    module = I3D(num_classes, frames=spec.frames, generator=generator, **model_kwargs).to(device)
    if not trainable:
        module = cast_for_inference(module, dtype).eval()
        return ModelBundle(model_type, module, spec, num_classes, two_stream=False)
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last_3d)
    module.compute_dtype = dtype
    return ModelBundle(model_type, module.train(), spec, num_classes, two_stream=False, trainable=True)


def predict_proba(bundle: ModelBundle, batch: Dict) -> torch.Tensor:
    """Softmax probabilities, what the reference models emitted directly."""
    with torch.inference_mode():
        return torch.softmax(bundle.apply(batch), dim=-1)
