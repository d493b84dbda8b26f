"""Model factory: one place that maps a model_type string to a built model
with its canonical clip geometry.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/registry.py`
(`ModelBundle`, `build_model`, `predict_proba`, `summarize`, lines 24-122).
There a bundle is a stateless flax module and the variables travel apart;
here the module holds its weights, so a bundle is one member.
`build_model` puts the model on the card unless the caller names a device.

Two kinds of bundle.  An inference bundle (the default) holds conv and
dense weights in `dtype` (`cast_for_inference`) and is in eval mode.  A
trainable bundle (`trainable=True`) keeps every weight in float32, the
master weights the optimizer updates, and computes in `dtype` by a cast of
each weight in the forward (`compute_dtype`, which every family reads; the
convs' weights are held in channels_last_3d, so the cast copies come out
in it): the JAX package's `dtype=bfloat16, param_dtype=float32`.  Every
one of the eight types trains.

A quantized bundle (`quant=True` or 'dynamic', 'calib', 'static', with
`quant_blocks` for the I3D family) is an inference bundle whose quantized
convs keep f32 weights, as JAX quantizes them from f32, and which computes
in `dtype` (`compute_dtype`); its other weights are cast as usual.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..core.config import ClipSpec, clip_spec
from ..utils.device import resolve_device
from .c3d import C3D
from .common import cast_for_inference
from .i3d import I3D
from .r3d import R3D
from .two_stream_i3d import TwoStreamI3D


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
        """Zeros of the model's input shapes on the model's device: 'rgb',
        and 'flow' for a two-stream model."""
        zeros = lambda shape: torch.zeros((batch_size,) + shape, dtype=dtype, device=self.device)  # noqa: E731
        if self.two_stream:
            return {"rgb": zeros(self.clip.rgb_shape), "flow": zeros(self.clip.flow_shape)}
        return {"rgb": zeros(self.clip.rgb_shape)}

    def apply(self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C) float32 logits of `batch['rgb']` (and `batch['flow']` for a
        two-stream model), NTHWC clips, with the module in train mode
        (BatchNorm on batch statistics, updating its running ones) or eval
        mode.  Training needs a trainable bundle; C3D's dropout draws its
        masks from `generator` (on the module's device) in train mode."""
        if train and not self.trainable:
            raise ValueError("this bundle holds inference weights; build it with trainable=True to train")
        if self.module.training != train:
            self.module.train(train)
        if self.two_stream:
            return self.module(batch["rgb"], batch["flow"])
        if isinstance(self.module, C3D):
            return self.module(batch["rgb"], generator)
        return self.module(batch["rgb"])


def build_model(
    model_type: str,
    num_classes: int = 11,
    dtype: torch.dtype = torch.float32,
    device=None,
    generator: Optional[torch.Generator] = None,
    trainable: bool = False,
    quant=False,
    quant_blocks=None,
    **model_kwargs,
) -> ModelBundle:
    """A random-init model of any of the eight `MODEL_TYPES` (weights from
    `generator`) on `device`: the card when None, which raises without one.
    The weights are drawn on the generator's device (a CUDA generator draws
    them on the card) and then moved to `device`.  By default an inference
    bundle in eval mode, conv and dense weights in `dtype`
    (`cast_for_inference`); with `trainable`, f32 master weights computing
    in `dtype`, in train mode.  model_kwargs forward to the module
    (I3D's stem_impl, s2d_stem, stem_prestaged, fuse_1x1, remat and
    remat_blocks; TwoStream's stem_prestaged and fuse_1x1; C3D's width and
    dropout_rate; R3D's width), as JAX's `**model_kwargs` do.  `quant` quantizes the
    convs for inference (see the module docstring); `quant_blocks` limits
    it to the named I3D sites (`models.quantize.resolve_quant_blocks`)."""
    spec = clip_spec(model_type)
    if quant and trainable:
        raise ValueError("quant is inference-only: a trainable bundle cannot be quantized")
    if quant_blocks is not None:
        if model_type not in ("I3D", "TWOSTREAM_I3D"):
            raise ValueError(f"quant_blocks applies to the I3D family, not {model_type}")
        model_kwargs["quant_blocks"] = quant_blocks
    if quant:
        model_kwargs["quant"] = quant
    device = resolve_device(device)
    with torch.device(generator.device if generator is not None else device):
        if model_type == "I3D":
            module = I3D(num_classes, frames=spec.frames, generator=generator, **model_kwargs)
        elif model_type == "TWOSTREAM_I3D":
            module = TwoStreamI3D(num_classes, frames=spec.frames, generator=generator, **model_kwargs)
        elif model_type == "C3D":
            module = C3D(num_classes, clip_thw=(spec.frames, spec.height, spec.width), generator=generator,
                         **model_kwargs)
        else:
            module = R3D(num_classes, depth=int(model_type.split("_")[1]), generator=generator, **model_kwargs)
    module = module.to(device)
    two_stream = model_type == "TWOSTREAM_I3D"
    if not trainable:
        module = cast_for_inference(module, dtype).eval()
        if quant:
            module.compute_dtype = dtype
        return ModelBundle(model_type, module, spec, num_classes, two_stream=two_stream)
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last_3d)
    module.compute_dtype = dtype
    return ModelBundle(model_type, module.train(), spec, num_classes, two_stream=two_stream, trainable=True)


def predict_proba(bundle: ModelBundle, batch: Dict) -> torch.Tensor:
    """Softmax probabilities, what the reference models emitted directly."""
    with torch.inference_mode():
        return torch.softmax(bundle.apply(batch), dim=-1)


def summarize(bundle: ModelBundle) -> str:
    """Parameter summary, the reference's model.summary() (JAX
    registry.py:100-122; reference train.py:806,1893,1945): one line per
    parameter in sorted order of its name, the total, and the BatchNorm
    statistics.  The fixed BN weight of I3D-family models (no parameter of
    the reference) is left out, so totals equal the flax tree's."""
    lines = [f"{bundle.model_type}: input {bundle.clip.rgb_shape}"]
    total = 0
    for name, p in sorted(bundle.module.named_parameters()):
        if not p.requires_grad and name.endswith("bn.weight"):
            continue
        total += p.numel()
        lines.append(f"  {name:<60} {tuple(p.shape)!s:<20} {p.numel():>12,}")
    lines.append(f"total params: {total:,}")
    stats = sum(b.numel() for n, b in bundle.module.named_buffers() if n.endswith(("running_mean", "running_var")))
    if stats:
        lines.append(f"batch_stats:  {stats:,}")
    return "\n".join(lines)
