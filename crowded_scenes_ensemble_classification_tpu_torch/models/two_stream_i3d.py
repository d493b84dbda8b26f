"""TwoStream-I3D: an RGB trunk and an optical-flow trunk, one Dense head.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/two_stream_i3d.py`
(reference `TwoStream_Inception_Inflated3d`, train.py:857-1011): two
independent I3D trunks, RGB with 3 input channels and flow with 2, each
through the feature head and flattened, concatenated [rgb, flow], then
one Dense.  Both trunks run the 3³/1 max-pool kernel in their 9 Mixed
blocks, and its gradient kernel in training; they train on the canonical
stem, as the JAX trunk drops its Pallas stem in training (i3d.py:256).
Flow is an input: precomputed (`batch['flow']`, the reference's
TVL1_precomputed mode) or computed on the card by `flow.farneback` from
gray pairs (`ensemble/members.prepare_member_inputs`, and the train steps'
`train/engine._preprocess`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import flatten, lecun_normal_
from .i3d import I3DTrunk, head_features, i3d_feature_head

FLOW_CHANNELS = 2


class TwoStreamI3D(nn.Module):
    """Takes NTHWC rgb (N, T, H, W, 3) and flow (N, T, H, W, 2), or with
    stem_prestaged both in the `s2d_stem_stage` layout, computed once per
    batch and shared by ensemble members (JAX two_stream_i3d.py:29-65).
    Returns float32 logits.  `compute_dtype`, when set, is the dtype the
    model computes in while its weights stay in theirs (as `I3D`).
    `quant` and `quant_blocks` quantize both trunks alike (JAX
    two_stream_i3d.py:37-53)."""

    def __init__(
        self,
        num_classes: int = 11,
        frames: int = 20,
        stem_prestaged: bool = False,
        generator: Optional[torch.Generator] = None,
        quant: Union[bool, str] = False,
        quant_blocks=None,
    ):
        super().__init__()
        self.stem_prestaged = stem_prestaged
        q = dict(quant=quant, quant_blocks=quant_blocks)
        self.rgb_trunk = I3DTrunk(stem_prestaged, generator=generator, **q)
        self.flow_trunk = I3DTrunk(stem_prestaged, generator=generator, channels=FLOW_CHANNELS, **q)
        features = 2 * head_features(frames)
        self.predictions = nn.Linear(features, num_classes)
        lecun_normal_(self.predictions.weight, features, generator)
        nn.init.zeros_(self.predictions.bias)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype: `compute_dtype`, else that of the conv weights."""
        return self.compute_dtype or self.rgb_trunk.Conv3d_1a_7x7.conv.weight.dtype

    def forward(self, rgb: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        feats = torch.cat(
            [flatten(i3d_feature_head(self.rgb_trunk(rgb.to(dt)))),
             flatten(i3d_feature_head(self.flow_trunk(flow.to(dt))))],
            dim=-1,
        ).to(dt)
        return F.linear(feats, self.predictions.weight.to(dt), self.predictions.bias.to(dt)).float()
