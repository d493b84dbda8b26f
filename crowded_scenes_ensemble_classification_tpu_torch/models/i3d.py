"""Inflated Inception-v1 (I3D) for Crowd-11, inference only.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/i3d.py`.
Module and attribute names follow the flax tree (`trunk.Mixed_3b.b0_1x1.conv`),
so `models/convert.py` maps a flax checkpoint key for key.

The 3³/1 pool branch of every Mixed_* block runs the hand-written kernel
`ops/kernels/maxpool.max_pool_3x3x3_same` (the JAX `pool_impl='pallas'`
route, i3d.py:158-170); there is no switch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.kernels.maxpool import max_pool_3x3x3_same
from .common import (
    ConvBN,
    PrestagedS2DStemConvBN,
    avg_pool_3d,
    flatten,
    lecun_normal_,
    max_pool_3d,
    to_ncdhw,
    to_nthwc,
)

# (b0_1x1, b1_1x1, b1_3x3, b2_1x1, b2_3x3, b3_pool_proj) per block
# (JAX models/i3d.py:48-58).
INCEPTION_SPECS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
# Blocks in order, with the TF-SAME max pool that precedes each group
# (JAX models/i3d.py:273-280).
_BLOCK_GROUPS = (
    (None, ("Mixed_3b", "Mixed_3c")),
    (((3, 3, 3), (2, 2, 2)), ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f")),
    (((2, 2, 2), (2, 2, 2)), ("Mixed_5b", "Mixed_5c")),
)
TRUNK_FEATURES = 1024
RGB_CHANNELS = 3


def block_out_features(spec: Tuple[int, ...]) -> int:
    b0, _, b1, _, b2, b3 = spec
    return b0 + b1 + b2 + b3


class InceptionBlock(nn.Module):
    """One Mixed_* block on NCDHW: 4 branches concatenated on channels
    (JAX models/i3d.py:61-172)."""

    def __init__(self, in_features: int, spec, generator: Optional[torch.Generator] = None):
        super().__init__()
        b0_c, b1_r, b1_c, b2_r, b2_c, b3_c = spec
        g = generator
        self.b0_1x1 = ConvBN(in_features, b0_c, (1, 1, 1), generator=g)
        self.b1_1x1 = ConvBN(in_features, b1_r, (1, 1, 1), generator=g)
        self.b1_3x3 = ConvBN(b1_r, b1_c, (3, 3, 3), generator=g)
        self.b2_1x1 = ConvBN(in_features, b2_r, (1, 1, 1), generator=g)
        self.b2_3x3 = ConvBN(b2_r, b2_c, (3, 3, 3), generator=g)
        self.b3_1x1 = ConvBN(in_features, b3_c, (1, 1, 1), generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branch_0 = self.b0_1x1(x)
        branch_1 = self.b1_3x3(self.b1_1x1(x))
        branch_2 = self.b2_3x3(self.b2_1x1(x))
        branch_3 = to_ncdhw(max_pool_3x3x3_same(to_nthwc(x)))
        branch_3 = self.b3_1x1(branch_3)
        return torch.cat([branch_0, branch_1, branch_2, branch_3], dim=1)


class I3DTrunk(nn.Module):
    """Stem + Mixed_3b..Mixed_5c on NCDHW (JAX models/i3d.py:175-281).

    stem_prestaged=True takes the `s2d_stem_stage` layout (NTHWC, 4C
    channels), computed once per batch and shared by ensemble members;
    otherwise the canonical 7³/2 ConvBN stem takes NTHWC clips.  Both stems
    hold the same `Conv3d_1a_7x7` state."""

    def __init__(self, stem_prestaged: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stem_prestaged = stem_prestaged
        if stem_prestaged:
            self.Conv3d_1a_7x7 = PrestagedS2DStemConvBN(RGB_CHANNELS, 64, generator=g)
        else:
            self.Conv3d_1a_7x7 = ConvBN(RGB_CHANNELS, 64, (7, 7, 7), (2, 2, 2), generator=g)
        self.Conv3d_2b_1x1 = ConvBN(64, 64, (1, 1, 1), generator=g)
        self.Conv3d_2c_3x3 = ConvBN(64, 192, (3, 3, 3), generator=g)
        features = 192
        for _, names in _BLOCK_GROUPS:
            for name in names:
                setattr(self, name, InceptionBlock(features, INCEPTION_SPECS[name], generator=g))
                features = block_out_features(INCEPTION_SPECS[name])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_prestaged:
            x = self.Conv3d_1a_7x7(x)
        else:
            x = self.Conv3d_1a_7x7(to_ncdhw(x))
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2b_1x1(x)
        x = self.Conv3d_2c_3x3(x)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        for pool, names in _BLOCK_GROUPS:
            if pool is not None:
                x = max_pool_3d(x, *pool)
            for name in names:
                x = getattr(self, name)(x)
        return x


def i3d_feature_head(x: torch.Tensor) -> torch.Tensor:
    """include_top=False head on NCDHW: AvgPool3D((2, h, w), stride 1,
    VALID) (JAX models/i3d.py:284-288), averaged in float32."""
    h, w = int(x.shape[3]), int(x.shape[4])
    return avg_pool_3d(x.float(), (2, h, w), (1, 1, 1))


def head_features(frames: int) -> int:
    """Dense input width for clips of `frames` frames: the trunk halves time
    three times with TF-SAME rounding (stem, two pools), the head averages
    pairs of the frames left and all of H×W."""
    t = math.ceil(math.ceil(math.ceil(frames / 2) / 2) / 2)
    return (t - 1) * TRUNK_FEATURES


class I3D(nn.Module):
    """Single-stream I3D classifier: trunk → feature head → Flatten in
    (T', H', W', C) order → Dense(num_classes) (JAX models/i3d.py:291-331).
    Takes NTHWC clips (or, with stem_prestaged, their s2d staging) and
    returns float32 logits."""

    def __init__(
        self,
        num_classes: int = 11,
        frames: int = 20,
        stem_prestaged: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.trunk = I3DTrunk(stem_prestaged, generator=generator)
        features = head_features(frames)
        self.predictions = nn.Linear(features, num_classes)
        lecun_normal_(self.predictions.weight, features, generator)
        nn.init.zeros_(self.predictions.bias)

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype: that of the conv weights (`cast_for_inference`)."""
        return self.trunk.Conv3d_1a_7x7.conv.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x.to(self.dtype))
        x = flatten(i3d_feature_head(x))
        return self.predictions(x.to(self.predictions.weight.dtype)).float()
