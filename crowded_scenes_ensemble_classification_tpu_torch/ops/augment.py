"""The Crowd-11 augmentation policy, batched on the device.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/augment.py`
(lines 42-127): Sometimes(p, RandomCrop(H−60, W−60)), Sometimes(p,
HorizontalFlip), resize to the model size — crop and flip folded into one
bilinear `crop_resize` — then Sometimes(p, Salt), Sometimes(p, Pepper) by the
hand-written kernel `ops/kernels/noise.salt_pepper` (the JAX
`noise_impl='pallas'` route).

JAX draws its decisions from threefry keys, which torch cannot replay, so
the decisions are a value of their own: `draw_decisions` takes them from a
`torch.Generator`, and `crowd11_augment_from_decisions` applies given ones,
which is what the parity tests feed with the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .kernels.noise import salt_pepper
from .resize import crop_resize

CROP_MARGIN = 60  # JAX ops/augment.py:38 (reference augment_dataset.py:25-27)
NOISE_RATIO = 100  # JAX ops/augment.py:39 (reference augment_dataset.py:29-31)


@dataclasses.dataclass(frozen=True)
class AugmentDecisions:
    """Per-clip draws of the policy: (B,) tensors and one noise seed."""

    do_crop: torch.Tensor  # bool
    y0: torch.Tensor  # int, crop window origin
    x0: torch.Tensor  # int
    flip: torch.Tensor  # bool
    salt: torch.Tensor  # bool
    pepper: torch.Tensor  # bool
    seed: int  # 64-bit Philox key of the noise kernel

    def to(self, device) -> "AugmentDecisions":
        move = lambda t: t.to(device, non_blocking=True)  # noqa: E731
        return dataclasses.replace(
            self, do_crop=move(self.do_crop), y0=move(self.y0), x0=move(self.x0),
            flip=move(self.flip), salt=move(self.salt), pepper=move(self.pepper),
        )


def draw_decisions(
    generator: torch.Generator,
    batch_size: int,
    staging_hw: Tuple[int, int],
    p: float = 0.75,
) -> AugmentDecisions:
    """Draw the policy's decisions on the generator's device (a CPU
    generator keeps the draws off the card): crop gate, y0, x0, flip, salt
    gate, pepper gate, then the noise seed."""
    h, w = staging_hw
    ch, cw = max(h - CROP_MARGIN, 1), max(w - CROP_MARGIN, 1)
    dev = generator.device
    gate = lambda: torch.rand(batch_size, generator=generator, device=dev) < p  # noqa: E731
    do_crop = gate()
    y0 = torch.randint(0, h - ch + 1, (batch_size,), generator=generator, device=dev)
    x0 = torch.randint(0, w - cw + 1, (batch_size,), generator=generator, device=dev)
    flip, salt, pepper = gate(), gate(), gate()
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=dev))
    return AugmentDecisions(do_crop, y0, x0, flip, salt, pepper, seed)


def crowd11_augment_from_decisions(
    clips: torch.Tensor,
    out_hw: Tuple[int, int],
    decisions: AugmentDecisions,
) -> torch.Tensor:
    """Apply the policy to (B, T, H, W, C) clips → float32 (B, T, oh, ow, C),
    per-clip window and flip as in JAX crowd11_augment (augment.py:57-82),
    then the salt/pepper kernel with the decisions' gates and seed."""
    _, _, h, w, _ = clips.shape
    ch, cw = max(h - CROP_MARGIN, 1), max(w - CROP_MARGIN, 1)
    d = decisions.to(clips.device)
    win_y0 = torch.where(d.do_crop, d.y0, 0).float()
    win_x0 = torch.where(d.do_crop, d.x0, 0).float()
    ones = torch.ones_like(win_y0)
    win_h = torch.where(d.do_crop, ones * ch, ones * h)
    win_w = torch.where(d.do_crop, ones * cw, ones * w)
    out = crop_resize(clips, out_hw, (win_y0, win_x0), (win_h, win_w), d.flip)
    return salt_pepper(out, d.seed, d.salt, d.pepper, NOISE_RATIO)


def crowd11_augment_batch(
    clips: torch.Tensor,
    out_hw: Tuple[int, int],
    p: float,
    generator: torch.Generator,
) -> torch.Tensor:
    """Draw per-clip decisions from `generator` and apply the policy."""
    b, _, h, w, _ = clips.shape
    decisions = draw_decisions(generator, b, (h, w), p)
    return crowd11_augment_from_decisions(clips, out_hw, decisions)


def identity_resize_batch(clips: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """The non-augmented path: plain per-clip resize (JAX augment.py:125-127)."""
    return crop_resize(clips, out_hw)
