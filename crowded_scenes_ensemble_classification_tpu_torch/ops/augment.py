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

`crowd11_augment` is the single-clip form (JAX augment.py:42-93) that
offline augmentation calls: the batch form with B=1, so its salt/pepper
tail is the noise kernel on the card as on every other augmenting path.

`crowd11_augment_gray_pair_batch` (JAX augment.py:132-200) applies the rgb
stream's decisions to the Farnebäck gray pairs of the augmented-Farnebäck
mode, whose salt and pepper are per-pixel `torch.where`s as there.

The windowed form (JAX augment.py:219-391) is the policy on windows the
host sliced: `augment_crop_decisions` is the host's view of the crop part of
one step's decisions (drawn by `step_generator(seed, step)`, as every train
step draws its own), `pack_windows_host` writes each clip's crop window, or
its decode-time eval resize (`decode_time_eval_resize_u8`), into an
out_hw buffer, and `crowd11_augment_windowed_from_decisions` resamples the
window from the origin with the decisions' flip, then runs the noise
kernel with their gates and seed.  It feeds the wire (`data.wire_format`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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

    def _map(self, fn) -> "AugmentDecisions":
        return dataclasses.replace(
            self, do_crop=fn(self.do_crop), y0=fn(self.y0), x0=fn(self.x0),
            flip=fn(self.flip), salt=fn(self.salt), pepper=fn(self.pepper),
        )

    def to(self, device) -> "AugmentDecisions":
        return self._map(lambda t: t.to(device, non_blocking=True))

    def rows(self, start: int, stop: int) -> "AugmentDecisions":
        """The decisions of clips [start, stop), the same noise seed: a
        data-parallel position's share of the global batch's draws, which
        it applies with `clip_offset=start`."""
        return self._map(lambda t: t[start:stop])


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's augment decisions, seeded by
    (seed, step): a train step's draws, and a wire plan's."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))


def draw_decisions(
    generator: torch.Generator,
    batch_size: int,
    staging_hw: Tuple[int, int],
    p: float = 0.75,
    crop_margin: int = CROP_MARGIN,
) -> AugmentDecisions:
    """Draw the policy's decisions on the generator's device (a CPU
    generator keeps the draws off the card): crop gate, y0, x0, flip, salt
    gate, pepper gate, then the noise seed."""
    h, w = staging_hw
    ch, cw = max(h - crop_margin, 1), max(w - crop_margin, 1)
    dev = generator.device
    gate = lambda: torch.rand(batch_size, generator=generator, device=dev) < p  # noqa: E731
    do_crop = gate()
    y0 = torch.randint(0, h - ch + 1, (batch_size,), generator=generator, device=dev)
    x0 = torch.randint(0, w - cw + 1, (batch_size,), generator=generator, device=dev)
    flip, salt, pepper = gate(), gate(), gate()
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=dev))
    return AugmentDecisions(do_crop, y0, x0, flip, salt, pepper, seed)


def crop_flip_resize(clips: torch.Tensor, out_hw: Tuple[int, int], d: AugmentDecisions) -> torch.Tensor:
    """The per-clip crop window (or the whole frame) and flip of `d`,
    resampled to out_hw (JAX augment.py:57-82)."""
    _, _, h, w, _ = clips.shape
    ch, cw = max(h - CROP_MARGIN, 1), max(w - CROP_MARGIN, 1)
    win_y0 = torch.where(d.do_crop, d.y0, 0).float()
    win_x0 = torch.where(d.do_crop, d.x0, 0).float()
    ones = torch.ones_like(win_y0)
    win_h = torch.where(d.do_crop, ones * ch, ones * h)
    win_w = torch.where(d.do_crop, ones * cw, ones * w)
    return crop_resize(clips, out_hw, (win_y0, win_x0), (win_h, win_w), d.flip)


def crowd11_augment_from_decisions(
    clips: torch.Tensor,
    out_hw: Tuple[int, int],
    decisions: AugmentDecisions,
    clip_offset: int = 0,
) -> torch.Tensor:
    """Apply the policy to (B, T, H, W, C) clips → float32 (B, T, oh, ow, C),
    per-clip window and flip as in JAX crowd11_augment (augment.py:57-82),
    then the salt/pepper kernel with the decisions' gates and seed, the clips
    being rows [clip_offset, clip_offset + B) of the batch the decisions'
    noise was drawn for (`AugmentDecisions.rows`)."""
    d = decisions.to(clips.device)
    out = crop_flip_resize(clips, out_hw, d)
    return salt_pepper(out, d.seed, d.salt, d.pepper, NOISE_RATIO, clip_offset)


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


def crowd11_augment(
    clip: torch.Tensor,
    out_hw: Tuple[int, int],
    p: float,
    generator: torch.Generator,
) -> torch.Tensor:
    """Augment one (T, H, W, C) clip → float32 (T, oh, ow, C):
    `crowd11_augment_batch` of the clip as a batch of one, its decisions
    drawn from `generator`."""
    return crowd11_augment_batch(clip[None], out_hw, p, generator)[0]


def identity_resize_batch(clips: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """The non-augmented path: plain per-clip resize (JAX augment.py:125-127)."""
    return crop_resize(clips, out_hw)


def gray_pair_noise_hits(decisions: AugmentDecisions, shape, device) -> torch.Tensor:
    """The per-pixel salt and pepper hits of the gray pairs: (4, *shape)
    bool, salt and pepper of `gray`, then of `gray_next`, each pixel hit
    with probability 1/NOISE_RATIO, drawn on `device` from a generator
    seeded by the decisions' noise seed (a stream apart from the rgb
    noise's Philox key; JAX folds its salt and pepper keys with 0 and 1)."""
    key = int(np.random.SeedSequence([decisions.seed, 1]).generate_state(1, np.uint64)[0])
    generator = torch.Generator(device=device).manual_seed(key)
    return torch.randint(0, NOISE_RATIO, (4,) + tuple(shape), generator=generator, device=device) == 0


def crowd11_augment_gray_pair_from_decisions(
    gray: torch.Tensor,
    gray_next: torch.Tensor,
    decisions: AugmentDecisions,
    hits: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the rgb stream's `decisions` to (B, T, H, W, 1) gray pairs staged
    at the rgb staging resolution (JAX augment.py:132-200): the same crop
    window and flip, resampled back to (H, W), not to the model size; then,
    with `hits` ((4, B, T, H, W, 1) bool from `gray_pair_noise_hits`, or
    None for no noise), salt (255) and pepper (0) where the decisions' salt
    and pepper gates and the pixel's hit agree, per frame of the pair."""
    _, _, h, w, _ = gray.shape
    d = decisions.to(gray.device)
    out = [crop_flip_resize(g, (h, w), d) for g in (gray, gray_next)]
    if hits is None:
        return out[0], out[1]
    gate = lambda g: g.view(-1, 1, 1, 1, 1)  # noqa: E731
    for i in range(2):
        out[i] = torch.where(gate(d.salt) & hits[2 * i], 255.0, out[i])
        out[i] = torch.where(gate(d.pepper) & hits[2 * i + 1], 0.0, out[i])
    return out[0], out[1]


def crowd11_augment_gray_pair_batch(
    gray: torch.Tensor,
    gray_next: torch.Tensor,
    decisions: AugmentDecisions,
    clip_offset: int = 0,
    global_batch: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmented-Farnebäck mode's gray pairs: the rgb stream's
    `decisions` (so both streams see one crop window and one flip, as the
    reference's single augmented frame list fed both, train.py:176-184) and
    salt/pepper hits drawn by `gray_pair_noise_hits` on the pairs' device.
    A data-parallel position passes its rows' decisions, its first row
    `clip_offset` and the `global_batch` size: it draws the global batch's
    hits and keeps its rows', which the unsharded call draws for them."""
    total = gray.shape[0] if global_batch is None else global_batch
    hits = gray_pair_noise_hits(decisions, (total, *gray.shape[1:]), gray.device)
    hits = hits[:, clip_offset:clip_offset + gray.shape[0]]
    return crowd11_augment_gray_pair_from_decisions(gray, gray_next, decisions, hits)


# ----------------------------------------------------------------------
# Window transfers (JAX augment.py:203-391): the host slices the crop
# window the decisions name, the device does the arithmetic.
# ----------------------------------------------------------------------


def augment_crop_decisions(
    seed: int,
    batch_size: int,
    staging_hw: Tuple[int, int],
    p: float = 0.75,
    crop_margin: int = CROP_MARGIN,
    fold_step: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host's numpy (do_crop (B,) bool, y0 (B,) int32, x0 (B,) int32):
    the crop part of the decisions `draw_decisions` draws for step
    `fold_step` (0 when None) from `step_generator(seed, step)` (JAX
    augment.py:219-253, whose key becomes the seed)."""
    d = draw_decisions(step_generator(seed, fold_step or 0), batch_size, staging_hw, p, crop_margin)
    return d.do_crop.numpy(), d.y0.numpy().astype(np.int32), d.x0.numpy().astype(np.int32)


def crowd11_augment_windowed_from_decisions(
    windows: torch.Tensor,
    out_hw: Tuple[int, int],
    staging_hw: Tuple[int, int],
    decisions: AugmentDecisions,
    crop_margin: int = CROP_MARGIN,
    clip_offset: int = 0,
) -> torch.Tensor:
    """The policy on pre-sliced windows (JAX augment.py:276-317):
    (B, T, oh, ow, C) buffers whose top-left corner holds a cropped clip's
    (H−margin)×(W−margin) window, or an uncropped clip's full frame already
    resized to out_hw, → float32 (B, T, oh, ow, C).  Each clip is resampled
    from the origin over its window (the identity for an uncropped one) with
    the decisions' flip, then the salt/pepper kernel with their gates and
    seed at `clip_offset` (`crowd11_augment_from_decisions`).  For cropped
    clips the taps equal the unwindowed path's within an ulp of their
    weights (JAX's own ≤ 2e-3 on the 0-255 scale)."""
    d = decisions.to(windows.device)
    _, _, bh, bw, _ = windows.shape
    h, w = staging_hw
    ch, cw = max(h - crop_margin, 1), max(w - crop_margin, 1)
    ones = torch.ones(d.do_crop.shape, dtype=torch.float32, device=windows.device)
    win_h = torch.where(d.do_crop, ones * ch, ones * bh)
    win_w = torch.where(d.do_crop, ones * cw, ones * bw)
    out = crop_resize(windows, out_hw, (ones * 0.0, ones * 0.0), (win_h, win_w), d.flip)
    return salt_pepper(out, d.seed, d.salt, d.pepper, NOISE_RATIO, clip_offset)


def crowd11_augment_windowed_batch(
    windows: torch.Tensor,
    out_hw: Tuple[int, int],
    staging_hw: Tuple[int, int],
    p: float,
    generator: torch.Generator,
    crop_margin: int = CROP_MARGIN,
) -> torch.Tensor:
    """Draw per-clip decisions for staging_hw clips from `generator` and
    apply the windowed policy (JAX augment.py:320-336)."""
    decisions = draw_decisions(generator, windows.shape[0], staging_hw, p, crop_margin)
    return crowd11_augment_windowed_from_decisions(windows, out_hw, staging_hw, decisions, crop_margin)


def decode_time_eval_resize_u8(clip_u8, out_hw: Tuple[int, int]) -> np.ndarray:
    """A u8 (T, H, W, C) clip resized to u8 out_hw frames on the host, once
    at decode or cache-build time (JAX augment.py:339-352; the reference's
    cv2.resize on uint8 frames): the bilinear resize in f32, rounded half
    to even and clipped to 0-255."""
    x = torch.as_tensor(np.asarray(clip_u8))[None].float()
    out = crop_resize(x, out_hw)[0].numpy()
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def pack_windows_host(
    staging: np.ndarray,
    eval_resized: np.ndarray,
    do_crop: np.ndarray,
    y0: np.ndarray,
    x0: np.ndarray,
    out_hw: Tuple[int, int],
    crop_margin: int = CROP_MARGIN,
) -> np.ndarray:
    """The (B, T, oh, ow, C) u8 buffer of windows, assembled on the host by
    indexing alone (JAX augment.py:355-391): a cropped clip's staging crop
    window in the top-left corner, zeros around it; an uncropped clip's
    decode-time resize."""
    b, t, h, w, c = staging.shape
    ch, cw = max(h - crop_margin, 1), max(w - crop_margin, 1)
    buf = np.zeros((b, t) + tuple(out_hw) + (c,), np.uint8)
    for i in range(b):
        if do_crop[i]:
            buf[i, :, :ch, :cw] = staging[i, :, y0[i]:y0[i] + ch, x0[i]:x0[i] + cw]
        else:
            buf[i] = eval_resized[i]
    return buf
