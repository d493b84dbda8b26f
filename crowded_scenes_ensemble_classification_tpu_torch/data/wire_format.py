"""The ragged window wire: each clip ships the bytes its augment decision needs.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/wire_format.py`
(lines 51-470).  It is the ingest path of a dataset that does not stay
resident on the card: a clip whose decision crops ships only its
(H−margin)×(W−margin) staging window (the host slices it), an uncropped
clip its decode-time u8 eval resize (`ops.augment.decode_time_eval_resize_u8`),
all concatenated into one buffer of `cap` bytes, the exact maximum over the
planned steps.  colorspace="yuv420" ships cv2's I420 (1.5 bytes a pixel
instead of 3), crop windows from an even-aligned superwindow, and the card
decodes it (`i420_to_bgr_u8`, within ±1 DN of cv2).

The plan's arithmetic (`cap`, `crop_hw`, `crop_ship_hw`, `crop_bytes`,
`full_bytes`, the offsets) is JAX's, so a plan of the same decisions packs
the same bytes.  The decisions are the port's values (`ops.augment.
AugmentDecisions`): `plan_wire_steps` draws step s's from
`step_generator(seed, s)`, as a train step draws its own, and they travel
with the wire, so the card derives nothing: `make_wire_unpack` slices each
clip from the wire by the plan's host offsets and gates (one stack of the
clips of each kind, the I420 decode of each kind at once, one copy into the
padded (B, T, oh, ow, 3) buffer), which `ops.augment.
crowd11_augment_windowed_from_decisions` takes.  The host packs into pinned
memory (`pinned_wire`) and the steps copy it with `non_blocking=True`.

Sharded (`ShardedWirePlan`): one wire row per position of a `core.mesh`
data axis, each position unpacking its own row on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.augment import CROP_MARGIN, AugmentDecisions, draw_decisions, step_generator


def _ship_dim(c: int, limit: int) -> int:
    """Smallest even superwindow length covering an even-aligned origin
    shift of a c-px window, clamped to the even staging extent (JAX
    wire_format.py:51-54)."""
    return min(c + 2 + (c % 2), limit - (limit % 2))


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """Every planned step's crop decisions and offsets, `steps[s] = (do_crop,
    y0, x0, offsets)` numpy as JAX's, the step's whole `decisions`, and the
    static capacity `cap` (JAX wire_format.py:57-108)."""

    batch_size: int
    frames: int
    staging_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    p: float
    crop_margin: int
    cap: int
    steps: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    colorspace: str = "rgb"
    decisions: Dict[int, AugmentDecisions] = dataclasses.field(default_factory=dict)
    seed: Optional[int] = None  # what `plan_wire_steps` drew the decisions from

    @property
    def crop_hw(self) -> Tuple[int, int]:
        return max(self.staging_hw[0] - self.crop_margin, 1), max(self.staging_hw[1] - self.crop_margin, 1)

    @property
    def crop_ship_hw(self) -> Tuple[int, int]:
        """The window shipped: the crop window (rgb), or the even-aligned
        superwindow that holds it (yuv420)."""
        ch, cw = self.crop_hw
        if self.colorspace == "rgb":
            return ch, cw
        return _ship_dim(ch, self.staging_hw[0]), _ship_dim(cw, self.staging_hw[1])

    @property
    def crop_bytes(self) -> int:
        sh, sw = self.crop_ship_hw
        return self.frames * sh * sw * 3 // (1 if self.colorspace == "rgb" else 2)

    @property
    def full_bytes(self) -> int:
        px = self.frames * self.out_hw[0] * self.out_hw[1]
        return px * 3 if self.colorspace == "rgb" else px * 3 // 2


def plan_wire_from_decisions(
    decisions: Dict[int, AugmentDecisions],
    batch_size: int,
    frames: int,
    staging_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    p: float = 0.75,
    crop_margin: int = CROP_MARGIN,
    colorspace: str = "rgb",
) -> WirePlan:
    """The plan of given per-step decisions (JAX wire_format.py:111-178
    with its decisions given): each step's offsets, and `cap` the largest
    step's bytes, at least one full and one crop slice."""
    if colorspace not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire colorspace {colorspace!r}")
    ch, cw = max(staging_hw[0] - crop_margin, 1), max(staging_hw[1] - crop_margin, 1)
    if ch > out_hw[0] or cw > out_hw[1]:
        raise ValueError(f"crop window {(ch, cw)} (staging−margin) exceeds out_hw {tuple(out_hw)} — the wire ships "
                         "crop windows inside an out_hw buffer; lower staging_hw or raise crop_margin")
    if colorspace == "yuv420" and any(d % 2 for d in (*staging_hw, *out_hw)):
        raise ValueError(f"yuv420 wire requires even staging/output dims, got staging={staging_hw} out={out_hw}")
    plan = WirePlan(batch_size, frames, tuple(staging_hw), tuple(out_hw), p, crop_margin, 0, {}, colorspace)
    cap, steps = max(plan.full_bytes, plan.crop_bytes), {}
    for s, d in decisions.items():
        do_crop = d.do_crop.cpu().numpy().astype(bool)
        sizes = np.where(do_crop, plan.crop_bytes, plan.full_bytes).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        steps[s] = (do_crop, d.y0.cpu().numpy().astype(np.int32), d.x0.cpu().numpy().astype(np.int32), offsets)
        cap = max(cap, int(sizes.sum()))
    return dataclasses.replace(plan, cap=cap, steps=steps, decisions=dict(decisions))


def plan_wire_steps(
    seed: int,
    num_steps: int,
    batch_size: int,
    frames: int,
    staging_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    p: float = 0.75,
    crop_margin: int = CROP_MARGIN,
    colorspace: str = "rgb",
) -> WirePlan:
    """The plan of steps 0..num_steps−1, step s's decisions drawn on the host
    from `step_generator(seed, s)` (JAX wire_format.py:111-178, whose key is
    the seed here): the draws of a train step at step s of a state seeded
    with `seed`."""
    decisions = {s: draw_decisions(step_generator(seed, s), batch_size, staging_hw, p, crop_margin)
                 for s in range(num_steps)}
    plan = plan_wire_from_decisions(decisions, batch_size, frames, staging_hw, out_hw, p, crop_margin, colorspace)
    return dataclasses.replace(plan, seed=seed)


@dataclasses.dataclass(frozen=True)
class ShardedWirePlan:
    """A global plan split over `n_shards` data positions (JAX
    wire_format.py:181-210): shard d owns clips [d·B/n, (d+1)·B/n) of every
    step and a wire row of its own, `cap` the max over shards and steps;
    `steps[s]` the (n_shards, B/n) per-shard offsets."""

    base: WirePlan
    n_shards: int
    cap: int
    steps: Dict[int, np.ndarray]

    @property
    def shard_batch(self) -> int:
        return self.base.batch_size // self.n_shards

    def shard_view(self, step: int, d: int) -> WirePlan:
        """Shard d of one step as a WirePlan of its own, its decisions
        the shard's rows of the step's."""
        do_crop, y0, x0, _ = self.base.steps[step]
        sl = slice(d * self.shard_batch, (d + 1) * self.shard_batch)
        views = {step: self.base.decisions[step].rows(sl.start, sl.stop)} if step in self.base.decisions else {}
        return dataclasses.replace(self.base, batch_size=self.shard_batch, cap=self.cap,
                                   steps={step: (do_crop[sl], y0[sl], x0[sl], self.steps[step][d])},
                                   decisions=views)


def shard_wire_plan(plan: WirePlan, n_shards: int) -> ShardedWirePlan:
    """Split a plan over n_shards data positions (JAX wire_format.py:213-232);
    the decisions are unchanged."""
    if plan.batch_size % n_shards:
        raise ValueError(f"batch_size {plan.batch_size} not divisible by {n_shards} shards")
    bs = plan.batch_size // n_shards
    cap, steps = max(plan.full_bytes, plan.crop_bytes), {}
    for s, (do_crop, _y0, _x0, _off) in plan.steps.items():
        per_shard = np.where(do_crop, plan.crop_bytes, plan.full_bytes).astype(np.int64).reshape(n_shards, bs)
        offs = np.zeros((n_shards, bs), np.int32)
        offs[:, 1:] = np.cumsum(per_shard, axis=1)[:, :-1]
        steps[s] = offs
        cap = max(cap, int(per_shard.sum(axis=1).max()))
    return ShardedWirePlan(base=plan, n_shards=n_shards, cap=cap, steps=steps)


def pack_sharded_wires(splan: ShardedWirePlan, step: int, staging: np.ndarray, eval_u8: np.ndarray,
                       out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """One step's wires on the host (JAX wire_format.py:235-264): `staging`
    and `eval_u8` hold the cropped and the uncropped clips in global
    decision order → (wires (n_shards, cap) u8, offsets (n_shards, B/n) i32).
    `out`, a zeroed (n_shards, cap) buffer (`pinned_wire(...).numpy()`), is
    filled in place."""
    do_crop = splan.base.steps[step][0]
    bs = splan.shard_batch
    wires = np.zeros((splan.n_shards, splan.cap), np.uint8) if out is None else out
    crop_cum = np.concatenate([[0], np.cumsum(do_crop.reshape(splan.n_shards, bs).sum(axis=1))])
    full_cum = np.concatenate([[0], np.cumsum((~do_crop).reshape(splan.n_shards, bs).sum(axis=1))])
    for d in range(splan.n_shards):
        pack_ragged_windows(splan.shard_view(step, d), step, staging[crop_cum[d]:crop_cum[d + 1]],
                            eval_u8[full_cum[d]:full_cum[d + 1]], out=wires[d])
    return wires, splan.steps[step]


def _even_origin(o: int, ship: int, limit: int) -> int:
    """Even-aligned superwindow origin covering [o, o+window) (JAX
    wire_format.py:307-310); the unpack computes the same."""
    return min(o - (o % 2), limit - ship)


def bgr_clip_to_i420(clip_u8: np.ndarray) -> np.ndarray:
    """u8 (T, H, W, 3) BGR → flat u8 I420 bytes (T·H·W·3/2,) by cv2, frame by
    frame (JAX wire_format.py:313-324)."""
    import cv2

    return np.concatenate([cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_BGR2YUV_I420).ravel() for f in clip_u8])


def bgr_clips_to_i420_batch(clips_u8: np.ndarray) -> np.ndarray:
    """u8 (B, T, H, W, 3) BGR → u8 (B, T·H·W·3/2) per-frame I420 rows, byte
    for byte `bgr_clip_to_i420` of each clip, in one cvtColor of the frames
    stacked vertically (H even: no 2×2 chroma block straddles two frames),
    its plane-major output reordered to per-frame [Y|U|V] (JAX
    wire_format.py:327-354)."""
    import cv2

    b, t, h, w, _ = clips_u8.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even frame dims, got {h}x{w}")
    buf = cv2.cvtColor(np.ascontiguousarray(clips_u8.reshape(b * t * h, w, 3)), cv2.COLOR_BGR2YUV_I420).ravel()
    n_y = b * t * h * w
    n_c = n_y // 4
    y = buf[:n_y].reshape(b, t, h * w)
    u = buf[n_y:n_y + n_c].reshape(b, t, h * w // 4)
    v = buf[n_y + n_c:].reshape(b, t, h * w // 4)
    return np.concatenate([y, u, v], axis=-1).reshape(b, t * h * w * 3 // 2)


def pack_ragged_windows(plan: WirePlan, step: int, staging: np.ndarray, eval_u8: np.ndarray,
                        out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """One step's wire on the host, by indexing (rgb) or indexing and cv2's
    I420 (yuv420) (JAX wire_format.py:357-384): `staging` holds the cropped
    clips' staging frames in decision order, `eval_u8` the uncropped clips'
    decode-time resizes → (wire (cap,) u8, offsets (B,) i32).  `out`, a
    zeroed (cap,) buffer (`pinned_wire(...).numpy()`), is filled in place."""
    do_crop, y0, x0, offsets = plan.steps[step]
    yuv = plan.colorspace == "yuv420"
    sh, sw = plan.crop_ship_hw
    hh, ww = plan.staging_hw
    wire = np.zeros(plan.cap, np.uint8) if out is None else out
    for j, i in enumerate(np.nonzero(do_crop)[0]):
        o = offsets[i]
        if yuv:
            ye, xe = _even_origin(int(y0[i]), sh, hh), _even_origin(int(x0[i]), sw, ww)
            wire[o:o + plan.crop_bytes] = bgr_clip_to_i420(staging[j, :, ye:ye + sh, xe:xe + sw])
        else:
            wire[o:o + plan.crop_bytes] = staging[j, :, y0[i]:y0[i] + sh, x0[i]:x0[i] + sw].ravel()
    for j, i in enumerate(np.nonzero(~do_crop)[0]):
        o = offsets[i]
        wire[o:o + plan.full_bytes] = bgr_clip_to_i420(eval_u8[j]) if yuv else eval_u8[j].ravel()
    return wire, offsets


def pinned_wire(shape) -> torch.Tensor:
    """A zeroed u8 host tensor of `shape` (a plan's (cap,), or a sharded
    plan's (n_shards, cap)), in pinned memory where a card is present, so
    that the steps' `non_blocking` copy of it runs asynchronously; the
    packers fill its `.numpy()` view (`out=`)."""
    return torch.zeros(shape, dtype=torch.uint8, pin_memory=torch.cuda.is_available())


def i420_to_bgr_u8(flat_u8: torch.Tensor, frames: int, h: int, w: int) -> torch.Tensor:
    """Flat I420 bytes → u8 BGR (JAX wire_format.py:387-405).  `flat_u8` is
    (..., frames·h·w·3/2); the result is (..., frames, h, w, 3).  Nearest
    2×2 chroma upsample and studio-swing BT.601 with cv2's Q20 constants,
    rounded half to even — the JAX function's float32 arithmetic, step for
    step."""
    lead = flat_u8.shape[:-1]
    fr = flat_u8.reshape(*lead, frames, h * 3 // 2, w).to(torch.float32)
    y = fr[..., :h, :]
    chroma = fr[..., h:, :].reshape(*lead, frames, 2, h // 2, w // 2)
    up = chroma.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    u = up[..., 0, :, :] - 128.0
    v = up[..., 1, :, :] - 128.0
    yy = 1.1640625 * torch.clamp_min(y - 16.0, 0.0)
    b = yy + 2.0178222656 * u
    g = yy - 0.3909912109 * u - 0.8129882812 * v
    r = yy + 1.5959472656 * v
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.uint8)


def make_wire_unpack(plan: WirePlan):
    """fn(wire_u8 (cap,) on the card, offsets (B,) host ints, step) → the
    (B, T, oh, ow, 3) u8 window buffer `crowd11_augment_windowed_from_decisions`
    takes (JAX wire_format.py:408-470): a cropped clip's window in the
    top-left corner, zeros around it (yuv420: its superwindow decoded, then
    the window at the origin the decisions name), an uncropped clip's full
    frames.  The gates and origins are the plan's host values for `step`."""
    ch, cw = plan.crop_hw
    sh, sw = plan.crop_ship_hw
    hh, ww = plan.staging_hw
    frames, (oh, ow) = plan.frames, plan.out_hw
    yuv = plan.colorspace == "yuv420"

    def rows(wire: torch.Tensor, offs, size: int) -> torch.Tensor:
        return torch.stack([wire[int(o):int(o) + size] for o in offs])

    def unpack(wire_u8: torch.Tensor, offsets, step: int) -> torch.Tensor:
        do_crop, y0, x0, _ = plan.steps[step]
        offsets = np.asarray(offsets)
        dev = wire_u8.device
        out = torch.zeros((len(do_crop), frames, oh, ow, 3), dtype=torch.uint8, device=dev)
        crop, full = np.nonzero(do_crop)[0], np.nonzero(~do_crop)[0]
        if len(crop):
            flat = rows(wire_u8, offsets[crop], plan.crop_bytes)
            if yuv:
                sup = i420_to_bgr_u8(flat, frames, sh, sw)
                for j, i in enumerate(crop):
                    dy = int(y0[i]) - _even_origin(int(y0[i]), sh, hh)
                    dx = int(x0[i]) - _even_origin(int(x0[i]), sw, ww)
                    out[i, :, :ch, :cw] = sup[j, :, dy:dy + ch, dx:dx + cw]
            else:
                out[torch.as_tensor(crop, device=dev), :, :ch, :cw] = flat.view(len(crop), frames, ch, cw, 3)
        if len(full):
            flat = rows(wire_u8, offsets[full], plan.full_bytes)
            imgs = i420_to_bgr_u8(flat, frames, oh, ow) if yuv else flat.view(len(full), frames, oh, ow, 3)
            out[torch.as_tensor(full, device=dev)] = imgs
        return out

    return unpack


def make_sharded_wire_unpack(splan: ShardedWirePlan, mesh, data_axis: str = "data"):
    """fn(wires (n_shards, cap) u8, offsets (n_shards, B/n) host ints, step)
    → one (B/n, T, oh, ow, 3) u8 window buffer a position of the mesh's
    `data_axis`, on its device: each position copies its own wire row there
    and unpacks it (JAX wire_format.py:267-304)."""
    devices = mesh.axis_devices(data_axis)
    if len(devices) != splan.n_shards:
        raise ValueError(f"plan sharded {splan.n_shards} ways but mesh axis {data_axis!r} has {len(devices)} "
                         "positions")

    def unpack(wires, offsets, step: int) -> List[torch.Tensor]:
        wires, offsets = torch.as_tensor(wires), np.asarray(offsets)
        return [make_wire_unpack(splan.shard_view(step, d))(wires[d].to(dev, non_blocking=True), offsets[d], step)
                for d, dev in enumerate(devices)]

    return unpack
