"""Plain float32 front end of the Crowd-11 inference and training paths.

- `i420_to_bgr`: flat I420 rows to BGR, nearest 2x2 chroma and studio-swing
  BT.601 with cv2's Q20 constants, rounded half to even, clipped to 0-255.
- `draw_decisions` and `step_generator`: the augment policy's per-clip
  draws, in the order the system draws them from a CPU `torch.Generator`
  (crop gate, y0, x0, flip, salt gate, pepper gate, then a 62-bit noise
  seed), so that the reference works the decisions out again from the same
  seed.
- `crop_flip_resize`: cv2 INTER_LINEAR (half-pixel centres, edge clamp) of
  the crop window, or the whole frame, mirrored in x where flipped.
- `salt_pepper`: each element takes one 32-bit Philox4x32-10 draw, keyed
  by the 64-bit noise seed, counter (element // 4, row of the clip in its
  batch, 0, 0); low 16 bits under 65536 // ratio make salt (255), high 16
  bits pepper (0), pepper after salt, each only where the clip's gate is on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

CROP_MARGIN = 60
NOISE_RATIO = 100


def i420_to_bgr(flat_u8: torch.Tensor, frames: int, h: int, w: int) -> torch.Tensor:
    """(N, frames·h·w·3/2) u8 → (N, frames, h, w, 3) float32 0-255 integers."""
    n = flat_u8.shape[0]
    fr = flat_u8.reshape(n, frames, h * 3 // 2, w).float()
    y = fr[:, :, :h, :]
    chroma = fr[:, :, h:, :].reshape(n, frames, 2, h // 2, w // 2)
    up = chroma.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    u, v = up[:, :, 0] - 128.0, up[:, :, 1] - 128.0
    yy = 1.1640625 * torch.clamp_min(y - 16.0, 0.0)
    bgr = torch.stack([yy + 2.0178222656 * u, yy - 0.3909912109 * u - 0.8129882812 * v, yy + 1.5959472656 * v], -1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of a train step's draws, seeded by (seed, step)."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))


def draw_decisions(gen: torch.Generator, batch: int, staging_hw: Tuple[int, int], p: float) -> Dict:
    h, w = staging_hw
    ch, cw = max(h - CROP_MARGIN, 1), max(w - CROP_MARGIN, 1)
    gate = lambda: torch.rand(batch, generator=gen) < p  # noqa: E731
    do_crop = gate()
    y0 = torch.randint(0, h - ch + 1, (batch,), generator=gen)
    x0 = torch.randint(0, w - cw + 1, (batch,), generator=gen)
    flip, salt, pepper = gate(), gate(), gate()
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    return {"do_crop": do_crop, "y0": y0, "x0": x0, "flip": flip, "salt": salt, "pepper": pepper, "seed": seed}


def _coords(out: int, size: torch.Tensor, start: torch.Tensor, flip) -> torch.Tensor:
    size = size.reshape(-1, 1)
    c = (torch.arange(out, dtype=torch.float32, device=size.device) + 0.5) * (size / out) - 0.5
    if flip is not None:
        c = torch.where(flip.reshape(-1, 1), (size - 1.0) - c, c)
    return torch.minimum(torch.clamp_min(c, 0.0), size - 1.0) + start.reshape(-1, 1)


def _lerp(x: torch.Tensor, coords: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    c0 = torch.clamp(torch.floor(coords), 0, n - 1)
    c1 = torch.clamp(c0 + 1, 0, n - 1)
    t = torch.clamp(coords - c0, 0.0, 1.0)
    shape = [1] * x.dim()
    shape[0], shape[dim] = coords.shape
    a = torch.take_along_dim(x, c0.long().reshape(shape), dim=dim)
    b = torch.take_along_dim(x, c1.long().reshape(shape), dim=dim)
    t = t.reshape(shape)
    return a * (1.0 - t) + b * t


def crop_flip_resize(clips: torch.Tensor, out_hw: Tuple[int, int], d: Dict) -> torch.Tensor:
    """(B, T, H, W, C) float32 → (B, T, oh, ow, C) with each clip's window
    and flip from `d` (tensors of B rows on the clips' device)."""
    _, _, h, w, _ = clips.shape
    ch, cw = max(h - CROP_MARGIN, 1), max(w - CROP_MARGIN, 1)
    crop = d["do_crop"]
    y0 = torch.where(crop, d["y0"], 0).float()
    x0 = torch.where(crop, d["x0"], 0).float()
    ones = torch.ones_like(y0)
    wh = torch.where(crop, ones * ch, ones * h)
    ww = torch.where(crop, ones * cw, ones * w)
    out = _lerp(clips, _coords(out_hw[0], wh, y0, None), 2)
    return _lerp(out, _coords(out_hw[1], ww, x0, d["flip"]), 3)


_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox_words(seed: int, rows: torch.Tensor, length: int) -> torch.Tensor:
    """(len(rows), length) int64 32-bit draws: element e of the clip in
    batch row r is word e % 4 of Philox4x32-10((e // 4, r, 0, 0), seed)."""
    groups = (length + 3) // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=rows.device).expand(len(rows), groups)
    c1 = rows.to(torch.int64)[:, None].expand(len(rows), groups)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(len(rows), 4 * groups)[:, :length]


def salt_pepper(x: torch.Tensor, seed: int, rows: torch.Tensor, salt: torch.Tensor, pepper: torch.Tensor,
                ratio: int = NOISE_RATIO) -> torch.Tensor:
    """x (B, ...) float32 clips at batch rows `rows` of a batch whose noise
    seed is `seed`; gates (B,) bool."""
    b = x.shape[0]
    thr = max(65536 // ratio, 1)
    bits = philox_words(seed, rows, x[0].numel())
    flat = x.reshape(b, -1)
    out = torch.where(salt.reshape(b, 1) & ((bits & 0xFFFF) < thr), torch.full_like(flat, 255.0), flat)
    out = torch.where(pepper.reshape(b, 1) & (((bits >> 16) & 0xFFFF) < thr), torch.zeros_like(out), out)
    return out.reshape(x.shape)


def augment(clips: torch.Tensor, out_hw: Tuple[int, int], d: Dict, rows: torch.Tensor) -> torch.Tensor:
    """The Crowd-11 policy on clips that sit at `rows` of the batch the
    decisions `d` (already sliced to those rows) were drawn for."""
    dev = clips.device
    dd = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in d.items()}
    return salt_pepper(crop_flip_resize(clips, out_hw, dd), d["seed"], rows.to(dev), dd["salt"], dd["pepper"])


def select(d: Dict, rows) -> Dict:
    """The decisions of the given batch rows (the noise seed is the batch's)."""
    idx = torch.as_tensor(rows, dtype=torch.long)
    return {k: (v[idx] if torch.is_tensor(v) else v) for k, v in d.items()}
