"""The one generator of the benchmark's traffic: it reads a mix's data file
(`benchmark/traffic/<name>.json`) and makes its resident inputs on the
device from the run's seed.

Clips are not white noise, which every network answers alike: each clip
is a smooth pattern of its own (normal values on a coarse `texture_grid`
of cells at two key frames, trilinearly interpolated over the frames and
the pixels), with its own brightness and contrast, plus uniform pixel
noise of `noise` levels, clipped to bytes.  Kinds of mix (the file's
"kind"):

- `resident_i420`: `resident_batches` × `batch` flat I420 rows of
  `frames` × `staging`² pixels (the pattern drawn over the Y and chroma
  planes alike).
- `resident_rgb`: as many uint8 BGR clips of `frames` × `staging`² and
  their labels, uniform over `classes`.
- `stored_rgb_flow`: as many float32 BGR clips of `frames` × `size`² with
  integer values 0-255, and stored flow fields of the same size, two
  channels, smooth patterns of standard deviation `flow_std` pixels: the
  precomputed flow a heterogeneous ensemble reads.

Every run of a seed makes the same tensors; every seed makes the same
shapes, so the work of a window does not depend on the seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .weights import sub_seed

TRAFFIC_STREAM = 7


def _patterns(gen: torch.Generator, n: int, channels: int, frames: int, hw: Tuple[int, int], grid: int,
              device) -> torch.Tensor:
    """(n, frames, h, w, channels) float32 smooth patterns of unit scale,
    each clip with its own gain and offset."""
    keys = torch.randn((n, channels, 2, grid, grid), generator=gen, device=device)
    smooth = F.interpolate(keys, size=(frames, *hw), mode="trilinear", align_corners=True)
    gain = 0.5 + torch.rand((n, 1, 1, 1, 1), generator=gen, device=device)
    offset = torch.randn((n, 1, 1, 1, 1), generator=gen, device=device) * 0.5
    return (smooth * gain + offset).permute(0, 2, 3, 4, 1)


def _clip_bytes(gen: torch.Generator, n: int, channels: int, frames: int, hw: Tuple[int, int], traffic: dict,
                device) -> torch.Tensor:
    """uint8 (n, frames, h, w, channels) clips, made a batch at a time."""
    out = torch.empty((n, frames, *hw, channels), dtype=torch.uint8, device=device)
    b = traffic["batch"]
    for i in range(0, n, b):
        m = min(b, n - i)
        x = 128.0 + 64.0 * _patterns(gen, m, channels, frames, hw, traffic["texture_grid"], device)
        x += (torch.rand(x.shape, generator=gen, device=device) - 0.5) * traffic["noise"]
        out[i:i + m] = x.round_().clamp_(0, 255).to(torch.uint8)
    return out


def make(traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, TRAFFIC_STREAM))
    n, kind, t = traffic["resident_batches"] * traffic["batch"], traffic["kind"], traffic["frames"]
    if kind == "resident_i420":
        s = traffic["staging"]
        return {"i420": _clip_bytes(gen, n, 1, t, (s * 3 // 2, s), traffic, device).reshape(n, -1)}
    if kind == "resident_rgb":
        s = traffic["staging"]
        rgb = _clip_bytes(gen, n, 3, t, (s, s), traffic, device)
        return {"rgb": rgb, "label": torch.randint(0, traffic["classes"], (n,), generator=gen, device=device)}
    if kind == "stored_rgb_flow":
        s = traffic["size"]
        rgb = _clip_bytes(gen, n, 3, t, (s, s), traffic, device).float()
        flow = torch.empty((n, t, s, s, 2), device=device)
        for i in range(0, n, traffic["batch"]):
            m = min(traffic["batch"], n - i)
            flow[i:i + m] = _patterns(gen, m, 2, t, (s, s), traffic["texture_grid"], device) * traffic["flow_std"]
        return {"rgb": rgb, "flow": flow}
    raise ValueError(f"unknown traffic kind {kind!r}")
