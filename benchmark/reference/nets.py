"""Plain float32 forwards of the benchmark's model families, from the
published architectures, in plain PyTorch.

Each network is a function of a dict of named float32 tensors (the names
are the published layer names, `trunk.Mixed_3b.b0_1x1.conv.weight`) and of
the sizes in the configuration's file.  Tensors are NCDHW inside, clips
NTHWC outside.  Nothing here imports the program under test.

- I3D (Carreira & Zisserman, arXiv:1705.07750; Keras I3D as the Crowd-11
  reference trains it): a 7x7x7/2 stem, 1x1x1 and 3x3x3 convs, nine
  Inception blocks, TF-SAME padding everywhere (the odd pad after), every
  conv without a bias and followed by BatchNorm without a scale (eps 1e-3)
  and ReLU, an average pool over (2, h, w), a Keras Flatten in (T, H, W, C)
  order and one dense layer.
- TwoStream-I3D: an rgb and a flow I3D trunk, their flattened features
  concatenated, one dense layer.
- C3D (Tran et al., arXiv:1412.0767): eight 3x3x3 convs with biases and
  ReLU, VALID max pools, a zero pad before pool5, fc6-fc8 (dropout is off
  in inference).
- R3D-18 (Hara et al., arXiv:1711.09577; keras-resnet3d): pre-activation
  basic blocks, BatchNorm with a scale, 1x1x1 VALID projection shortcuts,
  a full-volume mean and one dense layer.

`Precision` says how the convs and dense layers compute: exactly in
float32, or, for the correctness check's control, on operands rounded to
float8 (e4m3, per-tensor activations and per-output-channel weights) or to
int4 (static per-tensor activation scales from a calibration, per-channel
weights).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BN_EPS = 1e-3
FP8_MAX = 448.0
INT4_MAX = 7.0

Params = Dict[str, torch.Tensor]


class Precision:
    """How the reference's convs and dense layers compute.

    mode None: float32 operands.  'bf16': both operands rounded to
    bfloat16 (a witness of what bf16 compute alone does).  'fp8': both operands rounded to
    float8_e4m3 under a scale that maps their max to 448.  'int4': operands
    rounded to integers in [-7, 7], weights per output channel, activations
    under a static per-tensor scale from `calibrate` (`scales`), which
    records max|x| of every site over the calibration batches."""

    def __init__(self, mode: Optional[str] = None):
        if mode not in (None, "bf16", "fp8", "int4"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.calibrating = False
        self.scales: Dict[str, torch.Tensor] = {}

    def operands(self, site: str, x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.calibrating:
            m = x.detach().abs().amax()
            self.scales[site] = torch.maximum(self.scales[site], m) if site in self.scales else m
            return x, w
        if self.mode is None:
            return x, w
        axes = tuple(range(1, w.dim()))
        if self.mode == "bf16":
            return _bf16(x), _bf16(w)
        if self.mode == "fp8":
            return _fp8(x, x.detach().abs().amax()), _fp8(w, w.detach().abs().amax(dim=axes, keepdim=True))
        if site not in self.scales:
            raise ValueError(f"int4 site {site} was not calibrated")
        return _int4(x, self.scales[site]), _int4(w, w.detach().abs().amax(dim=axes, keepdim=True))


def _fp8(t: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    s = amax.clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()  # rounding in the forward, the exact gradient in the backward


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t + (t.detach().to(torch.bfloat16).float() - t).detach()


def _int4(t: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    s = amax.clamp_min(1e-30) / INT4_MAX
    q = torch.clamp(torch.round(t.detach() / s), -INT4_MAX, INT4_MAX) * s
    return t + (q - t).detach()


EXACT = Precision()


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME (before, after) pads of one axis: the odd pad goes after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel, strides, value: float = 0.0) -> torch.Tensor:
    pads = [same_pads(int(n), k, s) for n, k, s in zip(x.shape[2:], kernel, strides)]
    flat = [p for axis in reversed(pads) for p in axis]
    return F.pad(x, flat, value=value)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], strides, padding: str, site: str,
         prec: Precision) -> torch.Tensor:
    """A 3D conv with TF-SAME or VALID padding."""
    x, w = prec.operands(site, x, w)
    if padding == "SAME":
        x = pad_same(x, w.shape[2:], strides)
    return F.conv3d(x, w, b, stride=tuple(strides))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, site: str, prec: Precision) -> torch.Tensor:
    x, w = prec.operands(site, x, w)
    return F.linear(x, w, b)


def batch_norm(x: torch.Tensor, p: Params, name: str, train: bool, scale: bool) -> torch.Tensor:
    """Keras BatchNormalization: running statistics in inference, the
    biased batch statistics in training; `scale` False means gamma = 1."""
    gamma = p[name + ".weight"] if scale else None
    if train:
        if gamma is None:  # CUDA's batch-norm backward wants a weight beside a bias
            gamma = torch.ones_like(p[name + ".bias"])
        return F.batch_norm(x, None, None, gamma, p[name + ".bias"], training=True, eps=BN_EPS)
    view = lambda t: t.view(1, -1, 1, 1, 1)  # noqa: E731
    y = (x - view(p[name + ".running_mean"])) * view(torch.rsqrt(p[name + ".running_var"] + BN_EPS))
    if gamma is not None:
        y = y * view(gamma)
    return y + view(p[name + ".bias"])


def max_pool_same(x: torch.Tensor, window, strides) -> torch.Tensor:
    return F.max_pool3d(pad_same(x, window, strides, float("-inf")), window, tuple(strides))


def flatten_thwc(x: torch.Tensor) -> torch.Tensor:
    """Keras Flatten of a channels-last tensor, from NCDHW."""
    return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)


def _maybe_checkpoint(fn, x: torch.Tensor, checkpoint: bool) -> torch.Tensor:
    if checkpoint and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    return fn(x)


# ----------------------------------------------------------------------
# I3D and TwoStream-I3D
# ----------------------------------------------------------------------

I3D_GROUPS = (
    (None, ("Mixed_3b", "Mixed_3c")),
    (((3, 3, 3), (2, 2, 2)), ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f")),
    (((2, 2, 2), (2, 2, 2)), ("Mixed_5b", "Mixed_5c")),
)


def i3d_trunk_specs(prefix: str, channels: int, sizes: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, role) of every tensor of one I3D trunk: roles conv
    (fan in), stem_conv, bn_beta, bn_mean, bn_var."""
    out: List[Tuple[str, tuple, str]] = []

    def convbn(name: str, c_in: int, c_out: int, k: int, role: str = "conv") -> None:
        out.append((f"{prefix}{name}.conv.weight", (c_out, c_in, k, k, k), role))
        for stat, role_ in (("bias", "bn_beta"), ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out.append((f"{prefix}{name}.bn.{stat}", (c_out,), role_))

    stem, c2b, c2c = sizes["stem_features"], sizes["conv2b_features"], sizes["conv2c_features"]
    convbn("Conv3d_1a_7x7", channels, stem, 7, "stem_conv")
    convbn("Conv3d_2b_1x1", stem, c2b, 1)
    convbn("Conv3d_2c_3x3", c2b, c2c, 3)
    features = c2c
    for _, names in I3D_GROUPS:
        for name in names:
            b0, b1r, b1, b2r, b2, b3 = sizes["inception"][name]
            convbn(f"{name}.b0_1x1", features, b0, 1)
            convbn(f"{name}.b1_1x1", features, b1r, 1)
            convbn(f"{name}.b1_3x3", b1r, b1, 3)
            convbn(f"{name}.b2_1x1", features, b2r, 1)
            convbn(f"{name}.b2_3x3", b2r, b2, 3)
            convbn(f"{name}.b3_1x1", features, b3, 1)
            features = b0 + b1 + b2 + b3
    return out


def i3d_trunk_features(sizes: dict) -> int:
    b0, _, b1, _, b2, b3 = sizes["inception"]["Mixed_5c"]
    return b0 + b1 + b2 + b3


def i3d_head_width(sizes: dict, frames: int) -> int:
    """The dense layer's input: the stem and two pools halve time with
    TF-SAME rounding, the head averages pairs of the frames left."""
    t = math.ceil(math.ceil(math.ceil(frames / 2) / 2) / 2)
    return (t - 1) * i3d_trunk_features(sizes)


def i3d_trunk(p: Params, prefix: str, x: torch.Tensor, sizes: dict, prec: Precision = EXACT, train: bool = False,
              checkpoint: bool = False) -> torch.Tensor:
    """NCDHW clips → the trunk's NCDHW features."""

    def cbr(name: str, y: torch.Tensor, strides=(1, 1, 1)) -> torch.Tensor:
        site = prefix + name
        y = conv(y, p[site + ".conv.weight"], None, strides, "SAME", site, prec)
        return F.relu(batch_norm(y, p, site + ".bn", train, scale=False))

    def front(y: torch.Tensor) -> torch.Tensor:
        y = cbr("Conv3d_1a_7x7", y, (2, 2, 2))
        y = max_pool_same(y, (1, 3, 3), (1, 2, 2))
        y = cbr("Conv3d_2b_1x1", y)
        y = cbr("Conv3d_2c_3x3", y)
        return max_pool_same(y, (1, 3, 3), (1, 2, 2))

    def block(name: str):
        def run(y: torch.Tensor) -> torch.Tensor:
            b0 = cbr(f"{name}.b0_1x1", y)
            b1 = cbr(f"{name}.b1_3x3", cbr(f"{name}.b1_1x1", y))
            b2 = cbr(f"{name}.b2_3x3", cbr(f"{name}.b2_1x1", y))
            b3 = cbr(f"{name}.b3_1x1", max_pool_same(y, (3, 3, 3), (1, 1, 1)))
            return torch.cat([b0, b1, b2, b3], dim=1)
        return run

    x = _maybe_checkpoint(front, x, checkpoint)
    for pool, names in I3D_GROUPS:
        if pool is not None:
            x = max_pool_same(x, *pool)
        for name in names:
            x = _maybe_checkpoint(block(name), x, checkpoint)
    return x


def i3d_head(x: torch.Tensor) -> torch.Tensor:
    """AvgPool3D((2, h, w)) VALID, stride 1, then Flatten."""
    return flatten_thwc(F.avg_pool3d(x, (2, int(x.shape[3]), int(x.shape[4])), stride=1))


def i3d_specs(sizes: dict, frames: int, classes: int) -> List[Tuple[str, tuple, str]]:
    width = i3d_head_width(sizes, frames)
    return i3d_trunk_specs("trunk.", 3, sizes) + [("predictions.weight", (classes, width), "dense"),
                                                   ("predictions.bias", (classes,), "dense_bias")]


def i3d_logits(p: Params, clips: torch.Tensor, sizes: dict, prec: Precision = EXACT, train: bool = False,
               checkpoint: bool = False) -> torch.Tensor:
    """NTHWC clips → logits."""
    x = i3d_trunk(p, "trunk.", clips.permute(0, 4, 1, 2, 3), sizes, prec, train, checkpoint)
    return dense(i3d_head(x), p["predictions.weight"], p["predictions.bias"], "predictions", prec)


def twostream_specs(sizes: dict, frames: int, classes: int) -> List[Tuple[str, tuple, str]]:
    width = 2 * i3d_head_width(sizes, frames)
    return (i3d_trunk_specs("rgb_trunk.", 3, sizes) + i3d_trunk_specs("flow_trunk.", 2, sizes)
            + [("predictions.weight", (classes, width), "dense"), ("predictions.bias", (classes,), "dense_bias")])


def twostream_logits(p: Params, rgb: torch.Tensor, flow: torch.Tensor, sizes: dict,
                     prec: Precision = EXACT) -> torch.Tensor:
    feats = torch.cat([i3d_head(i3d_trunk(p, "rgb_trunk.", rgb.permute(0, 4, 1, 2, 3), sizes, prec)),
                       i3d_head(i3d_trunk(p, "flow_trunk.", flow.permute(0, 4, 1, 2, 3), sizes, prec))], dim=-1)
    return dense(feats, p["predictions.weight"], p["predictions.bias"], "predictions", prec)


# ----------------------------------------------------------------------
# C3D
# ----------------------------------------------------------------------

C3D_POOLS = {"conv1": (1, 2, 2), "conv2": (2, 2, 2), "conv3b": (2, 2, 2), "conv4b": (2, 2, 2), "conv5b": (2, 2, 2)}


def c3d_flat(sizes: dict, clip_thw: Sequence[int]) -> int:
    t, h, w = clip_thw
    for name, _ in sizes["convs"]:
        if name in C3D_POOLS:
            kt, kh, kw = C3D_POOLS[name]
            if name == "conv5b":
                h, w = h + 1, w + 1
            t, h, w = t // kt, h // kh, w // kw
    return t * h * w * sizes["convs"][-1][1]


def c3d_specs(sizes: dict, clip_thw: Sequence[int], classes: int) -> List[Tuple[str, tuple, str]]:
    out, c_in = [], 3
    for i, (name, c_out) in enumerate(sizes["convs"]):
        out += [(f"{name}.weight", (c_out, c_in, 3, 3, 3), "stem_conv" if i == 0 else "conv"),
                (f"{name}.bias", (c_out,), "conv_bias")]
        c_in = c_out
    fc = sizes["fc_features"]
    for name, a, b in (("fc6", c3d_flat(sizes, clip_thw), fc), ("fc7", fc, fc), ("fc8", fc, classes)):
        out += [(f"{name}.weight", (b, a), "dense_relu" if name != "fc8" else "dense"),
                (f"{name}.bias", (b,), "dense_bias")]
    return out


def c3d_logits(p: Params, clips: torch.Tensor, sizes: dict, prec: Precision = EXACT) -> torch.Tensor:
    x = clips.permute(0, 4, 1, 2, 3)
    for name, _ in sizes["convs"]:
        x = F.relu(conv(x, p[name + ".weight"], p[name + ".bias"], (1, 1, 1), "SAME", name, prec))
        if name == "conv5b":
            x = F.pad(x, (0, 1, 0, 1))
        if name in C3D_POOLS:
            x = F.max_pool3d(x, C3D_POOLS[name], C3D_POOLS[name])
    x = F.relu(dense(flatten_thwc(x), p["fc6.weight"], p["fc6.bias"], "fc6", prec))
    x = F.relu(dense(x, p["fc7.weight"], p["fc7.bias"], "fc7", prec))
    return dense(x, p["fc8.weight"], p["fc8.bias"], "fc8", prec)


# ----------------------------------------------------------------------
# R3D (basic blocks)
# ----------------------------------------------------------------------


def _bn_specs(name: str, c: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.bn.weight", (c,), "bn_gamma"), (f"{name}.bn.bias", (c,), "bn_beta"),
            (f"{name}.bn.running_mean", (c,), "bn_mean"), (f"{name}.bn.running_var", (c,), "bn_var")]


def r3d_blocks(sizes: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, c_in, features, stride, first) of every basic block."""
    out, c_in, features = [], sizes["base_features"], sizes["base_features"]
    for stage, reps in enumerate(sizes["repetitions"]):
        for i in range(reps):
            stride = 2 if (i == 0 and stage != 0) else 1
            out.append((f"stage{stage}_block{i}", c_in, features, stride, stage == 0 and i == 0))
            c_in = features
        features *= 2
    return out


def r3d_specs(sizes: dict, classes: int) -> List[Tuple[str, tuple, str]]:
    base = sizes["base_features"]
    out = [("conv1.weight", (base, 3, 7, 7, 7), "stem_conv"), ("conv1.bias", (base,), "conv_bias")]
    out += _bn_specs("stem_bnrelu", base)
    c_out = base
    for name, c_in, f, stride, first in r3d_blocks(sizes):
        if not first:
            out += _bn_specs(f"{name}.preact1", c_in)
        out += [(f"{name}.conv1.weight", (f, c_in, 3, 3, 3), "conv"), (f"{name}.conv1.bias", (f,), "conv_bias")]
        out += _bn_specs(f"{name}.preact2", f)
        out += [(f"{name}.conv2.weight", (f, f, 3, 3, 3), "conv"), (f"{name}.conv2.bias", (f,), "conv_bias")]
        if stride > 1 or c_in != f:
            out += [(f"{name}.shortcut.proj.weight", (f, c_in, 1, 1, 1), "conv"),
                    (f"{name}.shortcut.proj.bias", (f,), "conv_bias")]
        c_out = f
    out += _bn_specs("final_bnrelu", c_out)
    return out + [("predictions.weight", (classes, c_out), "dense"), ("predictions.bias", (classes,), "dense_bias")]


def r3d_logits(p: Params, clips: torch.Tensor, sizes: dict, prec: Precision = EXACT) -> torch.Tensor:
    def bnr(name: str, y: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm(y, p, name + ".bn", False, scale=True))

    x = conv(clips.permute(0, 4, 1, 2, 3), p["conv1.weight"], p["conv1.bias"], (2, 2, 2), "SAME", "conv1", prec)
    x = max_pool_same(bnr("stem_bnrelu", x), (3, 3, 3), (2, 2, 2))
    for name, c_in, f, stride, first in r3d_blocks(sizes):
        y = x if first else bnr(f"{name}.preact1", x)
        y = conv(y, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"], (stride,) * 3, "SAME", f"{name}.conv1", prec)
        y = conv(bnr(f"{name}.preact2", y), p[f"{name}.conv2.weight"], p[f"{name}.conv2.bias"], (1, 1, 1), "SAME",
                 f"{name}.conv2", prec)
        if f"{name}.shortcut.proj.weight" in p:
            s = tuple(math.ceil(int(a) / int(b)) for a, b in zip(x.shape[2:], y.shape[2:]))
            x = conv(x, p[f"{name}.shortcut.proj.weight"], p[f"{name}.shortcut.proj.bias"], s, "VALID",
                     f"{name}.shortcut.proj", prec)
        x = x + y
    x = bnr("final_bnrelu", x).mean(dim=(2, 3, 4))
    return dense(x, p["predictions.weight"], p["predictions.bias"], "predictions", prec)


# ----------------------------------------------------------------------
# By family
# ----------------------------------------------------------------------

SMALL_FRAMES = 16  # C3D and R3D take the first 16 frames at half the size of the 224² clips


def family_specs(family: str, config: dict) -> List[Tuple[str, tuple, str]]:
    sizes, classes, frames = config["sizes"][family], config["classes"], config["frames"]
    if family == "I3D":
        return i3d_specs(sizes, frames, classes)
    if family == "TWOSTREAM_I3D":
        return twostream_specs(sizes, frames, classes)
    if family == "C3D":
        return c3d_specs(sizes, (SMALL_FRAMES, config["size"] // 2, config["size"] // 2), classes)
    if family == "R3D_18":
        return r3d_specs(sizes, classes)
    raise ValueError(f"no reference for {family}")


def small_clips(rgb: torch.Tensor) -> torch.Tensor:
    """C3D's and R3D's clips: the first 16 frames of the 224² clips, every
    second pixel."""
    return rgb[:, :SMALL_FRAMES, ::2, ::2]


def family_logits(family: str, p: Params, inputs: Dict[str, torch.Tensor], config: dict,
                  prec: Precision = EXACT) -> torch.Tensor:
    """Logits of one member of `family` on NTHWC float32 inputs ('rgb' at
    the configuration's size, 'flow' for TwoStream)."""
    sizes = config["sizes"][family]
    if family == "I3D":
        return i3d_logits(p, inputs["rgb"], sizes, prec)
    if family == "TWOSTREAM_I3D":
        return twostream_logits(p, inputs["rgb"], inputs["flow"], sizes, prec)
    if family == "C3D":
        return c3d_logits(p, small_clips(inputs["rgb"]), sizes, prec)
    if family == "R3D_18":
        return r3d_logits(p, small_clips(inputs["rgb"]), sizes, prec)
    raise ValueError(f"no reference for {family}")
