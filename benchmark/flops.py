"""Operations and bytes counted from shapes, family by family, for the
benchmark's utilisation and roofline metrics.

FLOPs are those of the published architectures at the configuration's
clip size: 2 per multiply-accumulate of every conv and dense layer (the
canonical 7x7x7 stem on 3 channels, not the space-to-depth form the
program runs it in), nothing for BatchNorm, ReLU, pools and softmax.  A
training step counts 3× the forward.

The 3x3x3/1 max pool of every Inception block reads its input once and
writes its output once (`i3d_pool_elems`); its gradient reads the
forward's input and the output's gradient and writes the input's
gradient, three tensors of that size.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from .reference import nets

Shape = Tuple[int, int, int]


def _same(shape: Shape, strides: Sequence[int]) -> Shape:
    return tuple(-(-n // s) for n, s in zip(shape, strides))


def _macs(shape: Shape, c_in: int, c_out: int, k: int) -> int:
    return math.prod(shape) * c_out * c_in * k ** 3


def i3d_trunk_macs(sizes: dict, thw: Shape, channels: int) -> Tuple[int, Shape]:
    """MACs of one I3D trunk on a clip of `thw`, and the shape it ends at."""
    shape = _same(thw, (2, 2, 2))
    macs = _macs(shape, channels, sizes["stem_features"], 7)
    shape = _same(shape, (1, 2, 2))
    macs += _macs(shape, sizes["stem_features"], sizes["conv2b_features"], 1)
    macs += _macs(shape, sizes["conv2b_features"], sizes["conv2c_features"], 3)
    shape, c = _same(shape, (1, 2, 2)), sizes["conv2c_features"]
    for pool, names in nets.I3D_GROUPS:
        if pool is not None:
            shape = _same(shape, pool[1])
        for name in names:
            b0, b1r, b1, b2r, b2, b3 = sizes["inception"][name]
            macs += _macs(shape, c, b0 + b1r + b2r + b3, 1) + _macs(shape, b1r, b1, 3) + _macs(shape, b2r, b2, 3)
            c = b0 + b1 + b2 + b3
    return macs, shape


def i3d_pool_elems(sizes: dict, thw: Shape) -> int:
    """Elements of the inputs of the nine 3x3x3/1 pools of one trunk."""
    shape = _same(_same(_same(thw, (2, 2, 2)), (1, 2, 2)), (1, 2, 2))
    c, elems = sizes["conv2c_features"], 0
    for pool, names in nets.I3D_GROUPS:
        if pool is not None:
            shape = _same(shape, pool[1])
        for name in names:
            elems += math.prod(shape) * c
            b0, _, b1, _, b2, b3 = sizes["inception"][name]
            c = b0 + b1 + b2 + b3
    return elems


def c3d_macs(sizes: dict, thw: Shape, classes: int) -> int:
    shape, c, macs = thw, 3, 0
    for name, c_out in sizes["convs"]:
        macs += _macs(shape, c, c_out, 3)
        c = c_out
        if name in nets.C3D_POOLS:
            if name == "conv5b":
                shape = (shape[0], shape[1] + 1, shape[2] + 1)
            shape = tuple(n // k for n, k in zip(shape, nets.C3D_POOLS[name]))
    fc = sizes["fc_features"]
    return macs + math.prod(shape) * c * fc + fc * fc + fc * classes


def r3d_macs(sizes: dict, thw: Shape, classes: int) -> int:
    shape = _same(thw, (2, 2, 2))
    macs = _macs(shape, 3, sizes["base_features"], 7)
    shape = _same(shape, (2, 2, 2))
    c = sizes["base_features"]
    for _, c_in, f, stride, _ in nets.r3d_blocks(sizes):
        out = _same(shape, (stride,) * 3)
        macs += _macs(out, c_in, f, 3) + _macs(out, f, f, 3)
        if stride > 1 or c_in != f:
            macs += _macs(out, c_in, f, 1)
        shape, c = out, f
    return macs + c * classes


def member_forward_flops(family: str, config: dict) -> int:
    """FLOPs of one member's forward on one clip."""
    sizes, classes = config["sizes"][family], config["classes"]
    full = (config["frames"], config["size"], config["size"])
    small = (nets.SMALL_FRAMES, config["size"] // 2, config["size"] // 2)
    if family in ("I3D", "TWOSTREAM_I3D"):
        macs, _ = i3d_trunk_macs(sizes, full, 3)
        width = nets.i3d_head_width(sizes, config["frames"])
        if family == "TWOSTREAM_I3D":
            macs += i3d_trunk_macs(sizes, full, 2)[0]
            width *= 2
        return 2 * (macs + width * classes)
    if family == "C3D":
        return 2 * c3d_macs(sizes, small, classes)
    if family == "R3D_18":
        return 2 * r3d_macs(sizes, small, classes)
    raise ValueError(f"no FLOP count for {family}")


def ensemble_clip_flops(config: dict) -> int:
    """FLOPs of one clip through every member of the configuration."""
    return sum(n * member_forward_flops(family, config) for family, n in config["members"].items())


def train_clip_flops(config: dict) -> int:
    """FLOPs of one clip of one member's training step: 3× its forward."""
    return 3 * member_forward_flops(config["train"]["family"], config)


def pool_bytes_per_launch(config: dict, families: Sequence[str], backward: bool = False) -> float:
    """Bytes one launch of the 3x3x3/1 pool (or its gradient) moves at
    least for one clip of its batch, averaged over the nine launches of a
    trunk: every trunk of these families runs the same nine shapes."""
    family = next(f for f in families if f in ("I3D", "TWOSTREAM_I3D"))
    thw = (config["frames"], config["size"], config["size"])
    elems = i3d_pool_elems(config["sizes"][family], thw)
    tensors = 3 if backward else 2
    return tensors * elems * config["activation_bytes"] / 9.0
