"""Seeded weights of the benchmark's members, made on the device.

The benchmark, not the program, makes the weights: one standard-normal
draw per member from a generator on the card, sliced and scaled by each
tensor's role in the reference's list of tensors (`reference.nets.
family_specs`), rounded to the type the configuration serves its weights
in, and handed alike to the program (`load_into`) and to the reference.

Scales keep every layer's activations of order one at the configuration's
input scale, so that softmax outputs are neither uniform nor one-hot:
He-normal convs, a first conv divided by the input's root mean square,
LeCun-normal dense layers, BatchNorm statistics spread about (0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

WEIGHT_ROLES = ("conv", "stem_conv", "dense", "dense_relu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of the run's draws."""
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(1, np.uint64)[0] >> 1)


def _fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[1:])


def make_member(specs: List[Tuple[str, tuple, str]], seed: int, device, weight_dtype: str,
                input_rms: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """name → float32 tensor on `device` for every tensor of `specs`, from
    one draw.  `input_rms` maps a stem's trunk prefix ('' for the only
    one) to the root mean square of what it reads."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    cast = DTYPES[weight_dtype]
    for name, shape, role in specs:
        n = math.prod(shape)
        t = z[at:at + n].view(shape)
        at += n
        if role in ("conv", "stem_conv", "dense_relu"):
            t = t * math.sqrt(2.0 / _fan_in(shape))
            if role == "stem_conv":
                t = t / _stem_rms(name, input_rms)
        elif role == "dense":
            t = t * math.sqrt(1.0 / _fan_in(shape))
        elif role == "dense_bias":
            t = t * 0.0
        elif role in ("conv_bias", "bn_beta", "bn_mean"):
            t = t * 0.1
        elif role == "bn_gamma":
            t = 1.0 + 0.1 * t
        elif role == "bn_var":
            t = torch.exp(0.2 * t)
        else:
            raise ValueError(f"unknown role {role}")
        if role in WEIGHT_ROLES:
            t = t.to(cast).float()
        out[name] = t.contiguous()
    return out


def _stem_rms(name: str, input_rms: Dict[str, float]) -> float:
    for prefix, rms in input_rms.items():
        if prefix and name.startswith(prefix):
            return rms
    return input_rms[""]


# The program's tensors that the reference has no use for: the fixed
# BatchNorm scale of the I3D family (Keras scale=False), BatchNorm's step
# counter, and the int8 sites' calibration state.
PROGRAM_ONLY = (".bn.weight", "num_batches_tracked", "act_absmax")


def load_into(module: torch.nn.Module, params: Dict[str, torch.Tensor], scale_free_bn: bool) -> None:
    """Copy the benchmark's tensors into the program's module; every tensor
    the module holds is one of them, or one the reference has no use for."""
    missing, unexpected = module.load_state_dict(params, strict=False)
    allowed = tuple(s for s in PROGRAM_ONLY if scale_free_bn or s != ".bn.weight")
    left = [k for k in missing if not k.endswith(allowed)]
    if left or unexpected:
        raise RuntimeError(f"the program's state does not match the reference's tensors: "
                           f"missing {left[:5]}, unexpected {list(unexpected)[:5]}")


def to_host(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in params.items()}


def to_device(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in params.items()}
