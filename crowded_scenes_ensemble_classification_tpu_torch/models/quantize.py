"""Static int8 calibration for the ported model zoo.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/quantize.py`.
There the state travels in flax collections ('qstats', 'qparams'); here
each quantized site holds it as buffers (`models/common.QuantConv`,
`PrestagedS2DStemConvBN`): `act_absmax`, and on a QuantConv the baked `k8`
(int8 OIDHW) and `sw` (f32 (F,)).  A calibrated and baked state dict loads
into a model built with quant='static', and a plain one into any quant model.

1. build the model with quant='calib' and run a few representative batches
   through `calibrate`: each site records its running max|x| while
   computing the exact f32 forward;
2. `quantize_variables` bakes every calibrated QuantConv's weights to int8
   once (per-output-channel scales); the prestaged s2d stem quantizes its
   derived kernel itself and gets none, as in JAX;
3. `set_quant_mode(module, 'static')` (or a model built with
   quant='static' that loads the state dict) then runs every conv on the
   int8 kernel with the calibrated scales.  Each static site then holds its
   packed weights and scales as non-persistent buffers, so its forward
   traces (`torch.export`, `torch.compile`) as a pure function of its
   variables and the state dict stays as it was.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

# JAX models/quantize.py:52-59: int8 at the three stem convs and the
# largest-channel Mixed blocks (an accuracy policy; the JAX round-5 A/B
# found whole-model int8 the faster one on its TPU).
MIXED_INT8_POLICY: Tuple[str, ...] = (
    "Conv3d_1a_7x7",
    "Conv3d_2b_1x1",
    "Conv3d_2c_3x3",
    "Mixed_4f",
    "Mixed_5b",
    "Mixed_5c",
)


def resolve_quant_blocks(spec) -> Optional[Tuple[str, ...]]:
    """A quant-block policy (JAX models/quantize.py:62-78): None or 'all' →
    None (quantize every site), 'mixed' → MIXED_INT8_POLICY, a comma string
    or an iterable of site names → their sorted tuple.  Sites are the I3D
    stem convs ('Conv3d_1a_7x7', 'Conv3d_2b_1x1', 'Conv3d_2c_3x3') and the
    nine 'Mixed_*' blocks."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "mixed":
            return MIXED_INT8_POLICY
        if spec == "all":
            return None
        spec = [s.strip() for s in spec.split(",") if s.strip()]
    return tuple(sorted(spec))


def quant_sites(module: nn.Module) -> Dict[str, nn.Module]:
    """{module path: site} of every quantized site (a QuantConv or a
    quantized prestaged stem)."""
    return {name: m for name, m in module.named_modules() if getattr(m, "quant_mode", None)}


def set_quant_mode(module: nn.Module, mode: str) -> nn.Module:
    """Switch every calibrated site between 'calib' and 'static' (JAX
    rebuilds the module with the other `quant`; the variables are the
    same).  Dynamic sites hold no stats and raise."""
    if mode not in ("calib", "static"):
        raise ValueError(f"set_quant_mode switches between 'calib' and 'static', not {mode!r}")
    for name, m in quant_sites(module).items():
        if m.quant_mode == "dynamic":
            raise ValueError(f"{name} is a dynamic quant site: it has no calibrated stats")
        m.quant_mode = mode
        m.refresh_static_operands()
    return module


def calibrate(module: nn.Module, batches: Iterable) -> nn.Module:
    """Run `batches` through a quant='calib' module in eval mode, so that
    every site's `act_absmax` holds the running max|x| over all of them
    (JAX models/quantize.py:81-101).  A batch is the module's input, or a
    tuple of its inputs (TwoStream: (rgb, flow)).  TF32 is off for the
    duration (cuDNN's default would move every later layer's recorded
    scale by about 1e-3) and restored after.  Returns the module."""
    if not any(m.quant_mode == "calib" for m in quant_sites(module).values()):
        raise ValueError("calibrate needs a module built with quant='calib'")
    ran = 0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for batch in batches:
                module(*(batch if isinstance(batch, tuple) else (batch,)))
                ran += 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if not ran:
        raise ValueError("calibrate ran zero batches")
    return module


def quantize_variables(module: nn.Module) -> nn.Module:
    """Bake int8 weights into every calibrated QuantConv (JAX
    models/quantize.py:104-129): `k8` and `sw` from its f32 weight.  The
    prestaged s2d stem derives its kernel and quantizes that itself, so it
    gets none.  Returns the module."""
    from .common import QuantConv, weight_qparams

    sites = [m for m in quant_sites(module).values() if m.quant_mode != "dynamic"]
    if not sites:
        raise ValueError("quantize_variables needs calibrated stats (build with quant='calib', then calibrate)")
    with torch.no_grad():
        for m in sites:
            if isinstance(m, QuantConv):
                m.k8, m.sw = weight_qparams(m.weight)
            m.refresh_static_operands()
    return module


def calibration_summary(module: nn.Module) -> Dict[str, float]:
    """{module path: act_absmax} of every calibrated site (JAX
    models/quantize.py:132-147): a view for spotting saturated or dead
    layers before deployment."""
    return {name: float(m.act_absmax) for name, m in quant_sites(module).items() if m.quant_mode != "dynamic"}
