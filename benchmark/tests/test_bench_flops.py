"""`benchmark/flops.py` against `torch.utils.flop_counter.FlopCounterMode`
over the program's own models (canonical stems; C3D and R3D on the meta
device, the I3D family on the CPU, whose max-pool op takes no meta
tensors): the count from shapes is the count of the convs and dense layers
the models run.  The test may build the program's models; the count may
not."""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from conftest import load

CASES = (("i3d_crowd11", "I3D", 32), ("hetero4x4_crowd11", "TWOSTREAM_I3D", 32),
         ("hetero4x4_crowd11", "C3D", 224), ("hetero4x4_crowd11", "R3D_18", 224),
         ("i3d_crowd11", "I3D", 224))


@pytest.mark.parametrize("config,family,size", CASES, ids=[f"{f}-{s}" for _, f, s in CASES])
def test_flops_match_the_counter(config, family, size):
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model

    cfg = copy.deepcopy(load("configs", config))
    cfg["size"] = size
    device = "meta" if family in ("C3D", "R3D_18") else "cpu"
    module = build_model(family, num_classes=cfg["classes"], device=device).module
    small = family in ("C3D", "R3D_18")
    t, s = (16, size // 2) if small else (cfg["frames"], size)
    args = [torch.zeros((1, t, s, s, 3), device=device)]
    if family == "TWOSTREAM_I3D":
        args.append(torch.zeros((1, t, s, s, 2), device=device))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        module(*args)
    assert flops.member_forward_flops(family, cfg) == counter.get_total_flops()


def test_published_i3d_count():
    """69.70 GFLOP a clip for one member at 20x224^2 (2 per MAC)."""
    assert flops.member_forward_flops("I3D", load("configs", "i3d_crowd11")) == 69_701_935_104
