"""Plain float32 training steps of one I3D member, for the training cell's
check.

One step: the rows' uint8 clips → the Crowd-11 augment (decisions drawn
from the step's generator) → × input_scale → the I3D forward with
BatchNorm on the biased batch statistics → Keras's class-weighted mean
cross-entropy, Σ ce·valid·w[label] / max(Σ valid, 1) → gradients → Keras
SGD in its velocity form, v ← momentum·v − lr·g, p ← p + v.  BatchNorm's
running statistics take no part in a training forward and are not
followed.  The blocks are rematerialised in the backward pass
(`torch.utils.checkpoint`), which changes no value, so that a 64-clip
float32 step fits beside nothing else on the card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import frontend, nets

STAT_SUFFIXES = (".running_mean", ".running_var")


def trainable(name: str) -> bool:
    return not name.endswith(STAT_SUFFIXES)


def train_steps(params0: Dict[str, torch.Tensor], steps: Sequence[Dict], config: dict, prec: nets.Precision,
                device) -> Dict:
    """Run `len(steps)` steps from `params0` (float32, any device).  A step
    is {"rgb": (B, T, H, W, 3) u8 rows, "label": (B,), "valid": (B,) bool,
    "decisions": `frontend.draw_decisions` of B clips}.  Returns {"loss":
    [float], "grad": {name: ‖g‖ of the first step}, "delta": {name: ‖p_n −
    p_0‖}} for the trainable leaves, norms in float64."""
    sizes, train = config["sizes"]["I3D"], config["train"]
    p = {k: v.detach().to(device, torch.float32).clone().requires_grad_(trainable(k)) for k, v in params0.items()}
    leaves = [k for k in p if trainable(k)]
    velocity = {k: torch.zeros_like(p[k]) for k in leaves}
    class_weights = torch.as_tensor(train["class_weights"], dtype=torch.float32, device=device)
    out: Dict = {"loss": [], "grad": {}, "delta": {}}
    for i, step in enumerate(steps):
        rgb = step["rgb"].to(device).float()
        rows = torch.arange(rgb.shape[0])
        x = frontend.augment(rgb, tuple(train["out_hw"]), step["decisions"], rows) * train["input_scale"]
        del rgb
        labels = step["label"].to(device).long()
        mask = step["valid"].to(device).float()
        logits = nets.i3d_logits(p, x, sizes, prec, train=True, checkpoint=True)
        ce = F.cross_entropy(logits, labels, reduction="none")
        loss = (ce * mask * class_weights[labels]).sum() / mask.sum().clamp_min(1.0)
        grads = torch.autograd.grad(loss, [p[k] for k in leaves])
        out["loss"].append(loss.item())
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                if i == 0:
                    out["grad"][k] = float(g.double().norm())
                velocity[k].mul_(train["momentum"]).add_(g, alpha=-train["lr"])
                p[k].add_(velocity[k])
        del x, logits, ce, loss, grads
    with torch.no_grad():
        for k in leaves:
            out["delta"][k] = float((p[k].double() - params0[k].to(device).double()).norm())
    return out


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float], leaves: List[str]) -> float:
    """max over `leaves` of |‖program‖ − ‖reference‖| / max(‖reference‖,
    the median leaf's ‖reference‖)."""
    ref = torch.tensor([reference[k] for k in leaves], dtype=torch.float64)
    floor = float(ref.median())
    return max(abs(program[k] - reference[k]) / max(reference[k], floor) for k in leaves)


def median_leaf_gap(program: Dict[str, float], reference: Dict[str, float], leaves: List[str]) -> float:
    """|‖program‖ − ‖reference‖| / ‖reference‖ of the leaf whose reference
    norm is the median's."""
    k = sorted(leaves, key=lambda name: reference[name])[len(leaves) // 2]
    return abs(program[k] - reference[k]) / reference[k]


def moved_leaves(reference_grad: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose first reference gradient is at least `share` of the
    median leaf's: the others move by round-off alone."""
    floor = share * float(torch.tensor(list(reference_grad.values()), dtype=torch.float64).median())
    return [k for k, g in reference_grad.items() if g >= floor]
