"""Serving export: the fused ensemble forward as one `torch.export` artifact.

Counterpart of `crowded_scenes_ensemble_classification_tpu/serving/export.py`
(lines 39-194), single-card form.  The whole serving computation — uint8
batch → float → resize → × input_scale → members' dtype → every member's
forward (weights baked in) → softmax → weighted SUM fusion →
{"probs", "fused", "preds"} — is one `torch.export.ExportedProgram` with a
static batch size, as the JAX export is.

The hand-written kernels are custom ops (`csec::*`, ops/kernels/), so the
exported graph calls them by name: loading an artifact needs this package
imported, which registers them, and their `.launches` counters count the
loaded program's launches too.  An artifact runs on the device type it was
exported on, recorded in its metadata.

Artifact = one zip: `module.pt2` (`torch.export.save`) + `metadata.json`.
Static-int8 members export with their packed weights and scales as
constants (`models/common.QuantConv`).  Not ported yet (ROADMAP Queue 1
item 2): TwoStream's flow inputs, `bake_params=False`, the mesh form, and
the CLI's `export`/`serve` commands.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ensemble.members import check_member_form, member_softmax
from ..models.quantize import quant_sites
from ..models.registry import ModelBundle
from ..utils.device import resolve_device

_MODULE_NAME = "module.pt2"
_META_NAME = "metadata.json"


def serving_batch_example(
    bundle: ModelBundle,
    batch_size: int,
    serve_hw: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """The input batch the exported program takes: staged uint8 clips on
    the bundle's device.  serve_hw defaults to the model's input size (the
    host resizes at decode); pass the staging size to move the resize into
    the artifact."""
    h, w = serve_hw or (bundle.clip.height, bundle.clip.width)
    shape = (batch_size, bundle.clip.frames, h, w, bundle.clip.rgb_channels)
    return {"rgb": torch.zeros(shape, dtype=torch.uint8, device=bundle.device)}


class _ServingEnsemble(nn.Module):
    def __init__(self, members, out_hw, share_stem_staging, input_scale, weights):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.out_hw, self.share, self.scale = tuple(out_hw), share_stem_staging, input_scale
        self.register_buffer("weights", weights)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        probs = member_softmax(self.members, batch, self.out_hw, self.share, self.scale)  # (M, B, C)
        fused = torch.einsum("mbc,m->bc", probs, self.weights)
        return {"probs": probs, "fused": fused, "preds": torch.argmax(fused, dim=-1)}


def export_ensemble(
    members: Sequence[ModelBundle],
    batch_example: Dict[str, torch.Tensor],
    *,
    weights: Optional[np.ndarray] = None,
    input_scale: float = 1.0,
    share_stem_staging: bool = False,
) -> torch.export.ExportedProgram:
    """Export the fused ensemble forward of `members` (one model type and
    clip geometry, on one device) for batches shaped like `batch_example`.

    It is `ensemble.members.make_member_forward`'s computation (members
    must be served at the scale they trained with) followed by weighted
    SUM fusion, ones by default.  share_stem_staging=True needs
    `stem_prestaged` members."""
    first = members[0]
    if any(b.model_type != first.model_type or b.clip != first.clip for b in members):
        raise ValueError("export_ensemble: members must share model type and clip geometry")
    modules = [b.module for b in members]
    check_member_form(modules, share_stem_staging)
    for site in (s for m in modules for s in quant_sites(m).values()):
        site.refresh_static_operands()  # a static site's packed weights enter the program as constants
    w = torch.ones(len(members)) if weights is None else torch.as_tensor(weights, dtype=torch.float32)
    model = _ServingEnsemble(
        modules, (first.clip.height, first.clip.width), share_stem_staging, input_scale,
        w.to(first.device),
    ).eval()
    with torch.no_grad():
        program = torch.export.export(model, (batch_example,), strict=False)
    program.example_inputs = None  # else `torch.export.save` writes the zeros batch too
    return program


def save_serving_artifact(path: str, program: torch.export.ExportedProgram, metadata: Dict) -> str:
    """One deployable zip: the exported program + JSON metadata, to which
    the device type the program runs on is added."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    device = next(iter(program.state_dict.values())).device.type
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr(_MODULE_NAME, buf.getbuffer())
        z.writestr(_META_NAME, json.dumps({**metadata, "device": device}, indent=2, sort_keys=True))
    return path


def load_serving_artifact(path: str, device=None):
    """→ (serve_fn(batch dict) → {"probs", "fused", "preds"}, metadata), on
    `device`: the card when None, which raises without one.  The artifact
    must have been exported on that device type.  `serve_fn.module` is the
    loaded graph module.  Needs this package imported (it is, by this
    module), which registers the kernels' ops."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        metadata = json.loads(z.read(_META_NAME))
        if metadata["device"] != device.type:
            raise ValueError(f"artifact was exported for {metadata['device']}, asked to run on {device}")
        with z.open(_MODULE_NAME) as f:  # stored uncompressed, so seekable in place
            module = torch.export.load(f).module()

    def serve(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return module(batch)

    serve.module = module  # the loaded graph module, for inspection
    return serve, metadata
