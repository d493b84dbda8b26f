"""Serving export: the fused ensemble forward as one `torch.export` artifact.

Counterpart of `crowded_scenes_ensemble_classification_tpu/serving/export.py`
(lines 39-194).  The whole serving computation — uint8
batch → float → resize → × input_scale → members' dtype → every member's
forward → softmax → weighted SUM fusion → {"probs", "fused", "preds"} — is
one `torch.export.ExportedProgram` with a static batch size, as the JAX
export is.  Every family exports, in every input form the member forward
takes: TwoStream members with precomputed flow, or with gray pairs from
which the program computes Farnebäck flow (`flow_params`,
`flow_fast_warp`); dynamic and static int8 members.

Two forms, as there: the member weights baked into the program as its
state (the default), or `bake_params=False`, a lean program that takes
`(params, batch)` with `params` the members' state dicts stacked along a
leading member axis (`ensemble.members.stack_variables`), for deployments
that ship weights apart from the program.  A lean program holds no member
weights: its static-int8 sites pack their operands from the `params` of
each call.

The hand-written kernels are custom ops (`csec::*`, ops/kernels/), so the
exported graph calls them by name: loading an artifact needs this package
imported, which registers them, and their `.launches` counters count the
loaded program's launches too.  An artifact runs on the device type it was
exported on, recorded in its metadata.

Artifact = one zip: `module.pt2` (`torch.export.save`) + `metadata.json`.
Static-int8 members baked into a program carry their packed weights and
scales as constants (`models/common.QuantConv`).  The CLI's `export` and
`serve` commands write and read these artifacts.

The mesh form (`mesh=`, a (member G, data N) mesh, JAX export.py:86-140)
is lean: JAX records the SPMD shardings in its program, and a torch
program records no placement, so the program is one position's work —
(a member group's stacked params, a data shard of the batch) → that
group's probabilities on those rows — and the metadata carries the mesh
{"member": G, "data": N}.  `load_serving_artifact` builds the mesh over
the visible cards (positions cycle over them, so one card holds them all)
and its serve_fn(params, batch) runs the program at every position on its
slice of the stacked params and its rows (`ensemble.members.grid_forward`),
then fuses: the single-card artifact's result.
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.mesh import Mesh, make_mesh
from ..ensemble.members import (
    check_member_form,
    grid_forward,
    member_grid,
    member_softmax,
    stack_variables,
    stacked_member_softmax,
)
from ..models.quantize import static_holders
from ..models.registry import ModelBundle
from ..utils.device import resolve_device

_MODULE_NAME = "module.pt2"
_META_NAME = "metadata.json"


def serving_batch_example(
    bundle: ModelBundle,
    batch_size: int,
    serve_hw: Optional[Tuple[int, int]] = None,
    flow_precomputed: bool = True,
) -> Dict[str, torch.Tensor]:
    """The input batch the exported program takes: staged uint8 clips on
    the bundle's device (JAX export.py:39-59).  serve_hw defaults to the
    model's input size (the host resizes at decode); pass the staging size
    to move the resize into the artifact.  A two-stream bundle adds `flow`
    (B, T, H, W, 2), or with flow_precomputed=False the gray pairs `gray`
    and `gray_next` (B, T, H, W, 1) from which the program computes it."""
    h, w = serve_hw or (bundle.clip.height, bundle.clip.width)
    zeros = lambda c: torch.zeros((batch_size, bundle.clip.frames, h, w, c),  # noqa: E731
                                  dtype=torch.uint8, device=bundle.device)
    example = {"rgb": zeros(bundle.clip.rgb_channels)}
    if bundle.two_stream:
        if flow_precomputed:
            example["flow"] = zeros(bundle.clip.flow_channels)
        else:
            example["gray"], example["gray_next"] = zeros(1), zeros(1)
    return example


def _fuse(probs: torch.Tensor, weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    fused = torch.einsum("mbc,m->bc", probs, weights)
    return {"probs": probs, "fused": fused, "preds": torch.argmax(fused, dim=-1)}


class _ServingEnsemble(nn.Module):
    """The baked form: the members are submodules, their weights the
    program's state."""

    def __init__(self, members, weights, **forward_kw):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.forward_kw = forward_kw
        self.register_buffer("weights", weights)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return _fuse(member_softmax(self.members, batch, **self.forward_kw), self.weights)  # (M, B, C)


class _LeanServingEnsemble(nn.Module):
    """The lean form: one template of the members' architecture on the meta
    device, held outside the module tree, so nothing of it enters the
    program; each call runs it on the stacked `params`."""

    def __init__(self, template, weights, **forward_kw):
        super().__init__()
        self.template = (template,)  # a tuple: not a submodule
        self.forward_kw = forward_kw
        self.register_buffer("weights", weights)

    def forward(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return _fuse(stacked_member_softmax(self.template[0], params, batch, **self.forward_kw), self.weights)


class _LeanGroupForward(nn.Module):
    """The mesh form's program: a member group's softmax (M/G, B/N, C) on
    its stacked params and a data shard; the fusion runs after the
    groups' results are gathered."""

    def __init__(self, template, **forward_kw):
        super().__init__()
        self.template = (template,)  # a tuple: not a submodule
        self.forward_kw = forward_kw

    def forward(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return stacked_member_softmax(self.template[0], params, batch, **self.forward_kw)


def _meta_template(module: nn.Module) -> nn.Module:
    """A copy of `module` on the meta device, holding no static operands."""
    template = copy.deepcopy(module).to("meta")
    for site in static_holders(template):
        site.refresh_static_operands()  # meta sources: drops the held operands
    return template


def export_ensemble(
    members: Sequence[ModelBundle],
    batch_example: Dict[str, torch.Tensor],
    *,
    weights: Optional[np.ndarray] = None,
    input_scale: float = 1.0,
    share_stem_staging: bool = False,
    flow_fast_warp: bool = False,
    flow_params: Optional[dict] = None,
    bake_params: bool = True,
    mesh: Optional[Mesh] = None,
    member_axis: str = "member",
    data_axis: str = "data",
) -> torch.export.ExportedProgram:
    """Export the fused ensemble forward of `members` (one model type and
    clip geometry, on one device) for batches shaped like `batch_example`
    (`serving_batch_example`).

    It is `ensemble.members.make_member_forward`'s computation (members
    must be served at the scale they trained with; gray pairs go through
    Farnebäck with `flow_params` and `flow_fast_warp`) followed by weighted
    SUM fusion, ones by default.  share_stem_staging=True needs
    `stem_prestaged` members.  bake_params=False exports the lean program
    `(params, batch)`, `params` being `stack_variables` of the members'
    state dicts (JAX export.py:139-153).  With a `mesh` (the members must
    divide over its member axis, the example's batch over its data axis)
    the program is the mesh form's one position (module docstring), always
    lean; save it with metadata "mesh": {"member": G, "data": N} and the
    fusion weights as "fusion_weights", which `load_serving_artifact`
    reads."""
    first = members[0]
    if any(b.model_type != first.model_type or b.clip != first.clip for b in members):
        raise ValueError("export_ensemble: members must share model type and clip geometry")
    modules = [b.module for b in members]
    check_member_form(modules, share_stem_staging)
    w = torch.ones(len(members)) if weights is None else torch.as_tensor(weights, dtype=torch.float32)
    forward_kw = dict(out_hw=(first.clip.height, first.clip.width), share_stem_staging=share_stem_staging,
                      input_scale=input_scale, flow_fast_warp=flow_fast_warp, flow_params=flow_params)
    if mesh is not None:
        groups, shards = member_grid(mesh, len(members), member_axis, data_axis).shape
        batch = batch_example["rgb"].shape[0]
        if batch % shards:
            raise ValueError(f"a batch of {batch} does not divide over a {data_axis} axis of {shards}")
        model = _LeanGroupForward(_meta_template(first.module), **forward_kw)
        args = (stack_variables([m.state_dict() for m in modules[:len(modules) // groups]]),
                {k: v[:batch // shards] for k, v in batch_example.items()})
    elif bake_params:
        for site in (s for m in modules for s in static_holders(m)):
            site.refresh_static_operands()  # a static site's packed weights enter the program as constants
        model, args = _ServingEnsemble(modules, w.to(first.device), **forward_kw), (batch_example,)
    else:
        model = _LeanServingEnsemble(_meta_template(first.module), w.to(first.device), **forward_kw)
        args = (stack_variables([m.state_dict() for m in modules]), batch_example)
    with torch.no_grad():
        program = torch.export.export(model.eval(), args, strict=False)
    program.example_inputs = None  # else `torch.export.save` writes the example batch (and params) too
    return program


def save_serving_artifact(path: str, program: torch.export.ExportedProgram, metadata: Dict) -> str:
    """One deployable zip: the exported program + JSON metadata, to which
    the device type the program runs on is added."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    device = _program_device(program)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr(_MODULE_NAME, buf.getbuffer())
        z.writestr(_META_NAME, json.dumps({**metadata, "device": device}, indent=2, sort_keys=True))
    return path


def _program_device(program: torch.export.ExportedProgram) -> str:
    """The device type an exported program runs on: that of its fusion
    weights, else (the mesh form, which holds none) of its example inputs'
    placeholders."""
    if "weights" in program.state_dict:
        return program.state_dict["weights"].device.type
    vals = [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and "val" in n.meta]
    return next(v.device.type for v in vals if isinstance(v, torch.Tensor))


def _mesh_serve(module, metadata: Dict, device: torch.device):
    """serve_fn(params, batch) of a mesh artifact: the program at every
    position of a (member, data) mesh over `device`'s cards, each on its
    member group's params and its rows, then the fusion."""
    shape = metadata["mesh"]
    n = shape["member"] * shape["data"]
    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
             else [device])
    mesh = make_mesh((("member", shape["member"]), ("data", shape["data"])),
                     [cards[i % len(cards)] for i in range(n)])
    weights = torch.tensor(metadata["fusion_weights"], dtype=torch.float32)

    def serve(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        count = next(iter(params.values())).shape[0]
        grid = member_grid(mesh, count)
        per = count // grid.shape[0]
        slices = {}  # a member group's params on a device, moved once a call

        def run(g: int, d: int, rows: Dict) -> torch.Tensor:
            dev = grid[g, d]
            if (g, dev) not in slices:
                slices[(g, dev)] = {k: v[g * per:(g + 1) * per].to(dev) for k, v in params.items()}
            return module(slices[(g, dev)], {k: v.to(dev) for k, v in rows.items()})

        with torch.no_grad():
            probs = grid_forward(grid, batch, run)
            return _fuse(probs, weights.to(probs.device))

    return serve


def load_serving_artifact(path: str, device=None):
    """→ (serve_fn, metadata) on `device`: the card when None, which raises
    without one.  serve_fn(batch) → {"probs", "fused", "preds"} for a baked
    artifact, serve_fn(params, batch) for a lean one (JAX export.py:
    178-194) and for a mesh one, which runs over a mesh of metadata["mesh"]
    on `device`'s cards (module docstring).  The artifact must have been
    exported on that device type.  `serve_fn.module` is the loaded graph
    module.  Needs this package imported (it is, by this module), which
    registers the kernels' ops."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        metadata = json.loads(z.read(_META_NAME))
        if metadata["device"] != device.type:
            raise ValueError(f"artifact was exported for {metadata['device']}, asked to run on {device}")
        with z.open(_MODULE_NAME) as f:  # stored uncompressed, so seekable in place
            module = torch.export.load(f).module()

    def serve(*args: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return module(*args)

    if metadata.get("mesh"):
        serve = _mesh_serve(module, metadata, device)

    serve.module = module  # the loaded graph module, for inspection
    return serve, metadata
