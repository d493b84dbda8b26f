"""Experiment orchestration: the reference's five stages from one Python API.

Counterpart of `crowded_scenes_ensemble_classification_tpu/orchestration.py`
(lines 1-972).  The reference fanned out k·(k−1) single-GPU Slurm jobs per
ensemble (launch_train_ensemble.py:88-158) and passed artifacts between
stages through its filesystem naming protocol; one controller drives them
here, with the same names string for string:

- `prepare_ensemble`: folds (if missing) → offline augmentation (on the
  card, through the noise kernel) → split matrix → artifact dirs + manifest;
- `train_member`: one (test, val) member, fit → test eval → history
  artifact (the reference's train.py main, train.py:1978-2051);
- `launch_ensemble_training`: every member in this process with one train
  and one eval step shared, or the CLI command list for external schedulers;
- `cache_probabilities` and `make_prob_provider`: the probability store
  (reference store_probabilities, evaluate_ensemble.py:1002-1109) feeding
  `ensemble.evaluate`, in the compute dtype, int8 (dynamic, static, the
  mixed and custom I3D policies) and long-video forms.

The port's idiom: clip tables are `data.ClipTable`s, a module holds its
weights (members are modules, checkpoints `train.checkpoints`'s state
dicts), and every entry point runs on the card unless `device=` names
another.  Two arguments have no working form yet and raise: `mesh=`
(ROADMAP Queue 1 item 7) and `fuse_1x1=True` (left out, item 8).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.config import ExperimentConfig, member_val_indices, split_pairs
from .core.manifest import ArtifactRecord, Manifest
from .data.augment_offline import augment_folds
from .data.folds import generate_folds
from .data.pipeline import BatchPipeline, SampleSpec, expand_precomputed_augmentation
from .data.splits import load_fold_csvs, split_dir_name, write_split_matrix
from .data.table import ClipTable, concat
from .ensemble.members import calibrate_members, member_probabilities
from .ensemble.probability_store import (
    import_reference_csv,
    load_probabilities,
    probabilities_exist,
    probability_cache_path,
    save_probabilities,
)
from .flow.farneback import flow_schedule_params
from .models.pretrained import build_with_condition
from .models.quantize import MIXED_INT8_POLICY, resolve_quant_blocks
from .models.registry import ModelBundle, build_model
from .train.checkpoints import best_exists, restore_best
from .train.engine import (
    evaluate_model,
    fit,
    make_eval_step,
    make_resident_train_step,
    make_train_step,
    store_history,
    train_policy,
)
from .utils.device import resolve_device
from .utils.metrics import MetricsLogger

DEFAULT_STAGING_HW = (256, 256)
CLI_MODULE = "crowded_scenes_ensemble_classification_tpu_torch"


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("mesh= is not ported yet: the port runs on one card (ROADMAP Queue 1 item 7)")


def compute_dtype(config: ExperimentConfig) -> torch.dtype:
    """The torch dtype `config.compute_dtype` names ('bfloat16', 'float32')."""
    dtype = getattr(torch, config.compute_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"compute_dtype {config.compute_dtype!r} is not a torch dtype")
    return dtype


@dataclasses.dataclass
class WorkLayout:
    """Directory layout of one experiment workspace (JAX orchestration.py:52-97)."""

    root: str

    @property
    def folds_dir(self) -> str:
        return os.path.join(self.root, "Folds")

    @property
    def splits_dir(self) -> str:
        return os.path.join(self.root, "Splits")

    @property
    def augmented_dir(self) -> str:
        return os.path.join(self.root, "Augmented_data")

    @property
    def models_dir(self) -> str:
        return os.path.join(self.root, "Trained_models")

    @property
    def probs_dir(self) -> str:
        return os.path.join(self.root, "Probabilities")

    @property
    def results_dir(self) -> str:
        return os.path.join(self.root, "Results")

    def checkpoint_dir(self, config: ExperimentConfig, t: int, v: int) -> str:
        return os.path.join(self.models_dir, config.weights_relpath(t, v))

    def history_path(self, config: ExperimentConfig, t: int, v: int) -> str:
        return os.path.join(self.models_dir, config.history_relpath(t, v))

    def split_csv(self, t: int, v: int, name: str) -> str:
        return os.path.join(self.splits_dir, split_dir_name(t, v), f"{name}.csv")

    def experiment_json(self, config: ExperimentConfig) -> str:
        """The saved ExperimentConfig of one subfolder, so a workspace holding
        several architectures keeps each one's input_scale for later stages."""
        return os.path.join(self.models_dir, config.subfolder_name(), "experiment.json")


def prepare_ensemble(
    config: ExperimentConfig,
    clip_table: Optional[ClipTable],
    work_dir: str,
    seed: int = 0,
    device=None,
) -> WorkLayout:
    """Folds → (optional) offline augmentation on `device` (the card when
    None; resolved only if a clip is encoded) → splits → dirs + manifest."""
    layout = WorkLayout(work_dir)
    folds_subdir = os.path.join(layout.folds_dir, f"{config.folds_number}_folds")

    if not os.path.exists(os.path.join(folds_subdir, "fold0.csv")):
        if clip_table is None:
            raise FileNotFoundError(f"no folds at {folds_subdir} and no clip_table to generate them")
        generate_folds(clip_table, layout.folds_dir, config.folds_number)

    if config.augmentation_status == "augmented_precomputed":
        augment_folds(folds_subdir, layout.augmented_dir, config.folds_number, config.augmentation_frequency,
                      seed=seed, device=device)

    write_split_matrix(load_fold_csvs(folds_subdir, config.folds_number), layout.splits_dir)

    # pre-create the TestSplit dirs (sortOut_future_trainedModels semantics)
    for t in range(config.folds_number):
        os.makedirs(os.path.join(layout.models_dir, config.subfolder_name(), f"TestSplit{t}"), exist_ok=True)

    manifest = Manifest(work_dir, config)
    for i in range(config.folds_number):
        manifest.add(
            ArtifactRecord(
                kind="fold_csv",
                path=os.path.relpath(os.path.join(folds_subdir, f"fold{i}.csv"), work_dir),
                test_index=i,
                fmt="csv",
            ),
            save=False,
        )
    manifest.save()
    config.save(layout.experiment_json(config))
    return layout


def _read_split(layout: WorkLayout, t: int, v: int, name: str) -> ClipTable:
    return ClipTable.read_csv(layout.split_csv(t, v, name))


def _sample_spec(config: ExperimentConfig, staging_hw, num_frames: Optional[int] = None) -> SampleSpec:
    return SampleSpec(
        num_frames=num_frames or config.clip.frames,
        staging_hw=staging_hw,
        two_stream=config.is_two_stream,
        flow_precomputed=(config.optical_flow_status == "TVL1_precomputed"),
    )


def _pipelines_for_split(
    config: ExperimentConfig,
    layout: WorkLayout,
    t: int,
    v: int,
    staging_hw=DEFAULT_STAGING_HW,
    num_workers: int = 8,
) -> Dict[str, BatchPipeline]:
    spec = _sample_spec(config, staging_hw)
    out = {}
    for name in ("train", "val", "test"):
        table = _read_split(layout, t, v, name)
        if name == "train" and config.augmentation_status == "augmented_precomputed":
            table = expand_precomputed_augmentation(table, config.augmentation_frequency)
        out[name] = BatchPipeline(
            table,
            spec,
            batch_size=config.batch_size,
            shuffle=(name == "train"),
            # deterministic across processes (Python's hash() is salted)
            seed=zlib.crc32(f"{t}/{v}/{name}".encode()) % (2**31),
            num_workers=num_workers,
        )
    return out


def train_member(
    config: ExperimentConfig,
    layout: WorkLayout,
    t: int,
    v: int,
    *,
    mesh=None,
    epochs: Optional[int] = None,
    seed: int = 0,
    input_scale: Optional[float] = None,
    bundle: Optional[ModelBundle] = None,
    initial_variables: Optional[Dict[str, torch.Tensor]] = None,
    verbose: bool = False,
    num_workers: int = 8,
    optimizer=None,
    staging_hw=DEFAULT_STAGING_HW,
    rgb_h5=None,
    flow_h5=None,
    train_step=None,
    eval_step=None,
    resident: bool = False,
    resident_pad_to: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """One ensemble member end to end: fit → test eval → history artifact
    (reference train.py main, :1978-2051; JAX orchestration.py:185-333).

    The member starts from fresh weights drawn from `seed + 1000·t + v`: a
    trainable bundle of the config's model in `config.compute_dtype` on
    `device` (`models.pretrained.build_with_condition`, which loads
    rgb_h5/flow_h5 for _PRETRAINED, from `seed` as in JAX), or the given
    `bundle` loaded with the weights of a _SCRATCH build from the member's
    seed (the bundle=None path's start; in JAX `fit` inits from it), or
    `initial_variables`.  train_step/eval_step: steps shared across
    members (`launch_ensemble_training`), closing over `bundle` and built
    with `optimizer`.  resident=True pins the train split on the bundle's
    device once (`data.resident.ResidentClips`), so every epoch gathers its
    batches there; val and test stream through the pipelines.
    input_scale=None reads config.input_scale."""
    _no_mesh(mesh)
    if input_scale is None:
        input_scale = config.input_scale
    member_seed = seed + 1000 * t + v
    if bundle is None:
        pretrained = config.training_condition == "_PRETRAINED"
        bundle, _ = build_with_condition(config, seed=seed if pretrained else member_seed, rgb_h5=rgb_h5,
                                         flow_h5=flow_h5, dtype=compute_dtype(config), device=device)
    elif initial_variables is None:
        scratch = dataclasses.replace(config, training_condition="_SCRATCH")
        _, initial_variables = build_with_condition(scratch, seed=member_seed, dtype=compute_dtype(config),
                                                    device=bundle.device)
    flow_params = flow_schedule_params(config.flow_schedule)
    out_hw = (bundle.clip.height, bundle.clip.width)
    pipes = _pipelines_for_split(config, layout, t, v, staging_hw=staging_hw, num_workers=num_workers)
    if resident:
        from .data.resident import ResidentClips

        pipes["train"] = ResidentClips.from_pipeline(pipes["train"], preshuffle=seed, pad_to=resident_pad_to,
                                                     device=bundle.device)
    if eval_step is None:
        # one eval step for fit's epochs and the final test eval
        eval_step = make_eval_step(bundle, out_hw, input_scale=input_scale, flow_params=flow_params)
    ckpt_dir = layout.checkpoint_dir(config, t, v)
    metrics_logger = MetricsLogger(os.path.join(layout.root, "metrics", f"{config.artifact_stem(t, v)}.jsonl"))

    result = fit(
        bundle,
        pipes["train"],
        pipes["val"],
        epochs=epochs if epochs is not None else config.epochs,
        seed=member_seed,
        augment=(config.augmentation_status == "augmented_onTheFly"),
        augment_p=0.75,  # on-the-fly probability (train.py:177)
        balanced_classes=(config.classes_status == "balanced"),
        checkpoint_dir=ckpt_dir,
        initial_variables=initial_variables,
        input_scale=input_scale,
        verbose=verbose,
        optimizer=optimizer,
        metrics_logger=metrics_logger,
        train_step=train_step,
        eval_step=eval_step,
        flow_from_augmented=config.flow_from_augmented,
        flow_params=flow_params,
    )

    restore_best(ckpt_dir, bundle.module)
    test = evaluate_model(bundle, pipes["test"], out_hw, input_scale=input_scale, flow_params=flow_params,
                          eval_step=eval_step)
    store_history(result["history"], layout.history_path(config, t, v))
    metrics_logger.log(
        "member_done",
        test_index=t,
        val_index=v,
        test_loss=test["loss"],
        test_accuracy=test["accuracy"],
        best_val_loss=result["best_val_loss"],
    )
    return {
        "history": result["history"],
        "best_val_loss": result["best_val_loss"],
        "test_loss": test["loss"],
        "test_accuracy": test["accuracy"],
        "checkpoint_dir": ckpt_dir,
    }


def _step_policy(config: ExperimentConfig, optimizer=None):
    """(optimizer factory, l2 weight, on-the-fly augment flag): the model's
    optimizer at its LR policy's initial rate unless given, the R3D l2 rule
    (`train.engine.train_policy`), and whether the config augments on the
    fly (JAX orchestration.py:336-350)."""
    tx, l2w = train_policy(config.model_type, optimizer)
    return tx, l2w, config.augmentation_status == "augmented_onTheFly"


def member_is_complete(config: ExperimentConfig, layout: WorkLayout, t: int, v: int) -> bool:
    """True iff member (t, v) finished `train_member`: the completion marker
    is the pair (best checkpoint, history artifact), since the history is
    stored after the test eval at the very end (JAX orchestration.py:353-367)."""
    return best_exists(layout.checkpoint_dir(config, t, v)) and os.path.exists(layout.history_path(config, t, v))


def pending_members(config: ExperimentConfig, layout: WorkLayout) -> List[Tuple[int, int]]:
    """The (test, val) members with no complete artifact pair: what a
    recovery run must (re-)train."""
    return [(t, v) for t, v in split_pairs(config.folds_number) if not member_is_complete(config, layout, t, v)]


def member_cli_commands(
    config: ExperimentConfig,
    work_dir: str,
    rgb_h5: Optional[str] = None,
    flow_h5: Optional[str] = None,
    resident: bool = False,
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
) -> List[str]:
    """One CLI command per (t, v) member, for external schedulers (reference
    launch_train_ensemble.py:144-158): JAX orchestration.py:384-429's
    commands with this package's module name.  The package's `__main__` and
    its `train` command come with the port's CLI (ROADMAP Queue 1 item 6).

    pairs — restrict to these (test, val) members (recovery runs pass the
    pending set so completed members are not re-queued)."""
    cmds = []
    for t, v in split_pairs(config.folds_number) if pairs is None else pairs:
        cmd = (
            f"python -m {CLI_MODULE} train"
            f" --work-dir {work_dir}"
            f" --model-type {config.model_type}"
            f" --training-condition {config.training_condition}"
            f" --folds-number {config.folds_number}"
            f" --test-index {t} --val-index {v}"
            f" --augmentation-status {config.augmentation_status}"
            f" --optical-flow-status {config.optical_flow_status}"
            f" --classes-status {config.classes_status}"
            f" --augmentation-frequency {config.augmentation_frequency}"
            f" --num-classes {config.num_classes}"
            f" --batch-size {config.batch_size}"
            f" --epochs {config.epochs}"
        )
        if config.input_scale != 1.0:
            cmd += f" --input-scale {config.input_scale}"
        if config.flow_from_augmented:
            cmd += " --flow-from-augmented"
        if config.flow_schedule != "full":
            cmd += f" --flow-schedule {config.flow_schedule}"
        if rgb_h5:
            cmd += f" --rgb-h5 {rgb_h5}"
        if flow_h5:
            cmd += f" --flow-h5 {flow_h5}"
        if resident:
            cmd += " --resident"
        cmds.append(cmd)
    return cmds


def _process_count_index() -> Tuple[int, int]:
    """(processes, this process's rank) of an initialised torch.distributed
    group, else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def launch_ensemble_training(
    config: ExperimentConfig,
    clip_table: Optional[ClipTable],
    work_dir: str,
    runner: str = "local",
    members: Optional[Sequence[Tuple[int, int]]] = None,
    recover: bool = False,
    **member_kwargs,
) -> Any:
    """Prepare + train the k·(k−1) members (JAX orchestration.py:432-588).

    runner='local'    — in this process, one member after another;
    runner='commands' — return the CLI command list (external fan-out).

    members — restrict to these (test, val) pairs.  recover=True — train
    (or emit commands for) only the members with no complete (checkpoint,
    history) pair; with `members` None and a torch.distributed group up,
    the pending list is divided round-robin over its processes.
    One trainable bundle and one train and one eval step are built and
    shared by every member (each member loads a seeded build's weights), unless the
    caller passes `bundle` or `train_step`.  member_kwargs go to
    `train_member`; `device` also to `prepare_ensemble`."""
    if runner not in ("local", "commands"):
        raise ValueError(f"runner {runner!r} not in ('local', 'commands')")
    _no_mesh(member_kwargs.get("mesh"))
    layout = prepare_ensemble(config, clip_table, work_dir, device=member_kwargs.get("device"))
    if runner == "commands":
        return member_cli_commands(
            config,
            work_dir,
            rgb_h5=member_kwargs.get("rgb_h5"),
            flow_h5=member_kwargs.get("flow_h5"),
            resident=member_kwargs.get("resident", False),
            pairs=pending_members(config, layout) if recover else None,
        )

    if recover:
        pend = pending_members(config, layout)
        if members is None:
            n, p = _process_count_index()
            pairs = [pair for i, pair in enumerate(pend) if i % n == p]
        else:
            pend_set = set(pend)
            pairs = [tuple(pair) for pair in members if tuple(pair) in pend_set]
    else:
        pairs = [tuple(p) for p in members] if members is not None else split_pairs(config.folds_number)
    if not pairs:
        return {}

    if "train_step" not in member_kwargs and member_kwargs.get("bundle") is None:
        seed = member_kwargs.get("seed", 0)
        bundle, fresh = build_with_condition(
            config, seed=seed, rgb_h5=member_kwargs.get("rgb_h5"), flow_h5=member_kwargs.get("flow_h5"),
            dtype=compute_dtype(config), device=member_kwargs.get("device"))
        out_hw = (bundle.clip.height, bundle.clip.width)
        input_scale = member_kwargs.get("input_scale")
        if input_scale is None:
            input_scale = config.input_scale
        tx, l2w, augment_flag = _step_policy(config, member_kwargs.get("optimizer"))
        flow_params = flow_schedule_params(config.flow_schedule)
        make_train = make_resident_train_step if member_kwargs.get("resident") else make_train_step
        member_kwargs.update(
            bundle=bundle,
            optimizer=tx,
            train_step=make_train(bundle, tx, out_hw, augment=augment_flag, augment_p=0.75, l2_weight=l2w,
                                  input_scale=input_scale, flow_from_augmented=config.flow_from_augmented,
                                  flow_params=flow_params),
            eval_step=make_eval_step(bundle, out_hw, input_scale=input_scale, flow_params=flow_params),
        )
        if config.training_condition == "_PRETRAINED" and member_kwargs.get("initial_variables") is None:
            # every member starts from the checkpoint (its heads from `seed`)
            member_kwargs["initial_variables"] = {k: v.clone() for k, v in fresh.items()}

    if member_kwargs.get("resident") and member_kwargs.get("resident_pad_to") is None:
        # pad every member's resident train split to the largest split's size
        def _train_rows(t: int, v: int) -> int:
            table = _read_split(layout, t, v, "train")
            if config.augmentation_status == "augmented_precomputed":
                table = expand_precomputed_augmentation(table, config.augmentation_frequency)
            return len(table)

        member_kwargs["resident_pad_to"] = max(_train_rows(t, v) for t, v in split_pairs(config.folds_number))

    return {(t, v): train_member(config, layout, t, v, **member_kwargs) for t, v in pairs}


# ----------------------------------------------------------------------
# Probability store orchestration
# ----------------------------------------------------------------------


def _member_variables(
    config: ExperimentConfig, layout: WorkLayout, module: torch.nn.Module, t: int
) -> Tuple[List[Dict[str, torch.Tensor]], List[str]]:
    """The best checkpoints of test fold t's k−1 members, each loaded
    strictly into `module` (a module of the members' architecture) to check
    it, and their artifact stems (JAX orchestration.py:596-609)."""
    variables, names = [], []
    for v in member_val_indices(config.folds_number, t):
        ckpt = layout.checkpoint_dir(config, t, v)
        if not best_exists(ckpt):
            raise FileNotFoundError(f"missing checkpoint {ckpt}")
        variables.append(restore_best(ckpt, module))
        names.append(config.artifact_stem(t, v))
    return variables, names


def probability_variant(
    config: ExperimentConfig,
    long_video: bool = False,
    window_stride: Optional[int] = None,
    long_frames: Optional[int] = None,
    quant=False,
    quant_blocks=None,
) -> Tuple[str, Optional[Tuple[str, ...]], Optional[int], Optional[int]]:
    """(npz variant suffix, resolved quant-block policy, long frames, window
    stride) of a `cache_probabilities` request (JAX orchestration.py:
    681-712): `_long{T}s{stride}`, then `_int8` or `_int8static`, then
    `-mixed` or `-c{n}x{crc32 % 0xFFFF:04x}` for an I3D block policy."""
    policy = None
    if quant_blocks is not None:
        if "I3D" not in config.model_type:
            raise ValueError("quant_blocks is an I3D-family policy")
        if quant != "static":
            raise ValueError("quant_blocks requires quant='static'")
        policy = resolve_quant_blocks(quant_blocks)
    variant = ""
    if long_video:
        if config.is_two_stream:
            raise ValueError("long-video probability caching is RGB-only")
        long_frames = long_frames or 4 * config.clip.frames
        window_stride = window_stride or max(config.clip.frames // 2, 1)
        variant = f"_long{long_frames}s{window_stride}"
    if quant:
        variant += "_int8static" if quant == "static" else "_int8"
        if policy is not None:
            if policy == tuple(sorted(MIXED_INT8_POLICY)):
                variant += "-mixed"
            else:
                # stable across processes (hash() is seed-salted)
                digest = zlib.crc32(",".join(policy).encode()) % 0xFFFF
                variant += f"-c{len(policy)}x{digest:04x}"
    return variant, policy, long_frames, window_stride


def _subset_table(layout: WorkLayout, config: ExperimentConfig, t: int, subset: str) -> ClipTable:
    """The clips of `subset` for test fold t: the test split, or train then
    val (evaluate_ensemble.py:1079-1108); any val index reads them."""
    v0 = member_val_indices(config.folds_number, t)[0]
    if subset == "test":
        return _read_split(layout, t, v0, "test")
    if subset == "train_val":
        return concat([_read_split(layout, t, v0, "train"), _read_split(layout, t, v0, "val")])
    raise ValueError(f"unknown subset {subset!r}")


def cache_probabilities(
    config: ExperimentConfig,
    layout: WorkLayout,
    t: int,
    subset: str = "test",
    mesh=None,
    bundle: Optional[ModelBundle] = None,
    num_workers: int = 8,
    recompute: bool = False,
    staging_hw=DEFAULT_STAGING_HW,
    long_video: bool = False,
    window_stride: Optional[int] = None,
    long_frames: Optional[int] = None,
    input_scale: Optional[float] = None,
    quant=False,
    quant_blocks=None,
    fuse_1x1: bool = False,
    device=None,
) -> str:
    """(M, N, C) member probabilities of test fold t → npz cache; returns
    its path (JAX orchestration.py:612-805).  subset='train_val' is train
    then val.  An existing cache is returned unless `recompute`.

    The members are modules of the config's model in `config.compute_dtype`
    on `device` (the card when None), I3D-family ones `stem_prestaged` (one
    shared s2d staging a batch, `ensemble.members.member_probabilities`),
    each loaded from its best checkpoint; or copies of `bundle.module`
    (then `quant` does not apply, as in JAX).  input_scale=None reads
    config.input_scale, the scale the members trained with.

    long_video=True stages `long_frames` frames a clip (4× the window by
    default) and averages the softmax of `window_stride`-strided windows
    (`parallel.streaming`); RGB only.  quant=True or 'dynamic' runs int8
    convs with per-call scales; quant='static' calibrates the members on
    the subset's first 2 batches of model-window clips
    (`calibrate_members`) and bakes int8 weights; quant_blocks (I3D family,
    static only: 'mixed' or a comma list) limits int8 to those sites.  Each
    form has its own npz path (`probability_variant`).  fuse_1x1=True (the
    JAX fused 1×1 convs) is left out of the port (ROADMAP Queue 1 item 8)."""
    _no_mesh(mesh)
    if fuse_1x1:
        raise ValueError("fuse_1x1 is not ported: the fused 1x1x1 convs are left out (ROADMAP Queue 1 item 8)")
    if input_scale is None:
        input_scale = config.input_scale
    flow_params = flow_schedule_params(config.flow_schedule)
    variant, policy, long_frames, window_stride = probability_variant(
        config, long_video, window_stride, long_frames, quant, quant_blocks)
    path = probability_cache_path(layout.probs_dir, config.subfolder_name(), t, subset, variant=variant)
    if probabilities_exist(path) and not recompute:
        return path

    table = _subset_table(layout, config, t, subset)
    pipe = BatchPipeline(table, _sample_spec(config, staging_hw, long_frames if long_video else None),
                         batch_size=config.batch_size, shuffle=False, num_workers=num_workers)
    if bundle is not None:
        clip = bundle.clip
        template = bundle.module
        variables, names = _member_variables(config, layout, template, t)
        members = [copy.deepcopy(template) for _ in variables]
        for m, state in zip(members, variables):
            m.load_state_dict(state)
        quant = False
    else:
        clip = config.clip
        kw = {"stem_prestaged": True} if "I3D" in config.model_type else {}
        build = lambda q: build_model(config.model_type, config.num_classes, dtype=compute_dtype(config),  # noqa: E731
                                      device=resolve_device(device), quant=q, quant_blocks=policy, **kw)
        members = [build("calib" if quant == "static" else quant).module
                   for _ in member_val_indices(config.folds_number, t)]
        variables, names = _member_variables(config, layout, members[0], t)
        for m, state in zip(members, variables):
            m.load_state_dict(state)
    out_hw = (clip.height, clip.width)
    if quant == "static":
        # calibrate on model-window clips of the same subset (a long-video
        # pipeline's clips do not fit the model)
        calib_pipe = pipe
        if long_video:
            calib_pipe = BatchPipeline(table, _sample_spec(config, staging_hw), batch_size=config.batch_size,
                                       shuffle=False, num_workers=num_workers)
        members = calibrate_members(members, calib_pipe, out_hw, input_scale=input_scale, flow_params=flow_params)
    if long_video:
        from .parallel.streaming import streaming_member_probabilities_over_pipeline

        probs = streaming_member_probabilities_over_pipeline(members, pipe, out_hw, clip.frames,
                                                             stride=window_stride, input_scale=input_scale)
    else:
        probs = member_probabilities(members, pipe, out_hw, input_scale=input_scale, flow_params=flow_params)
    save_probabilities(path, probs, np.asarray(table["class"], np.int64), names)
    return path


def make_prob_provider(
    config: ExperimentConfig, layout: WorkLayout, mesh=None, **kwargs
) -> Callable[[int, str], Dict[str, np.ndarray]]:
    """ProbProvider for `ensemble.evaluate`: computes and caches on a miss
    (reference auto-compute at evaluate_ensemble.py:1161-1174)."""
    _no_mesh(mesh)

    def provider(t: int, subset: str) -> Dict[str, np.ndarray]:
        return load_probabilities(cache_probabilities(config, layout, t, subset, **kwargs))

    return provider


def min_val_losses_provider(config: ExperimentConfig, layout: WorkLayout) -> Callable[[int], List[float]]:
    """Per-member min val-loss reader for VALIDATION_ERROR_INVERSE
    (reference get_modeltraining_validation_loss, evaluate_ensemble.py:33-62)."""

    def provider(t: int) -> List[float]:
        return [float(np.min(np.load(layout.history_path(config, t, v))))
                for v in member_val_indices(config.folds_number, t)]

    return provider


# ----------------------------------------------------------------------
# Global (heterogeneous) ensemble config resolution
# ----------------------------------------------------------------------

# The reference's SPECIALCASE alias: TwoStream-I3D pretrained, Farnebäck on
# the fly, augmented ×3 (evaluate_ensemble.py:155-177, :1365-1386).
SPECIALCASE_CONFIG = dict(
    model_type="TWOSTREAM_I3D",
    training_condition="_PRETRAINED",
    optical_flow_status="FarneBack_onTheFly",
    augmentation_status="augmented_precomputed",
    augmentation_frequency=3,
    classes_status="unbalanced",
)


def parse_global_model_specs(
    specs: Sequence[str],
    folds_number: int = 5,
    num_classes: int = 11,
    base: Optional[ExperimentConfig] = None,
) -> Dict[str, ExperimentConfig]:
    """'{MODEL}{_COND}' strings (reference launch_evaluate_ensemble.sh:23) →
    named ExperimentConfigs; SPECIALCASE_* expands to the augmented
    TwoStream run."""
    base = base or ExperimentConfig(folds_number=folds_number, num_classes=num_classes)
    out: Dict[str, ExperimentConfig] = {}
    for spec in specs:
        if spec.startswith("SPECIALCASE"):
            out[spec] = dataclasses.replace(base, **SPECIALCASE_CONFIG)
            continue
        for cond in ("_PRETRAINED", "_SCRATCH"):
            if spec.endswith(cond):
                out[spec] = dataclasses.replace(base, model_type=spec[: -len(cond)], training_condition=cond)
                break
        else:
            raise ValueError(f"cannot parse model spec {spec!r}")
    return out


def global_prob_providers(
    specs: Sequence[str],
    work_dir: str,
    folds_number: int = 5,
    num_classes: int = 11,
    mesh=None,
    **kwargs,
) -> Dict[str, Callable]:
    """Named ProbProviders over several architecture configs sharing one
    workspace; each config takes the input_scale its members trained with
    from its subfolder's experiment.json when one exists."""
    _no_mesh(mesh)
    layout = WorkLayout(work_dir)
    out = {}
    for name, cfg in parse_global_model_specs(specs, folds_number, num_classes).items():
        saved = layout.experiment_json(cfg)
        if os.path.exists(saved):
            cfg = dataclasses.replace(cfg, input_scale=ExperimentConfig.load(saved).input_scale)
        out[name] = make_prob_provider(cfg, layout, **kwargs)
    return out


def reference_probabilities_csv_name(config: ExperimentConfig, subset: str) -> str:
    """The reference's probability-cache CSV filename (lookFor_probabilitiesFile,
    evaluate_ensemble.py:1397-1410): `{subset}_predicted_probabilities_{subfolder}[_Freq{n}].csv`."""
    stem = config.subfolder_name()
    if config.augmentation_status == "augmented_precomputed":
        stem += f"_Freq{config.augmentation_frequency}"
    return f"{subset}_predicted_probabilities_{stem}.csv"


def prob_provider_from_reference_csvs(
    config: ExperimentConfig,
    layout: WorkLayout,
    results_folder: Optional[str] = None,
) -> Callable[[int, str], Dict[str, np.ndarray]]:
    """ProbProvider reading the reference's stringified-CSV probability
    caches, one CSV per (config, subset) holding every fold's member
    matrices keyed by trained-model path; fold t's members are the rows
    whose name holds `_split_test{t}_`.  Labels come from the split CSVs
    (evaluate_ensemble.py:1528-1545)."""
    folder = results_folder or layout.probs_dir

    def provider(t: int, subset: str) -> Dict[str, np.ndarray]:
        path = os.path.join(folder, reference_probabilities_csv_name(config, subset))
        data = import_reference_csv(path, config.num_classes)
        frag = f"_split_test{t}_"
        sel = [i for i, n in enumerate(data["member_names"]) if frag in n]
        if not sel:
            raise KeyError(f"no members for test fold {t} in {path}")
        table = _subset_table(layout, config, t, "test" if subset == "test" else "train_val")
        return {
            "probs": data["probs"][sel],
            "labels": np.asarray(table["class"], np.int64),
            "member_names": [data["member_names"][i] for i in sel],
        }

    return provider
