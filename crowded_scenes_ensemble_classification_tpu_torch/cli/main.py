"""Command-line interface of the port.

Counterpart of `crowded_scenes_ensemble_classification_tpu/cli/main.py`
(lines 1-981): the same 11 subcommands with the same flags, option for
option, mapped onto the reference's entry points (SURVEY.md §7.1.9):

  folds     — generate_folds.py
  augment   — augment_dataset.py (the augment policy on the card)
  launch    — launch_train_ensemble.py (prepare + fan-out)
  train     — train.py (one ensemble member)
  export    — the fused ensemble as a `torch.export` artifact
  serve     — classify a fold CSV with such an artifact
  probs     — evaluate_ensemble.py -op Store_models_probabilities
  ensemble  — evaluate_ensemble.py -op Evaluate_ensembles /
              Global_evaluate_models / Combine_ensembles
  report    — evaluate_ensemble.py -op Confusion_matrices /
              Difference_matrices / StickDiagrams…
  convert   — Keras h5 checkpoints → the port's `.pt` state dicts, and the
              checkpoint drill
  bench     — the clips/sec harness (not ported yet)

Every command runs on the card: `main` resolves it first and raises
without one.  Its `device` keyword, which no flag sets, lets tests name
"cpu".  `--mesh-data N` builds a data mesh of N positions cycling over the
visible cards (`core.mesh`; on one card all N sit on `cuda:0`): `train`
and `launch` train data-parallel over it (global-batch BatchNorm, a
resident split sharded over it) and `probs` shards the probabilities.
`--fuse-1x1` (I3D family) runs `probs`, `ensemble` and `export` with each
Inception block's input 1³ convs fused into one (`models.i3d.
InceptionBlock`), as the reference's does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..core.config import (
    AUGMENTATION_STATUSES,
    CLASSES_STATUSES,
    ExperimentConfig,
    MODEL_TYPES,
    OPTICAL_FLOW_STATUSES,
    TRAINING_CONDITIONS,
    WEIGHTING_SCHEMES,
)

PROG = "crowded_scenes_ensemble_classification_tpu_torch"


def _add_config_flags(p: argparse.ArgumentParser):
    p.add_argument("--model-type", "-mt", choices=MODEL_TYPES, default="C3D")
    p.add_argument(
        "--training-condition", "-tc", choices=TRAINING_CONDITIONS, default="_SCRATCH"
    )
    p.add_argument("--folds-number", "-fn", type=int, default=5)
    p.add_argument("--classes-status", "-cs", choices=CLASSES_STATUSES, default="unbalanced")
    p.add_argument(
        "--augmentation-status", "-as", choices=AUGMENTATION_STATUSES,
        default="non_augmented",
    )
    p.add_argument("--augmentation-frequency", "-af", type=int, default=1)
    p.add_argument(
        "--optical-flow-status", "-ofs", choices=OPTICAL_FLOW_STATUSES,
        default="FarneBack_onTheFly",
    )
    p.add_argument("--num-classes", type=int, default=11)
    p.add_argument("--batch-size", "-bs", type=int, default=16)
    p.add_argument("--epochs", "-e", type=int, default=100)
    p.add_argument(
        "--input-scale", type=float, default=None,
        help="pixel pre-scale for model inputs (default: the scale saved "
             "by launch/train for this config in the work dir, else 1.0 = "
             "reference parity raw 0-255 floats)",
    )
    p.add_argument(
        "--flow-from-augmented", action="store_true",
        help="augmented FarneBack_onTheFly runs: compute flow from the "
             "AUGMENTED frames (exact reference semantics, train.py:176-184"
             " — the SPECIALCASE TwoStream config); default computes flow "
             "from the unaugmented staged frames (see PARITY.md)",
    )
    p.add_argument(
        "--flow-schedule", choices=("full", "turbo"), default=None,
        help="Farnebäck iteration schedule on the card: 'full' = the "
             "reference's 5-iteration schedule (cv2 parity), 'turbo' = the "
             "EPE-gated adaptive schedule (default: the schedule saved by "
             "launch/train for this config in the work dir, else 'full')",
    )
    p.add_argument(
        "--mesh-data", type=int, default=None, metavar="N",
        help="shard batches (and resident datasets) over an N-position "
             "data mesh on the visible cards (positions cycle over them; "
             "-1 = one a card): train/launch train data-parallel over it, "
             "probs shards the probabilities; other subcommands ignore it",
    )


def _config_from_args(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model_type=args.model_type,
        training_condition=args.training_condition,
        folds_number=args.folds_number,
        classes_status=args.classes_status,
        augmentation_status=args.augmentation_status,
        augmentation_frequency=args.augmentation_frequency,
        optical_flow_status=args.optical_flow_status,
        num_classes=args.num_classes,
        batch_size=args.batch_size,
        epochs=args.epochs,
        input_scale=args.input_scale if args.input_scale is not None else 1.0,
        flow_from_augmented=getattr(args, "flow_from_augmented", False),
        flow_schedule=getattr(args, "flow_schedule", None) or "full",
    )
    flow_schedule_given = getattr(args, "flow_schedule", None) is not None
    if (args.input_scale is None or not flow_schedule_given) and getattr(
        args, "work_dir", None
    ):
        # Recover the scale/flow-schedule the members trained with:
        # launch/train persist the config per subfolder
        # (WorkLayout.experiment_json), so probs/ensemble/report can't
        # silently evaluate with different preprocessing.
        import dataclasses

        from ..orchestration import WorkLayout

        saved = WorkLayout(args.work_dir).experiment_json(cfg)
        if os.path.exists(saved):
            loaded = ExperimentConfig.load(saved)
            updates = {}
            if args.input_scale is None:
                updates["input_scale"] = loaded.input_scale
            if not flow_schedule_given:
                updates["flow_schedule"] = loaded.flow_schedule
            cfg = dataclasses.replace(cfg, **updates)
    return cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("folds", help="scene-stratified k-fold generation")
    p.add_argument("--dataset-directory", "-df", required=True)
    p.add_argument("--database-file", "-db", default=None)
    p.add_argument("--parent-folds-folder", "-pff", required=True)
    p.add_argument("--folds-number", "-fn", type=int, default=5)

    p = sub.add_parser("augment", help="offline (precomputed) augmentation, the "
                                       "policy on the card")
    p.add_argument("--folds-folder", required=True)
    p.add_argument("--augmented-data-folder", required=True)
    p.add_argument("--folds-number", "-fn", type=int, default=5)
    p.add_argument("--augmentation-frequency", "-af", type=int, default=1)
    p.add_argument(
        "--operation", choices=["augment_videos", "update_links"],
        default="augment_videos",
    )

    p = sub.add_parser("launch", help="prepare + train all ensemble members")
    _add_config_flags(p)
    p.add_argument("--work-dir", required=True)
    p.add_argument("--dataset-directory", "-df", default=None)
    p.add_argument("--database-file", "-db", default=None)
    p.add_argument("--runner", choices=["local", "commands"], default="local",
                   help="local: every member in this process, one train and "
                        "one eval step shared; commands: print one `train` "
                        "command a member for a scheduler")
    p.add_argument("--rgb-h5", default=None,
                   help="_PRETRAINED: Keras h5 or converted .pt (rgb)")
    p.add_argument("--flow-h5", default=None,
                   help="_PRETRAINED: Keras h5 (flow stream)")
    p.add_argument("--resident", action="store_true",
                   help="pin each split's staged clips in the card's memory "
                        "once and gather batches there — epochs ship only "
                        "indices (data.resident; replaces the reference's "
                        "per-epoch decode+feed, train.py:257-269); needs the "
                        "dataset to fit in the card's memory")
    p.add_argument("--recover", action="store_true",
                   help="train only members with no complete "
                        "(checkpoint, history) artifact pair — the "
                        "idempotent relaunch after a crashed/killed "
                        "process (orchestration.pending_members)")

    p = sub.add_parser("train", help="train one (test, val) ensemble member")
    _add_config_flags(p)
    p.add_argument("--work-dir", required=True)
    p.add_argument("--test-index", "-t", type=int, required=True)
    p.add_argument("--val-index", "-v", type=int, required=True)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--rgb-h5", default=None,
                   help="_PRETRAINED: Keras h5 or converted .pt (rgb)")
    p.add_argument("--flow-h5", default=None,
                   help="_PRETRAINED: Keras h5 (flow stream)")
    p.add_argument("--resident", action="store_true",
                   help="pin the split's staged clips in the card's memory "
                        "once; see launch --resident")

    p = sub.add_parser(
        "export",
        help="export one test fold's fused ensemble as a `torch.export` "
             "serving artifact (member weights baked in; runs on the device "
             "type it was exported on, which it records)",
    )
    _add_config_flags(p)
    p.add_argument("--work-dir", required=True)
    p.add_argument("--test-index", "-t", type=int, required=True)
    p.add_argument("--out", required=True, help="artifact path (.zip)")
    p.add_argument("--serve-batch", type=int, default=None,
                   help="batch size baked into the artifact signature "
                        "(default: --batch-size)")
    p.add_argument("--platforms", default="tpu",
                   help="accepted for the reference's command lines and "
                        "ignored: the artifact runs on the device it was "
                        "exported on")
    p.add_argument("--weights-npy", default=None,
                   help="fusion weights .npy (e.g. learned GRID_SEARCH / "
                        "DIFFERENTIAL_EVOLUTION weights); default: equal "
                        "SUM weights")
    p.add_argument("--no-bake-params", action="store_true",
                   help="export a lean program that takes the stacked member "
                        "state dicts at call time instead of holding them "
                        "(serve reloads them from --work-dir)")
    p.add_argument("--quant", action="store_true",
                   help="export dynamic-int8 members (the same member "
                        "checkpoints; the int8 conv and quantize kernels run "
                        "in the program)")
    p.add_argument("--fuse-1x1", action="store_true",
                   help="I3D family: export with fused inception "
                        "block-input 1x1 convs (exact rewrite, same "
                        "checkpoints; with --quant the members are dynamic "
                        "int8, which runs unfused)")
    p.add_argument("--mesh-member", type=int, default=None, metavar="M",
                   help="with --mesh-data: export a mesh artifact over a "
                        "(member M, data N) mesh: a lean program of one "
                        "position, which `serve` runs at every position of "
                        "that mesh on the visible cards")

    p = sub.add_parser(
        "serve",
        help="classify a fold CSV with a saved serving artifact — the "
             "exported program IS the ensemble (decode/staging on the host, "
             "everything else in the program on the card); replaces the "
             "reference's rebuild-the-Keras-graph-and-predict deployment "
             "path (evaluate_ensemble.py:1032-1063)",
    )
    p.add_argument("--artifact", required=True, help="zip from `export`")
    p.add_argument("--csv", required=True,
                   help="clips CSV (fold/split format: rgbclips_path "
                        "[, class, flow paths])")
    p.add_argument("--out", default=None,
                   help="predictions CSV (default: <artifact>_predictions.csv)")
    p.add_argument("--num-workers", type=int, default=8,
                   help="host decode threads")
    p.add_argument("--work-dir", default=None,
                   help="member checkpoints, required only for artifacts "
                        "exported with --no-bake-params")

    p = sub.add_parser("probs", help="cache member softmax probabilities")
    _add_config_flags(p)
    p.add_argument("--work-dir", required=True)
    p.add_argument("--test-index", "-t", type=int, default=None)
    p.add_argument("--subset", choices=["test", "train_val"], default="test")
    p.add_argument("--export-csv", action="store_true",
                   help="also write the legacy (path, probabilities) CSV")
    p.add_argument("--long-video", action="store_true",
                   help="scan strided model windows over long clips and "
                        "average their scores (the reference collapsed any "
                        "video to one subsampled window, train.py:132-145); "
                        "RGB models only")
    p.add_argument("--window-stride", type=int, default=None,
                   help="frame stride between windows (default: half the "
                        "model window)")
    p.add_argument("--long-frames", type=int, default=None,
                   help="frames staged per long clip (default: 4x the "
                        "model window)")
    p.add_argument("--recompute", action="store_true",
                   help="recompute even if the probability cache exists")
    p.add_argument("--quant", nargs="?", const="dynamic", default=None,
                   choices=["dynamic", "static"],
                   help="int8 member inference on the card's int8 conv and "
                        "quantize kernels (same checkpoints); 'static' "
                        "calibrates per-layer activation scales on the "
                        "first batches and pre-bakes int8 weights; caches at "
                        "separate `…_int8`/`…_int8static` npz paths")
    p.add_argument("--quant-blocks", default=None,
                   help="I3D family + --quant static: restrict int8 to "
                        "named stem/Mixed_* sites.  'mixed' = the "
                        "int8-where-it-wins policy "
                        "(models.quantize.MIXED_INT8_POLICY); or a comma "
                        "list, e.g. 'Conv3d_1a_7x7,Mixed_5b,Mixed_5c'. "
                        "Caches at a policy-qualified npz path")
    p.add_argument("--fuse-1x1", action="store_true",
                   help="I3D family: run each inception block's three "
                        "block-input 1x1x1 convs as ONE conv (exact "
                        "rewrite, same checkpoints).  Composes with --quant "
                        "static (one int8 conv, bit-identical there)")

    p = sub.add_parser("ensemble", help="ensemble evaluation")
    _add_config_flags(p)
    p.add_argument("--work-dir", required=True)
    p.add_argument(
        "--operation", choices=["evaluate", "global", "combine"], default="evaluate"
    )
    p.add_argument("--weights-type", "-wt", choices=WEIGHTING_SCHEMES, default="SUM")
    p.add_argument("--de-seed", type=int, default=None)
    p.add_argument("--long-video", action="store_true",
                   help="fuse the long-video window-scan probability "
                        "caches (same flags as `probs --long-video`; "
                        "computed on miss)")
    p.add_argument("--window-stride", type=int, default=None)
    p.add_argument("--long-frames", type=int, default=None)
    p.add_argument("--quant", nargs="?", const="dynamic", default=None,
                   choices=["dynamic", "static"],
                   help="consume (computing on miss) the quantized "
                        "probability caches — see `probs --quant`")
    p.add_argument("--quant-blocks", default=None,
                   help="int8 block policy for compute-on-miss — see "
                        "`probs --quant-blocks`")
    p.add_argument("--fuse-1x1", action="store_true",
                   help="compute-on-miss with fused inception 1x1 convs "
                        "— see `probs --fuse-1x1`")
    p.add_argument(
        "--models", "-ml", nargs="*", default=None,
        help="model specs for global/combine ops, e.g. C3D_SCRATCH "
             "I3D_PRETRAINED SPECIALCASE_PRETRAINED (reference "
             "launch_evaluate_ensemble.sh:23)",
    )
    p.add_argument(
        "--assert-targets", metavar="JSON", default=None,
        help="assert the measured mean accuracy against the published "
             "ISPA-2021 slots in an ACCURACY_TARGETS.json (null slots "
             "skip; non-null slots fail the command outside the "
             "tolerance_pp bar — see ensemble/targets.py)",
    )

    p = sub.add_parser("report", help="confusion/difference/agreement reports "
                                      "(PDFs: needs matplotlib)")
    _add_config_flags(p)
    p.add_argument("--work-dir", required=True)
    p.add_argument(
        "--operation",
        choices=["confusion", "difference", "agreement"],
        default="confusion",
    )
    p.add_argument("--weights-type", "-wt", choices=WEIGHTING_SCHEMES, default="SUM")
    p.add_argument(
        "--scope", choices=["homogeneous", "global"], default="homogeneous",
        help="difference matrices for the per-config ensemble or for the "
             "GLOBAL heterogeneous ensemble (reference Unique vs Global "
             "paths, evaluate_ensemble.py:397-489 vs 490-614)",
    )
    p.add_argument(
        "--subset", choices=["test", "train_val"], default="test",
        help="agreement diagrams over the test or the train+val sets "
             "(reference stickDiagrams variants, evaluate_ensemble.py:"
             "856-999, 928-996)",
    )
    p.add_argument(
        "--models", "-ml", nargs="*", default=None,
        help="model specs for --scope global (same syntax as `ensemble`)",
    )

    p = sub.add_parser(
        "convert",
        help="convert pretrained Keras h5 checkpoints into the port's .pt "
             "state dicts (reference train.py:41-57); nothing is downloaded",
    )
    p.add_argument(
        "--model-type", "-mt",
        choices=["C3D", "I3D", "TWOSTREAM_I3D",
                 "R3D_18", "R3D_34", "R3D_50", "R3D_101", "R3D_152"],
        default="I3D",
    )
    p.add_argument("--rgb-h5", default=None, help="local Keras h5 (rgb stream)")
    p.add_argument("--flow-h5", default=None, help="local Keras h5 (flow stream)")
    p.add_argument(
        "--fetch-rgb", default=None,
        help="registry name for the rgb stream, e.g. "
             "rgb_imagenet_and_kinetics: its file must be placed in "
             "--cache-dir under the reference's name (no download)",
    )
    p.add_argument(
        "--fetch-flow", default=None,
        help="registry name for the flow stream (placed, as --fetch-rgb)",
    )
    p.add_argument("--include-top", action="store_true",
                   help="the with-classification-top variant")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--out", default=None, help="output state-dict file (.pt)")
    p.add_argument(
        "--drill", default=None, metavar="SPEC_JSON",
        help="checkpoint readiness drill: resolve → checksum → convert → "
             "golden parity on the card → probs cache for every family in "
             "the spec (see checkpoint_urls.json; models/checkpoint_drill.py)",
    )
    p.add_argument("--work-dir", default="drill_work",
                   help="--drill output directory")

    sub.add_parser("bench", help="the clips/sec benchmark (not ported yet)")
    return parser


def _positions(device, n: int) -> list:
    """n positions cycling over the visible cards, or over `device` when it
    is not a card; -1 takes one position a card."""
    import torch

    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
               else [device])
    return devices if n == -1 else [devices[i % len(devices)] for i in range(n)]


def _mesh_from_args(args, device):
    """`--mesh-data N`: a data mesh of N positions (JAX cli/main.py:88-94)
    (`_positions`)."""
    from ..core.mesh import make_mesh

    n = getattr(args, "mesh_data", None)
    if not n:
        return None
    positions = _positions(device, n)
    return make_mesh((("data", len(positions)),), positions)


def _fold_members(config: ExperimentConfig, layout, t: int, device, quant=False, fuse_1x1=False):
    """Test fold t's members as inference bundles of the config's model in
    its compute dtype on `device` (I3D-family ones `stem_prestaged`, for
    the shared stem staging, and with `fuse_1x1` their block-input 1³
    convs fused), each loaded from its best checkpoint, and their artifact
    stems."""
    from ..models.registry import build_model
    from ..orchestration import _member_variables, compute_dtype

    kw = ({"stem_prestaged": True, "fuse_1x1": fuse_1x1} if config.model_type in ("I3D", "TWOSTREAM_I3D")
          else {})
    build = lambda: build_model(config.model_type, config.num_classes, dtype=compute_dtype(config),  # noqa: E731
                                device=device, quant=quant, **kw)
    bundles = [build()]
    variables, names = _member_variables(config, layout, bundles[0].module, t)
    bundles += [build() for _ in variables[1:]]
    for b, state in zip(bundles, variables):
        b.module.load_state_dict(state)
    return bundles, names


def _folds(args, device) -> int:
    from ..data.crowd11 import build_clip_table
    from ..data.folds import generate_folds

    table = build_clip_table(args.dataset_directory, args.database_file)
    folder, _ = generate_folds(table, args.parent_folds_folder, args.folds_number)
    print(f"folds written to {folder}")
    return 0


def _augment(args, device) -> int:
    from ..data.augment_offline import augment_folds

    augment_folds(
        args.folds_folder,
        args.augmented_data_folder,
        args.folds_number,
        args.augmentation_frequency,
        operation=args.operation,
        device=device,
    )
    print("augmentation complete")
    return 0


def _launch(args, device) -> int:
    from ..orchestration import launch_ensemble_training

    config = _config_from_args(args)
    table = None
    if args.dataset_directory:
        from ..data.crowd11 import build_clip_table

        table = build_clip_table(args.dataset_directory, args.database_file)
    out = launch_ensemble_training(
        config, table, args.work_dir, runner=args.runner,
        rgb_h5=args.rgb_h5, flow_h5=args.flow_h5,
        resident=args.resident, recover=args.recover, device=device,
        mesh=_mesh_from_args(args, device),
    )
    if args.runner == "commands":
        print("\n".join(out))
    else:
        for (t, v), r in out.items():
            print(
                f"split test{t} val{v}: test_acc={r['test_accuracy']:.4f} "
                f"test_loss={r['test_loss']:.4f}"
            )
    config.save(os.path.join(args.work_dir, "experiment.json"))
    return 0


def _train(args, device) -> int:
    from ..orchestration import prepare_ensemble, train_member

    config = _config_from_args(args)
    layout = prepare_ensemble(config, None, args.work_dir, device=device)
    out = train_member(
        config,
        layout,
        args.test_index,
        args.val_index,
        verbose=args.verbose,
        rgb_h5=args.rgb_h5,
        flow_h5=args.flow_h5,
        resident=args.resident,
        device=device,
        mesh=_mesh_from_args(args, device),
    )
    print(
        f"test_acc={out['test_accuracy']:.4f} test_loss={out['test_loss']:.4f} "
        f"best_val_loss={out['best_val_loss']:.4f}"
    )
    return 0


def _export(args, device) -> int:
    from ..flow.farneback import flow_schedule_params
    from ..orchestration import WorkLayout
    from ..serving import export_ensemble, save_serving_artifact, serving_batch_example

    config = _config_from_args(args)
    mesh = None
    if args.mesh_member:
        if not args.mesh_data:
            print("--mesh-member requires --mesh-data", file=sys.stderr)
            return 2
        from ..core.mesh import make_mesh

        mesh = make_mesh((("member", args.mesh_member), ("data", args.mesh_data)),
                         _positions(device, args.mesh_member * args.mesh_data))
    fuse_1x1 = args.fuse_1x1 and "I3D" in config.model_type
    bundles, names = _fold_members(config, WorkLayout(args.work_dir), args.test_index, device, args.quant,
                                   fuse_1x1)
    weights = np.load(args.weights_npy) if args.weights_npy else None
    example = serving_batch_example(
        bundles[0],
        args.serve_batch or config.batch_size,
        flow_precomputed=(config.optical_flow_status == "TVL1_precomputed"),
    )
    # The production member forward (ensemble.members.member_probabilities):
    # I3D-family members share one s2d stem staging, and on-card Farnebäck
    # serves with the schedule the members trained with.
    flow_params = (
        flow_schedule_params(config.flow_schedule)
        if bundles[0].two_stream and config.optical_flow_status != "TVL1_precomputed"
        else None
    )
    program = export_ensemble(
        bundles,
        example,
        weights=weights,
        input_scale=config.input_scale,
        bake_params=not args.no_bake_params,
        share_stem_staging=config.model_type in ("I3D", "TWOSTREAM_I3D"),
        flow_params=flow_params,
        mesh=mesh,
    )
    meta = {
        "model_type": config.model_type,
        "num_classes": config.num_classes,
        "test_index": args.test_index,
        "members": names,
        "quant": args.quant,
        "fuse_1x1": fuse_1x1,
        "input_scale": config.input_scale,
        "platforms": [bundles[0].device.type],
        "params_baked": mesh is None and not args.no_bake_params,
        "mesh": None if mesh is None else {"member": args.mesh_member, "data": args.mesh_data},
        # full config: `serve` rebuilds it to reload member checkpoints
        # for lean (params-unbaked) artifacts
        "experiment": json.loads(config.to_json()),
        "fusion_weights": (
            [1.0] * len(names) if weights is None else np.asarray(weights).tolist()
        ),
        "input_spec": {k: list(v.shape) for k, v in example.items()},
    }
    print(save_serving_artifact(args.out, program, meta))
    return 0


def _serve(args, device) -> int:
    import torch

    from ..data.pipeline import BatchPipeline, SampleSpec, prefetch_batches
    from ..data.table import ClipTable
    from ..serving import load_serving_artifact

    serve_fn, meta = load_serving_artifact(args.artifact, device)
    ispec = meta["input_spec"]
    b, t, h, w = ispec["rgb"][:4]
    spec = SampleSpec(
        num_frames=t,
        staging_hw=(h, w),
        two_stream=("flow" in ispec or "gray" in ispec),
        flow_precomputed=("flow" in ispec),
    )
    table = ClipTable.read_csv(args.csv)
    pipe = BatchPipeline(table, spec, batch_size=b, shuffle=False, num_workers=args.num_workers)
    call_args = []
    if not meta.get("params_baked", True):
        # lean artifact: the caller supplies the stacked member state dicts
        # (see serving.export_ensemble)
        if not args.work_dir or "experiment" not in meta:
            print(
                "artifact was exported without baked parameters; "
                "pass --work-dir with the member checkpoints",
                file=sys.stderr,
            )
            return 2
        from ..ensemble.members import stack_variables
        from ..orchestration import WorkLayout

        config = ExperimentConfig.from_json(json.dumps(meta["experiment"]))
        bundles, _ = _fold_members(config, WorkLayout(args.work_dir), meta["test_index"], device,
                                   meta.get("quant", False), meta.get("fuse_1x1", False))
        call_args.append(stack_variables([m.module.state_dict() for m in bundles]))

    keys = list(ispec)
    preds_chunks = []
    for batch in prefetch_batches(pipe, epoch=0):
        out = serve_fn(*call_args, {k: torch.from_numpy(batch[k]).to(device) for k in keys})
        preds_chunks.append(out["preds"].cpu().numpy()[batch["valid"]])
    preds = np.concatenate(preds_chunks)

    table["prediction"] = preds
    if "class" in table:
        labels = np.asarray(table["class"], np.int64)
        acc = float((preds == labels).mean())
        print(f"accuracy: {acc:.4f} over {len(preds)} clips")
    out_path = args.out or (
        os.path.splitext(args.artifact)[0] + "_predictions.csv"
    )
    table.to_csv(out_path)
    print(out_path)
    return 0


def _probs(args, device) -> int:
    from ..ensemble.probability_store import export_reference_csv
    from ..orchestration import WorkLayout, cache_probabilities

    config = _config_from_args(args)
    layout = WorkLayout(args.work_dir)
    tests = (
        [args.test_index]
        if args.test_index is not None
        else range(config.folds_number)
    )
    for t in tests:
        path = cache_probabilities(
            config, layout, t, args.subset,
            mesh=_mesh_from_args(args, device),
            long_video=args.long_video,
            window_stride=args.window_stride,
            long_frames=args.long_frames,
            recompute=args.recompute,
            quant=args.quant,
            quant_blocks=args.quant_blocks,
            fuse_1x1=args.fuse_1x1,
            device=device,
        )
        print(path)
        if args.export_csv:
            print(export_reference_csv(path, path.replace(".npz", ".csv")))
    return 0


def _check_targets(args, key: str, res, per_fold=None) -> int:
    """Print the target check of `res` against --assert-targets; 1 when it
    misses, else 0."""
    from ..ensemble.targets import check_target, load_targets

    chk = check_target(load_targets(args.assert_targets), key, res.mean_accuracy, per_fold=per_fold)
    print(chk.message)
    return 1 if chk.ok is False else 0


def _ensemble(args, device) -> int:
    from ..ensemble.evaluate import (
        combine_ensembles,
        evaluate_ensembles,
        global_evaluate_ensembles,
        save_global_predictions_csv,
    )
    from ..orchestration import WorkLayout, make_prob_provider, min_val_losses_provider

    config = _config_from_args(args)
    layout = WorkLayout(args.work_dir)
    provider_kwargs = {"device": device}
    if args.long_video:
        provider_kwargs.update(
            long_video=True,
            window_stride=args.window_stride,
            long_frames=args.long_frames,
        )
    if args.quant:
        provider_kwargs["quant"] = args.quant
        if args.quant_blocks:
            provider_kwargs["quant_blocks"] = args.quant_blocks
    if args.fuse_1x1:
        provider_kwargs["fuse_1x1"] = True
    provider = make_prob_provider(config, layout, **provider_kwargs)
    if args.operation == "evaluate":
        res = evaluate_ensembles(
            provider,
            config.folds_number,
            args.weights_type,
            name=config.subfolder_name(),
            min_val_losses_provider=min_val_losses_provider(config, layout),
            de_seed=args.de_seed,
            device=device,
        )
        for f in res.folds:
            print(f"fold {f.test_index}: accuracy {f.accuracy:.4f}")
        print(f"mean accuracy: {res.mean_accuracy:.4f}")
        print(res.save_predictions_csv(layout.results_dir))
        wpath = res.save_weights_npy(layout.results_dir)
        if wpath:
            print(wpath)
        if args.assert_targets:
            return _check_targets(args, config.subfolder_name(), res, [f.accuracy for f in res.folds])
        return 0
    if args.models:
        from ..orchestration import global_prob_providers

        providers = global_prob_providers(
            args.models, args.work_dir, config.folds_number,
            config.num_classes, **provider_kwargs,
        )
    else:
        providers = {config.subfolder_name(): provider}
    if args.operation == "global":
        res = global_evaluate_ensembles(providers, config.folds_number, device=device)
        print(f"global mean accuracy: {res.mean_accuracy:.4f}")
        print(save_global_predictions_csv(res, layout.results_dir))
        if args.assert_targets:
            return _check_targets(args, "GLOBAL", res)
        return 0
    ranked = combine_ensembles(providers, config.folds_number, device=device)
    for subset, acc in ranked:
        print(f"{'+'.join(subset)}: {acc:.4f}")
    return 0


def _report(args, device) -> int:
    from .. import reports
    from ..ensemble.evaluate import evaluate_ensembles, global_evaluate_ensembles
    from ..orchestration import WorkLayout, make_prob_provider, min_val_losses_provider

    config = _config_from_args(args)
    layout = WorkLayout(args.work_dir)
    provider = make_prob_provider(config, layout, device=device)
    os.makedirs(layout.results_dir, exist_ok=True)

    def normalized_cm(labels, predictions):
        return reports.row_normalize(reports.confusion_matrix(labels, predictions, config.num_classes))

    def difference_pdfs(ens_cm, d, stem: str) -> None:
        """One (ensemble CM − member CM) heatmap a member of `d`."""
        for i in range(d["probs"].shape[0]):
            member_cm = normalized_cm(d["labels"], np.argmax(d["probs"][i], -1))
            print(reports.render_difference_pdf(reports.difference_matrix(ens_cm, member_cm),
                                                os.path.join(layout.results_dir, f"{stem}_m{i}.pdf")))

    if args.scope == "global" and args.operation in ("confusion", "difference"):
        # Global heterogeneous paths: per-fold global-ensemble confusion
        # matrices (reference evaluate_ensemble.py:783-851) and
        # (global-ensemble CM − individual member CM) heatmaps (reference
        # evaluate_ensemble.py:490-614).
        if args.models:
            from ..orchestration import global_prob_providers

            providers = global_prob_providers(
                args.models, args.work_dir, config.folds_number,
                config.num_classes, device=device,
            )
        else:
            providers = {config.subfolder_name(): provider}
        gres = global_evaluate_ensembles(providers, config.folds_number, device=device)
        if args.operation == "confusion":
            first = next(iter(providers.values()))
            cms = [normalized_cm(first(f.test_index, "test")["labels"], f.predictions) for f in gres.folds]
            print(reports.render_confusion_grid_pdf(
                cms, os.path.join(layout.results_dir, "confusion_global_ensemble.pdf")))
            return 0
        for f in gres.folds:
            ens_cm = None
            for cfg_name, prov in providers.items():
                d = prov(f.test_index, "test")
                if ens_cm is None:
                    # labels are shared across configs (same test fold)
                    ens_cm = normalized_cm(d["labels"], f.predictions)
                difference_pdfs(ens_cm, d, f"difference_global_{cfg_name}_t{f.test_index}")
        return 0

    res = evaluate_ensembles(
        provider,
        config.folds_number,
        args.weights_type,
        name=config.subfolder_name(),
        min_val_losses_provider=min_val_losses_provider(config, layout),
        device=device,
    )
    if args.operation == "confusion":
        cms = [normalized_cm(provider(f.test_index, "test")["labels"], f.predictions) for f in res.folds]
        print(reports.render_confusion_grid_pdf(
            cms, os.path.join(layout.results_dir, f"confusion_{config.subfolder_name()}.pdf")))
    elif args.operation == "difference":
        for f in res.folds:
            d = provider(f.test_index, "test")
            difference_pdfs(normalized_cm(d["labels"], f.predictions), d,
                            f"difference_{config.subfolder_name()}_t{f.test_index}")
    else:  # agreement — test or train_val sets (reference
        # stickDiagrams variants, evaluate_ensemble.py:856-999, 928-996)
        n_members = config.folds_number - 1
        hists = []
        for f in res.folds:
            d = provider(f.test_index, args.subset)
            hists.append(reports.agreement_histogram(reports.members_correct_per_clip(d["probs"], d["labels"]),
                                                     n_members))
        suffix = "" if args.subset == "test" else f"_{args.subset}"
        print(reports.render_agreement_pdf(
            hists, os.path.join(layout.results_dir, f"agreement_{config.subfolder_name()}{suffix}.pdf"),
            n_members=n_members))
    return 0


def _convert(args, device) -> int:
    from ..models.pretrained import CONVERTED_SUFFIX
    from ..models.weights_registry import convert_keras_checkpoint, placed_weights

    if args.drill:
        from ..models.checkpoint_drill import run_drill

        report = run_drill(args.drill, args.work_dir, cache_dir=args.cache_dir, device=device)
        failed = False
        for mt, entry in report["families"].items():
            status = entry.get("status", "?")
            failed |= status == "failed"
            parity = entry.get("steps", {}).get("parity", {})
            delta = parity.get("max_softmax_delta")
            extra = f" parity_delta={delta:.2e}" if delta is not None else ""
            print(f"drill {mt}: {status}{extra}")
        print(report["report_path"])
        return 1 if failed else 0
    if args.out is None:
        print("convert needs --out (or --drill SPEC_JSON)", file=sys.stderr)
        return 2
    if not args.out.endswith(CONVERTED_SUFFIX):
        raise ValueError(f"convert writes a torch state dict: --out must end in {CONVERTED_SUFFIX}, "
                         f"the suffix models.pretrained.load_pretrained reads as converted (got {args.out})")
    rgb_h5, flow_h5 = args.rgb_h5, args.flow_h5
    if args.fetch_rgb:
        rgb_h5 = placed_weights(args.fetch_rgb, include_top=args.include_top, cache_dir=args.cache_dir)
    if args.fetch_flow:
        flow_h5 = placed_weights(args.fetch_flow, include_top=args.include_top, cache_dir=args.cache_dir)
    out, _ = convert_keras_checkpoint(
        args.model_type, args.out, rgb_h5=rgb_h5, flow_h5=flow_h5,
        num_classes=args.num_classes, include_top=args.include_top,
    )
    print(out)
    return 0


_HANDLERS = {
    "folds": _folds,
    "augment": _augment,
    "launch": _launch,
    "train": _train,
    "export": _export,
    "serve": _serve,
    "probs": _probs,
    "ensemble": _ensemble,
    "report": _report,
    "convert": _convert,
}


def main(argv=None, device=None) -> int:
    """Run one command; returns its exit code.  `device` is for tests
    ("cpu"); the command line leaves it None, the card."""
    args = build_parser().parse_args(argv)
    if args.command == "bench":
        print("bench: the port has no benchmark script yet (ROADMAP Queue 1 item 1); "
              "chip_smoke.py drives every path on the card meanwhile", file=sys.stderr)
        return 2
    if args.command == "report":
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            print(f"report renders PDFs with matplotlib, which does not import here ({e}); install "
                  "matplotlib, or read the matrices from the port's reports module", file=sys.stderr)
            return 2
    from ..utils.device import resolve_device

    return _HANDLERS[args.command](args, resolve_device(device))


if __name__ == "__main__":
    sys.exit(main())
