"""The port's command line against the JAX package's on the CPU.

- The parsers: every subcommand's actions equal JAX's field by field (all
  but `help`), and the same argv parses to the same namespace.
- The emitted `train` commands (`launch --runner commands`, with and
  without `--recover`, every optional flag) parse with the port's parser
  into the config that emitted them.
- The call mapping: the same argv through both CLIs, their callees
  replaced by recorders, records the same arguments; the differences are
  the port's `device`, JAX's `mesh=None`, `.pt` for `.msgpack` and
  `export --platforms`, which the port records as the device instead.
- Real runs with `device="cpu"` on tiny members (width-0.125 C3Ds at their
  canonical 16×112², bf16, as the command line builds them): `folds` CSVs
  byte-equal to JAX's CLI; `train` bit-equal to `orchestration.
  train_member`; `probs` bit-equal to `cache_probabilities`; `ensemble`
  lines, CSV and npy byte-equal to JAX's CLI on the same cached
  probabilities; `report` matrices equal to JAX's with the renderers
  recorded, and exit 2 without matplotlib; `export` then `serve` equal to
  the members' eager fused argmax, the CSV byte-equal to pandas'; the
  mesh flags (`train`/`launch --mesh-data 2`, `export --mesh-member 2
  --mesh-data 2` then `serve`) against their unsharded forms; the refused
  flags and `bench`.
- A subprocess with jax, pandas, h5py and matplotlib blocked runs
  `python -m crowded_scenes_ensemble_classification_tpu_torch --help` and
  an emitted `train` command, which stops at the missing card.

Small sizes: tests/test_end_to_end.py's dataset (9 scenes × 3 clips, 3
classes, 16 frames at 40×40, .npy clips, 3 folds).  No JAX model is
compiled; torch and the port are imported by fixtures
(tests/torch_port_memory.py).
"""

import argparse
import dataclasses
import importlib
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax  # noqa: F401 (JAX on the CPU before the port's fixtures import torch)
import numpy as np
import pandas as pd
import pytest

from crowded_scenes_ensemble_classification_tpu import orchestration as jorch
from crowded_scenes_ensemble_classification_tpu import reports as jreports
from crowded_scenes_ensemble_classification_tpu import serving as jserving
from crowded_scenes_ensemble_classification_tpu.core import config as jconfig
from crowded_scenes_ensemble_classification_tpu.data import augment_offline as jaug_off
from crowded_scenes_ensemble_classification_tpu.data import synthetic as jsynthetic
from crowded_scenes_ensemble_classification_tpu.ensemble.probability_store import (
    probability_cache_path,
    save_probabilities as j_save_probabilities,
)
from crowded_scenes_ensemble_classification_tpu.models import weights_registry as jregistry
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

jcli = importlib.import_module("crowded_scenes_ensemble_classification_tpu.cli.main")  # the package exports `main`

REPO = Path(__file__).resolve().parents[1]
PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES, FOLDS = 3, 3
BASE = ["-mt", "C3D", "-fn", str(FOLDS), "--num-classes", str(CLASSES), "-bs", "6", "-e", "1"]
COMMANDS = ["folds", "augment", "launch", "train", "export", "serve", "probs", "ensemble", "report", "convert",
            "bench"]
FIELDS = ("option_strings", "dest", "nargs", "const", "default", "type", "choices", "required", "metavar")


@pytest.fixture(scope="module")
def pcli(torch):
    return importlib.import_module(f"{PORT}.cli.main")


@pytest.fixture(scope="module")
def port(torch):
    """The port's modules the tests patch and call."""
    names = ("orchestration", "core.config", "models.registry", "models.pretrained", "reports", "serving",
             "data.augment_offline", "models.weights_registry", "data.table", "ensemble.probability_store",
             "ensemble.members", "data.pipeline", "train.checkpoints")
    return SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(f"{PORT}.{n}") for n in names})


# ----------------------------------------------------------------------
# The parsers
# ----------------------------------------------------------------------


def _actions(parser):
    return [(type(a).__name__, *(getattr(a, f) for f in FIELDS)) for a in parser._actions
            if not isinstance(a, argparse._SubParsersAction)]


def _subparsers(parser):
    return next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction)).choices


@pytest.mark.parametrize("command", COMMANDS)
def test_parser_equals_jax(pcli, command):
    """Same subcommands in the same order; the command's actions equal
    JAX's in every field but `help`."""
    port_sub, jax_sub = _subparsers(pcli.build_parser()), _subparsers(jcli.build_parser())
    assert list(port_sub) == list(jax_sub) == COMMANDS
    assert _actions(pcli.build_parser()) == _actions(jcli.build_parser())
    assert _actions(port_sub[command]) == _actions(jax_sub[command])


ARGVS = {
    # tests/test_cli.py:15
    "train": ["train", "--work-dir", "/tmp/x", "--model-type", "TWOSTREAM_I3D", "--training-condition", "_PRETRAINED",
              "--augmentation-status", "augmented_precomputed", "--optical-flow-status", "TVL1_precomputed",
              "--classes-status", "balanced", "--test-index", "0", "--val-index", "1"],
    "folds": ["folds", "-df", "/d", "-db", "db.csv", "-pff", "/f", "-fn", "4"],
    "augment": ["augment", "--folds-folder", "/f", "--augmented-data-folder", "/a", "-af", "3",
                "--operation", "update_links"],
    "launch": ["launch", "--work-dir", "/w", "-mt", "R3D_50", "--runner", "commands", "--recover", "--resident",
               "--flow-schedule", "turbo", "--input-scale", "0.5", "--flow-from-augmented", "--mesh-data", "2"],
    "export": ["export", "--work-dir", "/w", "-t", "2", "--out", "a.zip", "--serve-batch", "4", "--platforms",
               "cpu", "--no-bake-params", "--quant", "--fuse-1x1", "--mesh-member", "2"],
    "serve": ["serve", "--artifact", "a.zip", "--csv", "c.csv", "--num-workers", "2", "--work-dir", "/w"],
    "probs": ["probs", "--work-dir", "/w", "-mt", "I3D", "--quant", "--quant-blocks", "mixed", "--long-video",
              "--window-stride", "4", "--export-csv", "--subset", "train_val"],
    "ensemble": ["ensemble", "--work-dir", "/w", "--operation", "combine", "-wt", "GRID_SEARCH", "--quant",
                 "static", "-ml", "C3D_SCRATCH", "I3D_PRETRAINED", "--assert-targets", "t.json", "--de-seed", "3"],
    "report": ["report", "--work-dir", "/w", "--operation", "difference", "--scope", "global", "-ml"],
    "convert": ["convert", "-mt", "R3D_34", "--fetch-rgb", "rgb_kinetics_only", "--include-top", "--num-classes",
                "7", "--drill", "s.json", "--work-dir", "d"],
    "bench": ["bench"],
}


@pytest.mark.parametrize("command", COMMANDS)
def test_parse_args_equal_jax(pcli, command):
    argv = ARGVS[command]
    assert vars(pcli.build_parser().parse_args(argv)) == vars(jcli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit):
        pcli.build_parser().parse_args(argv + ["--no-such-flag"])


# ----------------------------------------------------------------------
# The workspace: a prepared experiment with test fold 0's two members
# ----------------------------------------------------------------------


def _tiny(real):
    """`build_model` building C3Ds at width 0.125 (the canonical geometry)."""
    def build(model_type, num_classes=11, **kw):
        if model_type == "C3D":
            kw.setdefault("width", 0.125)
        return real(model_type, num_classes, **kw)

    return build


@pytest.fixture
def tiny_builds(port, monkeypatch):
    """Every `build_model` the command line reaches builds tiny C3Ds."""
    real = port.registry.build_model
    for mod in (port.registry, port.pretrained, port.orchestration):
        monkeypatch.setattr(mod, "build_model", _tiny(real))
    return _tiny(real)


@pytest.fixture(scope="module")
def ws(torch, port, tmp_path_factory):
    """The prepared workspace (config as the command line builds it from
    BASE) with test fold 0's members: seeded tiny C3Ds' f32 state dicts and
    their histories."""
    root = tmp_path_factory.mktemp("cli")
    df = jsynthetic.generate_synthetic_dataset(str(root / "data"), num_scenes=9, clips_per_scene=3,
                                               num_classes=CLASSES, num_frames=16, hw=(40, 40), as_videos=False)
    df.to_csv(root / "clips.csv", index=False)
    table = port.table.ClipTable.read_csv(str(root / "clips.csv"))
    cfg = port.config.ExperimentConfig(model_type="C3D", folds_number=FOLDS, num_classes=CLASSES, batch_size=6,
                                       epochs=1)
    layout = port.orchestration.prepare_ensemble(cfg, table, str(root / "work"), device="cpu")
    build = _tiny(port.registry.build_model)
    for v in (1, 2):
        bundle = build("C3D", CLASSES, device="cpu", trainable=True, generator=torch.Generator().manual_seed(v))
        port.checkpoints.save_best(layout.checkpoint_dir(cfg, 0, v), bundle.module.state_dict())
        np.save(layout.history_path(cfg, 0, v), np.asarray([2.0, 1.5 / v], np.float32))
    return SimpleNamespace(root=root, cfg=cfg, layout=layout, work=layout.root)


def _lines(out: str, *roots) -> list:
    for r in roots:
        out = out.replace(str(r), "<root>")
    return out.strip().splitlines()


# ----------------------------------------------------------------------
# Emitted commands
# ----------------------------------------------------------------------


@pytest.mark.parametrize("fields,kw,recover", [
    ({}, {}, False),
    ({}, {}, True),
    ({}, dict(rgb_h5="/w/rgb.pt", resident=True), False),
    (dict(model_type="TWOSTREAM_I3D", training_condition="_PRETRAINED", input_scale=0.5, flow_schedule="turbo",
          flow_from_augmented=True, augmentation_status="augmented_onTheFly"),
     dict(rgb_h5="/w/rgb.h5", flow_h5="/w/flow.h5"), True),
])
def test_emitted_commands_parse_into_their_config(pcli, port, ws, tmp_path, fields, kw, recover):
    """`launch_ensemble_training(runner='commands')` lines parse with the
    port's parser into the emitting config, member for member; with
    recover=True only the pending members are emitted."""
    orch = port.orchestration
    work = str(tmp_path / "work")
    shutil.copytree(ws.layout.folds_dir, os.path.join(work, "Folds"))
    cfg = dataclasses.replace(ws.cfg, **fields)
    if recover:  # test fold 0's members are complete
        layout = orch.WorkLayout(work)
        for v in (1, 2):
            shutil.copytree(ws.layout.checkpoint_dir(ws.cfg, 0, v), layout.checkpoint_dir(cfg, 0, v))
            os.makedirs(os.path.dirname(layout.history_path(cfg, 0, v)), exist_ok=True)
            shutil.copy(ws.layout.history_path(ws.cfg, 0, v), layout.history_path(cfg, 0, v))
    cmds = orch.launch_ensemble_training(cfg, None, work, runner="commands", recover=recover, device="cpu", **kw)
    pairs = orch.pending_members(cfg, orch.WorkLayout(work)) if recover else port.config.split_pairs(FOLDS)
    assert len(cmds) == len(pairs) == (4 if recover else 6)
    parser = pcli.build_parser()
    for cmd, (t, v) in zip(cmds, pairs):
        argv = shlex.split(cmd)
        assert argv[:3] == ["python", "-m", PORT]
        args = parser.parse_args(argv[3:])
        assert (args.command, args.test_index, args.val_index) == ("train", t, v)
        assert (args.rgb_h5, args.flow_h5, args.resident) == (kw.get("rgb_h5"), kw.get("flow_h5"),
                                                               kw.get("resident", False))
        assert pcli._config_from_args(args) == cfg
        assert pcli._config_from_args(parser.parse_args(argv[3:] + ["--work-dir", str(tmp_path / "none")])) == cfg


# ----------------------------------------------------------------------
# The call mapping, against JAX's CLI
# ----------------------------------------------------------------------


def _norm(x, root):
    """A comparable form of a recorded argument: configs as JSON, layouts
    and paths relative to the side's root, tables as records."""
    if dataclasses.is_dataclass(x) and hasattr(x, "to_json"):
        return json.loads(x.to_json())
    if isinstance(x, (jorch.WorkLayout,)) or type(x).__name__ == "WorkLayout":
        return ("WorkLayout", os.path.relpath(x.root, root))
    if isinstance(x, pd.DataFrame):
        return x.to_dict("records")
    if type(x).__name__ == "ClipTable":
        return x.records()
    if isinstance(x, str):
        return x.replace(str(root), "<root>").replace(".msgpack", ".pt")
    if isinstance(x, dict):
        return {k: _norm(v, root) for k, v in x.items() if k not in ("device", "mesh")}
    if isinstance(x, (list, tuple)):
        return [_norm(v, root) for v in x]
    return x


def _recorder(monkeypatch, module, name, ret=None):
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return ret(*args, **kwargs) if callable(ret) else ret

    monkeypatch.setattr(module, name, record)
    return calls


def _placed(cache, names, include_top):
    for n in names:
        p = os.path.join(cache, jregistry.cached_filename(n, include_top))
        os.makedirs(cache, exist_ok=True)
        open(p, "wb").close()


RECORDED = {
    "probs": (["probs", "--work-dir", "{w}", "-mt", "I3D", "-fn", "3", "-t", "1", "--subset", "train_val", "--quant",
               "static", "--quant-blocks", "mixed", "--long-video", "--window-stride", "4", "--long-frames", "32",
               "--recompute", "--input-scale", "0.5", "--flow-schedule", "turbo"], [("cache_probabilities", "x.npz")]),
    "launch": (["launch", "--work-dir", "{w}", "-mt", "TWOSTREAM_I3D", "-tc", "_PRETRAINED", "--runner", "commands",
                "--recover", "--rgb-h5", "r.h5", "--flow-h5", "f.h5", "--resident", "-df", "{videos}"],
               [("launch_ensemble_training", [])]),
    "train": (["train", "--work-dir", "{w}", *BASE, "-t", "1", "-v", "2", "--verbose", "--rgb-h5", "r.pt",
               "--flow-h5", "f.h5", "--resident", "-as", "augmented_onTheFly"],
              [("prepare_ensemble", "layout"),
               ("train_member", {"test_accuracy": 0.5, "test_loss": 1.0, "best_val_loss": 0.25})]),
    "augment": (["augment", "--folds-folder", "{w}/F", "--augmented-data-folder", "{w}/A", "-fn", "4", "-af", "2",
                 "--operation", "update_links"], [("augment_folds", None)]),
    "convert": (["convert", "-mt", "TWOSTREAM_I3D", "--rgb-h5", "a.h5", "--flow-h5", "b.h5", "--num-classes", "7",
                 "--out", "{w}/x.pt"], [("convert_keras_checkpoint", ("out", None))]),
    "convert_placed": (["convert", "-mt", "I3D", "--fetch-rgb", "rgb_imagenet_and_kinetics", "--fetch-flow",
                        "flow_kinetics_only", "--include-top", "--cache-dir", "{w}/cache", "--out", "{w}/x.pt"],
                       [("convert_keras_checkpoint", ("out", None))]),
}


def _recorded_callees(side, port):
    """{callee name: module holding it} on one side."""
    if side == "jax":
        from crowded_scenes_ensemble_classification_tpu.models import weights_registry

        return {"cache_probabilities": jorch, "launch_ensemble_training": jorch, "prepare_ensemble": jorch,
                "train_member": jorch, "augment_folds": jaug_off, "convert_keras_checkpoint": weights_registry}
    return {"cache_probabilities": port.orchestration, "launch_ensemble_training": port.orchestration,
            "prepare_ensemble": port.orchestration, "train_member": port.orchestration,
            "augment_folds": port.augment_offline, "convert_keras_checkpoint": port.weights_registry}


@pytest.mark.parametrize("case", RECORDED)
def test_same_argv_reaches_the_same_callees_as_jax(torch, pcli, port, case, tmp_path, monkeypatch, capsys, videos):
    argv, callees = RECORDED[case]
    seen, printed = {}, {}
    for side in ("jax", "port"):
        w = tmp_path / side
        os.makedirs(w)
        _placed(str(w / "cache"), ["rgb_imagenet_and_kinetics", "flow_kinetics_only"], include_top=True)
        mods = _recorded_callees(side, port)
        layout_cls = (jorch if side == "jax" else port.orchestration).WorkLayout
        calls = {}
        for name, ret in callees:
            ret = (lambda *a, _c=layout_cls, **k: _c(a[2])) if ret == "layout" else ret
            calls[name] = _recorder(monkeypatch, mods[name], name, ret)
        subs = {"{w}": str(w), "{videos}": videos}
        args = [next((a.replace(k, v) for k, v in subs.items() if k in a), a) for a in argv]
        if side == "jax":
            rc = jcli.main([a.replace(".pt", ".msgpack") if a.endswith("x.pt") else a for a in args])
        else:
            rc = pcli.main(args, device="cpu")
        assert rc == 0
        printed[side] = _lines(capsys.readouterr().out, w)
        seen[side] = {n: [(_norm(list(a), w), _norm(k, w)) for a, k in c] for n, c in calls.items()}
        if side == "port":
            assert all(k["device"] == torch.device("cpu") for c in calls.values() for _, k in c if "device" in k)
    assert seen["port"] == seen["jax"]
    assert all(len(c) >= 1 for c in seen["port"].values())
    assert printed["port"] == printed["jax"]


def test_export_records_the_same_arguments_as_jax(torch, pcli, port, ws, tiny_builds, tmp_path, monkeypatch, capsys):
    """`export` on test fold 0: the same batch size and flow form, fusion
    weights (from --weights-npy), input scale, bake and stem-sharing
    choices and metadata as JAX's export; the port exports the members
    loaded from their checkpoints.  JAX's members are stubbed (its
    `build_model`, `_member_variables` and example), since its export compiles
    flax models."""
    weights = tmp_path / "w.npy"
    np.save(weights, np.asarray([0.25, 0.75]))
    argv = ["export", "--work-dir", "{w}", *BASE, "-t", "0", "--out", "{w}/a.zip", "--serve-batch", "4",
            "--weights-npy", str(weights), "--no-bake-params", "--platforms", "tpu"]
    jcfg = jconfig.ExperimentConfig(model_type="C3D", folds_number=FOLDS, num_classes=CLASSES, batch_size=6, epochs=1)
    names = [jcfg.artifact_stem(0, v) for v in (1, 2)]
    jclip = jconfig.clip_spec("C3D")
    import crowded_scenes_ensemble_classification_tpu.models as jmodels

    monkeypatch.setattr(jmodels, "build_model", lambda *a, **k: SimpleNamespace(two_stream=False))
    monkeypatch.setattr(jorch, "_member_variables", lambda *a: (["v1", "v2"], names))
    seen = {}
    for side, w in (("jax", tmp_path / "jax"), ("port", Path(ws.work))):
        mod = jserving if side == "jax" else port.serving
        if side == "jax":
            example = lambda b, n, flow_precomputed: {"rgb": np.zeros((n, *jclip.rgb_shape), np.uint8)}  # noqa: E731
        else:
            example = port.serving.serving_batch_example
        examples = _recorder(monkeypatch, mod, "serving_batch_example", example)
        exports = _recorder(monkeypatch, mod, "export_ensemble", "program")
        saves = _recorder(monkeypatch, mod, "save_serving_artifact", lambda path, program, meta: path)
        args = [a.replace("{w}", str(w)) for a in argv]
        assert (jcli.main(args) if side == "jax" else pcli.main(args, device="cpu")) == 0
        assert _lines(capsys.readouterr().out, w) == ["<root>/a.zip"]
        (members_or_bundle, *rest), kw = exports[0]
        if side == "port":  # the members in the compute dtype, loaded from their checkpoints
            for b, v in zip(members_or_bundle, (1, 2)):
                want, got = port.checkpoints.restore_best(ws.layout.checkpoint_dir(ws.cfg, 0, v)), b.module.state_dict()
                assert got["conv1.weight"].dtype == torch.bfloat16
                assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in want)
        kw = dict(kw)
        kw.pop("platforms", None)
        kw["weights"] = np.asarray(kw["weights"]).tolist()
        meta = dict(saves[0][0][2])
        meta.pop("platforms")
        seen[side] = (examples[0][0][1], examples[0][1], _norm(kw, w), meta, list(rest[-1]["rgb"].shape))
    assert seen["port"] == seen["jax"]


# ----------------------------------------------------------------------
# Real runs on the CPU
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """tests/test_cli.py's folds dataset: 6 scenes × 2 mp4 clips, 3 classes."""
    root = tmp_path_factory.mktemp("videos")
    jsynthetic.generate_synthetic_dataset(str(root), num_scenes=6, clips_per_scene=2, num_classes=3, num_frames=6,
                                          hw=(32, 32), as_videos=True)
    return str(root)


def test_folds_csvs_byte_equal_jax(pcli, videos, tmp_path, capsys):
    for side, main in (("jax", jcli.main), ("port", lambda a: pcli.main(a, device="cpu"))):
        assert main(["folds", "-df", videos, "-pff", str(tmp_path / side), "-fn", "3"]) == 0
    assert _lines(capsys.readouterr().out, tmp_path / "jax", tmp_path / "port") == ["folds written to <root>/3_folds"] * 2
    for i in range(3):
        rel = f"3_folds/fold{i}.csv"
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_train_command_equals_train_member(torch, pcli, port, ws, tiny_builds, tmp_path, capsys):
    """`train -t 2 -v 0` writes the checkpoint and history that a direct
    `train_member` of the same config writes, bit for bit."""
    roots = {}
    for side in ("cli", "api"):
        roots[side] = str(tmp_path / side)
        shutil.copytree(ws.work, roots[side])
    assert pcli.main(["train", "--work-dir", roots["cli"], *BASE, "-t", "2", "-v", "0"], device="cpu") == 0
    printed = capsys.readouterr().out.strip()
    out = port.orchestration.train_member(ws.cfg, port.orchestration.WorkLayout(roots["api"]), 2, 0, device="cpu")
    assert printed == (f"test_acc={out['test_accuracy']:.4f} test_loss={out['test_loss']:.4f} "
                       f"best_val_loss={out['best_val_loss']:.4f}")
    layouts = {s: port.orchestration.WorkLayout(r) for s, r in roots.items()}
    got, want = (port.checkpoints.restore_best(layouts[s].checkpoint_dir(ws.cfg, 2, 0)) for s in ("cli", "api"))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    np.testing.assert_array_equal(*(np.load(layouts[s].history_path(ws.cfg, 2, 0)) for s in ("cli", "api")))


def test_probs_command_equals_cache_probabilities(pcli, port, ws, tiny_builds, capsys):
    assert pcli.main(["probs", "--work-dir", ws.work, *BASE, "-t", "0", "--recompute"], device="cpu") == 0
    path = capsys.readouterr().out.strip()
    store = port.probability_store
    got = store.load_probabilities(path)
    again = port.orchestration.cache_probabilities(ws.cfg, ws.layout, 0, recompute=True, device="cpu")
    assert again == path
    want = store.load_probabilities(again)
    assert got["probs"].shape == (2, 9, CLASSES)
    for k in ("probs", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["member_names"]) == list(want["member_names"])


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    """tests/test_cli.py's cached probabilities and histories, written into
    a JAX and a port workspace alike."""
    root = tmp_path_factory.mktemp("cached")
    cfg = jconfig.ExperimentConfig(model_type="C3D", folds_number=FOLDS, num_classes=CLASSES)
    rng = np.random.default_rng(0)
    for t in range(FOLDS):
        labels = rng.integers(0, 3, 20)
        probs = np.where(rng.random((2, 20, 1)) < 0.8, np.eye(3)[labels][None],
                         rng.dirichlet(np.ones(3), (2, 20))).astype(np.float32)
        for side in ("jax", "port"):
            layout = jorch.WorkLayout(str(root / side))
            for subset in ("test", "train_val"):
                j_save_probabilities(probability_cache_path(layout.probs_dir, cfg.subfolder_name(), t, subset),
                                     probs, labels, [f"m{t}0", f"m{t}1"])
            for v in [x for x in range(FOLDS) if x != t]:
                hp = layout.history_path(cfg, t, v)
                os.makedirs(os.path.dirname(hp), exist_ok=True)
                np.save(hp, np.asarray([1.0, 0.5 + 0.1 * v], np.float32))
    targets = {}
    for name, tolerance in (("tight", 1.0), ("loose", 100.0)):
        targets[name] = root / f"targets_{name}.json"
        targets[name].write_text(json.dumps({"tolerance_pp": tolerance, "targets": {
            cfg.subfolder_name(): {"mean_accuracy": 0.5}, "GLOBAL": {"mean_accuracy": 0.5}}}))
    return SimpleNamespace(root=root, cfg=cfg, targets={k: str(v) for k, v in targets.items()})


ENSEMBLE = {
    "sum": ["--operation", "evaluate", "-wt", "SUM"],
    "vei": ["--operation", "evaluate", "-wt", "VALIDATION_ERROR_INVERSE"],
    "grid": ["--operation", "evaluate", "-wt", "GRID_SEARCH"],
    "global": ["--operation", "global", "--assert-targets", "{loose}"],
    "combine": ["--operation", "combine", "-ml", "C3D_SCRATCH"],
    "targets_pass": ["--operation", "evaluate", "-wt", "SUM", "--assert-targets", "{loose}"],
    "targets_miss": ["--operation", "evaluate", "-wt", "SUM", "--assert-targets", "{tight}"],
}


@pytest.mark.parametrize("case", ENSEMBLE)
def test_ensemble_byte_equal_jax(pcli, cached, case, capsys):
    """Exit code, printed lines, the results CSV and the learned-weights
    npy equal JAX's CLI's on the same cached probabilities."""
    out = {}
    for side in ("jax", "port"):
        w = cached.root / side
        argv = ["ensemble", "--work-dir", str(w), "-mt", "C3D", "-fn", str(FOLDS), "--num-classes", str(CLASSES),
                *(a.format(**cached.targets) for a in ENSEMBLE[case])]
        shutil.rmtree(w / "Results", ignore_errors=True)
        rc = jcli.main(argv) if side == "jax" else pcli.main(argv, device="cpu")
        results = w / "Results"
        files = {p.name: p.read_bytes() for p in sorted(results.iterdir())} if results.exists() else {}
        out[side] = (rc, _lines(capsys.readouterr().out, w), files)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (1 if case == "targets_miss" else 0)
    assert case == "combine" or out["port"][2]


REPORTS = {
    "confusion": ["--operation", "confusion"],
    "difference": ["--operation", "difference"],
    "agreement": ["--operation", "agreement"],
    "agreement_train_val": ["--operation", "agreement", "--subset", "train_val"],
    "global_confusion": ["--operation", "confusion", "--scope", "global"],
    "global_difference": ["--operation", "difference", "--scope", "global", "-ml", "C3D_SCRATCH"],
}
RENDERERS = ("render_confusion_grid_pdf", "render_difference_pdf", "render_agreement_pdf")


@pytest.mark.parametrize("case", REPORTS)
def test_report_matrices_equal_jax(pcli, port, cached, case, monkeypatch, capsys):
    """With the renderers recorded on both sides: the same PDF names, in
    order, and equal matrices."""
    out = {}
    for side, mod in (("jax", jreports), ("port", port.reports)):
        w = cached.root / side
        calls = {name: _recorder(monkeypatch, mod, name, lambda data, path, **kw: path) for name in RENDERERS}
        argv = ["report", "--work-dir", str(w), "-mt", "C3D", "-fn", str(FOLDS), "--num-classes", str(CLASSES),
                *REPORTS[case]]
        assert (jcli.main(argv) if side == "jax" else pcli.main(argv, device="cpu")) == 0
        out[side] = (_lines(capsys.readouterr().out, w),
                     {n: [(os.path.basename(a[1]), np.asarray(a[0], np.float64), k) for a, k in c]
                      for n, c in calls.items()})
    assert out["port"][0] == out["jax"][0] and out["port"][0]
    for name in RENDERERS:
        got, want = out["port"][1][name], out["jax"][1][name]
        assert [(g[0], g[2]) for g in got] == [(x[0], x[2]) for x in want]
        assert all(np.array_equal(g[1], x[1]) for g, x in zip(got, want))


def test_report_without_matplotlib_exits_2(pcli, cached, monkeypatch, capsys, tmp_path):
    work = tmp_path / "work"
    shutil.copytree(cached.root / "port", work)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    before = sorted(p.relative_to(work) for p in work.rglob("*"))
    assert pcli.main(["report", "--work-dir", str(work), "-mt", "C3D", "-fn", str(FOLDS)], device="cpu") == 2
    assert "matplotlib" in capsys.readouterr().err
    assert sorted(p.relative_to(work) for p in work.rglob("*")) == before


def test_export_then_serve_equal_eager(torch, pcli, port, ws, tiny_builds, tmp_path, capsys):
    """Test fold 0's members exported baked and lean, then its test split
    served: predictions equal to the fused argmax of the members' eager
    `member_probabilities`, the CSV byte-equal to pandas' `to_csv` of the
    same rows; a lean artifact without --work-dir exits 2."""
    csv = ws.layout.split_csv(0, 1, "test")
    bundles, _ = pcli._fold_members(ws.cfg, ws.layout, 0, torch.device("cpu"))
    pipe = port.pipeline.BatchPipeline(port.table.ClipTable.read_csv(csv), port.pipeline.SampleSpec(16, (112, 112)),
                                       4, shuffle=False, num_workers=2)
    eager = port.members.member_probabilities([b.module for b in bundles], pipe, (112, 112))
    want = np.argmax(eager.sum(0), -1)
    for form in ([], ["--no-bake-params"]):
        art = str(tmp_path / f"a{len(form)}.zip")
        assert pcli.main(["export", "--work-dir", ws.work, *BASE, "-t", "0", "--out", art, "--serve-batch", "4",
                          *form], device="cpu") == 0
        assert capsys.readouterr().out.strip() == art
        serve = ["serve", "--artifact", art, "--csv", csv, "--num-workers", "2"]
        if form:
            assert pcli.main(serve, device="cpu") == 2
            assert "--work-dir" in capsys.readouterr().err
            serve += ["--work-dir", ws.work]
        assert pcli.main(serve, device="cpu") == 0
        lines = capsys.readouterr().out.strip().splitlines()
        out_csv = art[:-4] + "_predictions.csv"
        assert lines == [f"accuracy: {float(np.mean(want == pd.read_csv(csv)['class'].values)):.4f} over 9 clips",
                         out_csv]
        df = pd.read_csv(csv)
        np.testing.assert_array_equal(pd.read_csv(out_csv)["prediction"].values, want)
        df["prediction"] = want
        df.to_csv(tmp_path / "pandas.csv", index=False)
        assert Path(out_csv).read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def _trained_member(port, layout, cfg):
    """Member (2, 0)'s best checkpoint and history in `layout`."""
    return (port.checkpoints.restore_best(layout.checkpoint_dir(cfg, 2, 0)),
            np.load(layout.history_path(cfg, 2, 0)))


def _assert_same_member(torch, got, want, start):
    """Two trainings of one member from `start`, one over a data mesh: the
    same update within bf16's rounding (the width-0.125 C3D computes in
    bf16, and each position's weight gradient is rounded to bf16 apart
    before the sum: |Δ| ≤ 1 % of the update's largest element, tensor by
    tensor; 0.5 % measured) and the same val losses within bf16's 2^-8
    (rtol 1e-2; 0.19 % measured)."""
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        update = (want[0][k] - start[k]).abs().max().item()
        diff = (got[0][k] - want[0][k]).abs().max().item()
        assert diff <= 0.01 * update, (k, diff, update)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-2)


@pytest.mark.parametrize("command", ["train", "launch", "export"])
def test_mesh_flags_run(torch, pcli, port, ws, tiny_builds, tmp_path, capsys, command):
    """The mesh flags run on the CPU positions and equal their unsharded
    forms: `train --mesh-data 2` and `launch --recover --mesh-data 2` (the
    one pending member) train member (2, 0) as the unsharded `train_member`
    does; `export --mesh-member 2 --mesh-data 2` writes a mesh artifact
    whose `serve` predicts what the single-card baked artifact does (and
    without --mesh-data exits 2)."""
    orch = port.orchestration
    if command == "export":
        args = ["export", "--work-dir", ws.work, *BASE, "-t", "0", "--serve-batch", "4"]
        assert pcli.main([*args, "--out", str(tmp_path / "m.zip"), "--mesh-member", "2"], device="cpu") == 2
        assert "--mesh-data" in capsys.readouterr().err
        csv = ws.layout.split_csv(0, 1, "test")
        preds = {}
        for name, extra in (("single", []), ("mesh", ["--mesh-member", "2", "--mesh-data", "2"])):
            art = str(tmp_path / f"{name}.zip")
            assert pcli.main([*args, "--out", art, *extra], device="cpu") == 0
            serve = ["serve", "--artifact", art, "--csv", csv, "--num-workers", "2", "--work-dir", ws.work]
            assert pcli.main(serve, device="cpu") == 0
            preds[name] = pd.read_csv(art[:-4] + "_predictions.csv")["prediction"].values
            meta = port.serving.load_serving_artifact(art, "cpu")[1]
            assert meta["mesh"] == ({"member": 2, "data": 2} if extra else None)
            assert meta["params_baked"] is not bool(extra)
        capsys.readouterr()
        np.testing.assert_array_equal(preds["mesh"], preds["single"])
        return
    roots = {s: str(tmp_path / s) for s in ("mesh", "plain")}
    for root in roots.values():
        shutil.copytree(ws.work, root)
    layouts = {s: orch.WorkLayout(r) for s, r in roots.items()}
    if command == "train":
        argv = ["train", "--work-dir", roots["mesh"], *BASE, "-t", "2", "-v", "0", "--mesh-data", "2"]
    else:  # every member but (2, 0) complete: the recovery trains it alone
        done = layouts["mesh"]
        for t, v in ((1, 0), (1, 2), (2, 1)):
            shutil.copytree(done.checkpoint_dir(ws.cfg, 0, 1), done.checkpoint_dir(ws.cfg, t, v))
            shutil.copy(done.history_path(ws.cfg, 0, 1), done.history_path(ws.cfg, t, v))
        assert orch.pending_members(ws.cfg, done) == [(2, 0)]
        argv = ["launch", "--work-dir", roots["mesh"], *BASE, "--recover", "--mesh-data", "2"]
    assert pcli.main(argv, device="cpu") == 0
    capsys.readouterr()
    orch.train_member(ws.cfg, layouts["plain"], 2, 0, device="cpu")
    start = tiny_builds("C3D", CLASSES, device="cpu", trainable=True,
                        generator=torch.Generator().manual_seed(2000)).module.state_dict()
    _assert_same_member(torch, _trained_member(port, layouts["mesh"], ws.cfg),
                        _trained_member(port, layouts["plain"], ws.cfg), start)


@pytest.mark.parametrize("argv,error,words", [
    (["probs", "--work-dir", "{w}", *BASE, "-t", "0", "--fuse-1x1"], None, "fuse_1x1"),
    (["ensemble", "--work-dir", "{w}", *BASE, "--fuse-1x1"], None, "fuse_1x1"),
    (["convert", "--fetch-rgb", "rgb_kinetics_only", "--cache-dir", "{tmp}", "--out", "x.pt"], FileNotFoundError,
     "{tmp}/i3d_inception_rgb_kinetics_only_no_top.h5"),
    (["convert", "--rgb-h5", "a.h5", "--out", "x.msgpack"], ValueError, ".pt"),
])
def test_unported_flags_raise(torch, pcli, port, ws, tiny_builds, monkeypatch, capsys, argv, error, words, tmp_path):
    """What the port refuses raises.  `probs` and `ensemble --fuse-1x1`,
    refused until the fused 1³ convs were ported, run: every
    cache_probabilities call takes fuse_1x1=True (each fold's reads test
    fold 0's members, the ones the workspace holds), and the probabilities
    equal the unfused cache's (C3D members: the rewrite is the I3D
    family's, as in JAX)."""
    if error is None:
        orch = port.orchestration
        real, seen = orch.cache_probabilities, []

        def fold0(config, layout, t, *args, **kw):
            seen.append(kw[words])
            return real(config, layout, 0, *args, **kw)

        monkeypatch.setattr(orch, "cache_probabilities", fold0)
        assert pcli.main([a.replace("{w}", ws.work) for a in argv], device="cpu") == 0
        capsys.readouterr()
        assert seen and all(seen)
        store = port.probability_store
        fused = store.load_probabilities(real(ws.cfg, ws.layout, 0, device="cpu"))
        unfused = store.load_probabilities(real(ws.cfg, ws.layout, 0, recompute=True, device="cpu"))
        np.testing.assert_array_equal(fused["probs"], unfused["probs"])
        return
    with pytest.raises(error, match=re.escape(words.replace("{tmp}", str(tmp_path)))):
        pcli.main([a.replace("{tmp}", str(tmp_path)) for a in argv], device="cpu")
    assert not os.listdir(tmp_path)


def test_bench_says_it_is_not_ported(pcli, capsys):
    assert pcli.main(["bench"]) == 2
    assert "ROADMAP Queue 1 item 1" in capsys.readouterr().err


def test_module_runs_without_jax_pandas_h5py_matplotlib(pcli, port, ws):
    """`python -m <port> --help` exits 0, and an emitted `train` command
    reaches the command line and stops at the missing card (hidden), not at
    a missing `__main__`, with jax, pandas, h5py and matplotlib blocked."""
    cmd = port.orchestration.member_cli_commands(ws.cfg, ws.work)[0]
    code = (
        "import runpy, sys, traceback\n"
        "for name in ('jax', 'pandas', 'h5py', 'matplotlib'): sys.modules[name] = None\n"
        f"for argv in ([{PORT!r}, '--help'], {shlex.split(cmd)[2:]!r}):\n"
        "    sys.argv = argv\n"
        "    try:\n"
        f"        runpy.run_module({PORT!r}, run_name='__main__', alter_sys=True)\n"
        "    except SystemExit as e:\n"
        "        print('EXIT', e.code)\n"
        "    except Exception as e:\n"
        "        print('ERROR', type(e).__name__, e)\n"
        "print('LOADED', sorted({'jaxlib', 'flax', 'crowded_scenes_ensemble_classification_tpu'}\n"
        "                       & {k.split('.')[0] for k in sys.modules}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("usage: crowded_scenes_ensemble_classification_tpu_torch")
    assert "EXIT 0" in lines
    assert lines[-2] == "ERROR RuntimeError no CUDA device: this path runs only on the GPU"
    assert lines[-1] == "LOADED []"
