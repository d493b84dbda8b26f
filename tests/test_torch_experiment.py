"""The port's experiment layer against the JAX package on the CPU:
`ExperimentConfig` names and JSON, the manifest, `prepare_ensemble`'s
workspace (fold and split CSVs byte for byte), member commands, offline
augmentation (CSVs byte for byte, the single-clip policy's uint8 frames on
JAX's decisions), `cache_probabilities` of carried-across members
(1e-4 in f32) and its npz names, one `train_member`, the providers into
`evaluate_ensembles`, the report matrices, the streaming windows and the
metrics stream.

Small sizes: the workspace of tests/test_end_to_end.py (9 scenes × 3 clips,
3 classes, 16 frames at 40×40, .npy clips, 3 folds) and a width-0.125 C3D
at 16×32²; the offline-augmentation fixture of tests/test_augment_offline.py
(8 mp4 clips of 6 frames at 48×64, 2 folds).  No JAX training runs and no
full-width model is built.  torch and the port are imported by fixtures,
not at collection (tests/torch_port_memory.py).
"""

import dataclasses
import filecmp
import importlib
import itertools
import json
import os
import shutil

import jax
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu import orchestration as jorch
from crowded_scenes_ensemble_classification_tpu.core import config as jconfig
from crowded_scenes_ensemble_classification_tpu.core import manifest as jmanifest
from crowded_scenes_ensemble_classification_tpu.data import augment_offline as jaug_off
from crowded_scenes_ensemble_classification_tpu.data import synthetic as jsynthetic
from crowded_scenes_ensemble_classification_tpu.data.folds import generate_folds as j_generate_folds
from crowded_scenes_ensemble_classification_tpu.ops import augment as jaugment
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES, FOLDS, CLIP_THW, STAGING = 3, 3, (16, 32, 32), (40, 40)


def _port(name):
    return importlib.import_module(f"{PORT}.{name}")


@pytest.fixture(scope="module")
def orch(torch):
    return _port("orchestration")


@pytest.fixture(scope="module")
def pconfig(torch):
    return _port("core.config")


def _configs(cfg_mod, **fixed):
    """ExperimentConfigs over every model type × condition × augmentation ×
    flow × classes status."""
    for mt, cond, aug, of, cs in itertools.product(
        cfg_mod.MODEL_TYPES, cfg_mod.TRAINING_CONDITIONS, cfg_mod.AUGMENTATION_STATUSES,
        cfg_mod.OPTICAL_FLOW_STATUSES, cfg_mod.CLASSES_STATUSES,
    ):
        yield cfg_mod.ExperimentConfig(model_type=mt, training_condition=cond, augmentation_status=aug,
                                       optical_flow_status=of, classes_status=cs, **fixed)


def test_tables_equal_jax(pconfig):
    for name in ("MODEL_TYPES", "TRAINING_CONDITIONS", "CLASSES_STATUSES", "AUGMENTATION_STATUSES",
                 "OPTICAL_FLOW_STATUSES", "WEIGHTING_SCHEMES"):
        assert getattr(pconfig, name) == getattr(jconfig, name), name
    assert [f.name for f in dataclasses.fields(pconfig.ExperimentConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ExperimentConfig)]
    assert dataclasses.asdict(pconfig.ExperimentConfig()) == dataclasses.asdict(jconfig.ExperimentConfig())


@pytest.mark.parametrize("folds,freq", [(3, 1), (5, 3)])
def test_experiment_config_names_and_json_equal_jax(orch, pconfig, folds, freq):
    """Every legacy artifact name equal string for string, the JSON equal
    byte for byte, and each package's JSON loads in the other."""
    fixed = dict(folds_number=folds, augmentation_frequency=freq, input_scale=1 / 255.0, epochs=7)
    for p, j in zip(_configs(pconfig, **fixed), _configs(jconfig, **fixed)):
        for t, v in pconfig.split_pairs(folds):
            assert p.artifact_stem(t, v) == j.artifact_stem(t, v)
            assert p.weights_relpath(t, v) == j.weights_relpath(t, v)
            assert p.history_relpath(t, v) == j.history_relpath(t, v)
        assert p.subfolder_name() == j.subfolder_name() and p.split_suffix(1, 2) == j.split_suffix(1, 2)
        assert (p.clip.rgb_shape, p.is_two_stream) == (j.clip.rgb_shape, j.is_two_stream)
        assert p.to_json() == j.to_json()
        assert jconfig.ExperimentConfig.from_json(p.to_json()) == j
        assert pconfig.ExperimentConfig.from_json(j.to_json()) == p
        for subset in ("test", "train_val"):
            assert orch.reference_probabilities_csv_name(p, subset) == jorch.reference_probabilities_csv_name(j, subset)
    assert pconfig.split_pairs(folds) == jconfig.split_pairs(folds)
    assert all(pconfig.member_val_indices(folds, t) == jconfig.member_val_indices(folds, t) for t in range(folds))


def test_config_validation_and_file_round_trip(pconfig, tmp_path):
    for bad in (dict(model_type="VGG"), dict(folds_number=2), dict(flow_schedule="fast"),
                dict(augmentation_status="x"), dict(training_condition="_X")):
        with pytest.raises(ValueError):
            pconfig.ExperimentConfig(**bad)
        with pytest.raises(ValueError):
            jconfig.ExperimentConfig(**bad)
    cfg = pconfig.ExperimentConfig("I3D", flow_schedule="turbo", flow_from_augmented=True)
    cfg.save(str(tmp_path / "p" / "experiment.json"))
    assert jconfig.ExperimentConfig.load(str(tmp_path / "p" / "experiment.json")) == jconfig.ExperimentConfig(
        "I3D", flow_schedule="turbo", flow_from_augmented=True)
    jconfig.ExperimentConfig("R3D_50").save(str(tmp_path / "j.json"))
    assert pconfig.ExperimentConfig.load(str(tmp_path / "j.json")) == pconfig.ExperimentConfig("R3D_50")


def test_parse_global_model_specs_equal_jax(orch):
    specs = ["I3D_PRETRAINED", "C3D_SCRATCH", "R3D_18_SCRATCH", "SPECIALCASE_TWOSTREAM"]
    p, j = orch.parse_global_model_specs(specs, 5, 11), jorch.parse_global_model_specs(specs, 5, 11)
    assert {k: v.to_json() for k, v in p.items()} == {k: v.to_json() for k, v in j.items()}
    with pytest.raises(ValueError):
        orch.parse_global_model_specs(["I3D"])


def test_manifest_json_equal_jax(torch, tmp_path):
    """The same records give the same JSON apart from the timestamp, and
    each package loads the other's."""
    pman = _port("core.manifest")
    out = {}
    for side, mod, cfg_mod in (("port", pman, _port("core.config")), ("jax", jmanifest, jconfig)):
        m = mod.Manifest(str(tmp_path / side), cfg_mod.ExperimentConfig("I3D", folds_number=3))
        for i in range(3):
            m.add(mod.ArtifactRecord("fold_csv", f"Folds/3_folds/fold{i}.csv", test_index=i, fmt="csv"), save=False)
        m.add(mod.ArtifactRecord("probabilities", "Probabilities/x.npz", 0, None, meta={"n": 4}))
        m.add(mod.ArtifactRecord("probabilities", "Probabilities/x.npz", 0, None, meta={"n": 5}))  # replaces
        assert len(m.find("fold_csv")) == 3 and len(m.find("probabilities", test_index=0)) == 1
        with open(m.path) as f:
            out[side] = json.load(f)
        out[side].pop("saved_at")
    assert out["port"] == out["jax"]
    assert [dataclasses.asdict(r) for r in jmanifest.Manifest.load(str(tmp_path / "port")).records] == \
        out["port"]["records"]
    assert pman.Manifest.load(str(tmp_path / "jax")).config == _port("core.config").ExperimentConfig(
        "I3D", folds_number=3)


# ----------------------------------------------------------------------
# The workspace: prepare_ensemble of both packages on one dataset
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(orch, pconfig, tmp_path_factory):
    """tests/test_end_to_end.py's synthetic dataset (.npy clips), prepared by
    each package into its own work dir: {"jax": (config, layout), "port": ...}."""
    root = tmp_path_factory.mktemp("experiment")
    df = jsynthetic.generate_synthetic_dataset(str(root / "data"), num_scenes=9, clips_per_scene=3,
                                               num_classes=CLASSES, num_frames=16, hw=STAGING, as_videos=False)
    df.to_csv(root / "clips.csv", index=False)
    table = _port("data.table").ClipTable.read_csv(str(root / "clips.csv"))
    fields = dict(model_type="C3D", training_condition="_SCRATCH", folds_number=FOLDS, num_classes=CLASSES,
                  batch_size=6, epochs=3, compute_dtype="float32")
    jcfg, pcfg = jconfig.ExperimentConfig(**fields), pconfig.ExperimentConfig(**fields)
    return {
        "jax": (jcfg, jorch.prepare_ensemble(jcfg, df, str(root / "jax"))),
        "port": (pcfg, orch.prepare_ensemble(pcfg, table, str(root / "port"), device="cpu")),
    }


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs + [""])


def test_prepare_ensemble_matches_jax(workspace):
    """The same directory tree, fold and split CSVs byte for byte, the same
    experiment.json and manifest (apart from its timestamp)."""
    (jcfg, jl), (pcfg, pl) = workspace["jax"], workspace["port"]
    assert _tree(pl.root) == _tree(jl.root)
    files = [f for f in _tree(jl.root) if f.endswith((".csv", ".json")) and f != "manifest.json"]
    assert len(files) == FOLDS + 3 * FOLDS * (FOLDS - 1) + 1
    for rel in files:
        assert filecmp.cmp(os.path.join(pl.root, rel), os.path.join(jl.root, rel), shallow=False), rel
    man = [json.load(open(os.path.join(r, "manifest.json"))) for r in (pl.root, jl.root)]
    assert [{k: v for k, v in m.items() if k != "saved_at"} for m in man][0] == \
        [{k: v for k, v in m.items() if k != "saved_at"} for m in man][1]
    for attr in ("folds_dir", "splits_dir", "augmented_dir", "models_dir", "probs_dir", "results_dir"):
        assert os.path.relpath(getattr(pl, attr), pl.root) == os.path.relpath(getattr(jl, attr), jl.root)
    assert os.path.relpath(pl.checkpoint_dir(pcfg, 0, 2), pl.root) == os.path.relpath(jl.checkpoint_dir(jcfg, 0, 2),
                                                                                       jl.root)


def test_member_cli_commands_match_jax(orch, pconfig):
    """Equal to JAX's commands once the module name is swapped, with every
    optional flag and with a pair list."""
    for extra, kw in (({}, {}), (dict(input_scale=0.5, flow_from_augmented=True, flow_schedule="turbo"),
                                 dict(rgb_h5="r.h5", flow_h5="f.h5", resident=True, pairs=[(1, 0), (2, 1)]))):
        fields = dict(model_type="TWOSTREAM_I3D", folds_number=4, **extra)
        got = orch.member_cli_commands(pconfig.ExperimentConfig(**fields), "/w", **kw)
        want = jorch.member_cli_commands(jconfig.ExperimentConfig(**fields), "/w", **kw)
        assert got == [c.replace("crowded_scenes_ensemble_classification_tpu ",
                                 "crowded_scenes_ensemble_classification_tpu_torch ") for c in want]
        assert len(got) == (12 if "pairs" not in kw else 2)


def _tiny_bundle(torch, trainable=False, seed=0):
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle

    spec = _port("core.config").ClipSpec(*CLIP_THW)
    module = C3D(CLASSES, width=0.125, clip_thw=CLIP_THW, generator=torch.Generator().manual_seed(seed))
    return ModelBundle("C3D", module if trainable else module.eval(), spec, CLASSES, False, trainable=trainable)


def _tiny_build_with_condition(torch):
    """A stand-in for `build_with_condition` that draws the tiny C3D from
    `seed` (the full-width draw takes seconds on the CPU)."""
    def build(config, seed=0, **kw):
        bundle = _tiny_bundle(torch, trainable=True, seed=seed)
        return bundle, bundle.module.state_dict()

    return build


_JAX_TEMPLATES = {}


def _tiny_jax_bundle():
    """JAX's width-0.125 C3D at 16×32².  Its `init` returns zeros of the
    variables' shapes (from `jax.eval_shape`): JAX `_member_variables` uses
    it only as the restore template, and flax's eager init takes ~20 s."""
    from crowded_scenes_ensemble_classification_tpu.models import C3D as JC3D
    from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle

    class Bundle(ModelBundle):
        def init(self, key, batch_size=1):
            if "c3d" not in _JAX_TEMPLATES:
                _JAX_TEMPLATES["c3d"] = jax.eval_shape(lambda k: super(Bundle, self).init(k, batch_size), key)
            return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), _JAX_TEMPLATES["c3d"])

    return Bundle("C3D", JC3D(num_classes=CLASSES, width=0.125), jconfig.ClipSpec(*CLIP_THW), CLASSES, False)


@pytest.fixture(scope="module")
def members(torch, workspace):
    """Test fold 0's two members: seeded JAX variables saved by JAX in its
    layout and, converted by `state_dict_from_flax`, by the port in its;
    identical histories in both."""
    from crowded_scenes_ensemble_classification_tpu.train.checkpoints import save_best as j_save_best
    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import state_dict_from_flax
    from crowded_scenes_ensemble_classification_tpu_torch.train.checkpoints import save_best

    from crowded_scenes_ensemble_classification_tpu.train import checkpoints as jcheckpoints

    (jcfg, jl), (pcfg, pl) = workspace["jax"], workspace["port"]
    jb = _tiny_jax_bundle()
    shapes = jb.init(jax.random.key(0))
    for v in (1, 2):
        rng = np.random.default_rng(v)
        variables = jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10.0)
                       ).astype(np.float32), shapes)
        with pytest.MonkeyPatch.context() as mp:  # JAX's msgpack form: orbax's first save takes ~4 s
            mp.setattr(jcheckpoints, "_multiprocess", lambda: True)
            j_save_best(jl.checkpoint_dir(jcfg, 0, v), variables)
        save_best(pl.checkpoint_dir(pcfg, 0, v), state_dict_from_flax("C3D", variables))
        history = np.asarray([2.0, 1.5 / v, 1.7], np.float32)
        for path in (jl.history_path(jcfg, 0, v), pl.history_path(pcfg, 0, v)):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, history)
    return jb


@pytest.fixture(scope="module")
def cached(torch, orch, workspace, members):
    """cache_probabilities of both packages for test fold 0: the standard
    window and a long-video scan (32 frames, stride 8), npz paths and
    loaded contents."""
    from crowded_scenes_ensemble_classification_tpu.ensemble.probability_store import load_probabilities

    (jcfg, jl), (pcfg, pl) = workspace["jax"], workspace["port"]
    bundle = _tiny_bundle(torch)
    out = {}
    for name, kw in (("window", {}), ("long", dict(long_video=True, long_frames=32, window_stride=8))):
        jp = jorch.cache_probabilities(jcfg, jl, 0, "test", bundle=members, staging_hw=STAGING, num_workers=2, **kw)
        pp = orch.cache_probabilities(pcfg, pl, 0, "test", bundle=bundle, staging_hw=STAGING, num_workers=2,
                                      device="cpu", **kw)
        out[name] = (jp, pp, load_probabilities(jp), load_probabilities(pp))
    return out


@pytest.mark.parametrize("form", ["window", "long"])
def test_cache_probabilities_match_jax(cached, workspace, form):
    """f32 probabilities within 1e-4 of JAX's on the same members, the same
    labels and member names, and the same npz name."""
    jp, pp, j, p = cached[form]
    assert os.path.relpath(pp, workspace["port"][1].root) == os.path.relpath(jp, workspace["jax"][1].root)
    assert p["probs"].shape == (2, len(p["labels"]), CLASSES)
    np.testing.assert_allclose(p["probs"], j["probs"], atol=1e-4)
    np.testing.assert_array_equal(p["labels"], j["labels"])
    assert p["member_names"] == j["member_names"]


def test_cache_probabilities_reuses_its_cache(torch, orch, workspace, cached):
    """A second call returns the cached path without computing (no bundle,
    so a recompute would have to build a full-size model)."""
    pcfg, pl = workspace["port"]
    _, pp, _, _ = cached["window"]
    mtime = os.path.getmtime(pp)
    assert orch.cache_probabilities(pcfg, pl, 0, "test", device="cpu") == pp
    assert os.path.getmtime(pp) == mtime


@pytest.mark.parametrize("model_type,kw", [
    ("C3D", {}),
    ("C3D", dict(quant=True)),
    ("C3D", dict(quant="dynamic")),
    ("C3D", dict(quant="static")),
    ("I3D", dict(quant="static", quant_blocks="mixed")),
    ("I3D", dict(quant="static", quant_blocks="Mixed_4f,Conv3d_1a_7x7,Mixed_5c")),
    ("I3D", dict(long_video=True, quant="static", quant_blocks=["Mixed_5b"])),
    ("I3D", dict(long_video=True)),
    ("R3D_18", dict(long_video=True, long_frames=40, window_stride=4, quant=True)),
    ("C3D", dict(subset="train_val")),
])
def test_probability_npz_names_match_jax(orch, pconfig, workspace, monkeypatch, model_type, kw):
    """Every variant's npz path equal to JAX's (each package told its cache
    exists, so neither computes)."""
    monkeypatch.setattr(jorch, "probabilities_exist", lambda path: True)
    monkeypatch.setattr(orch, "probabilities_exist", lambda path: True)
    kw = dict(kw)
    subset = kw.pop("subset", "test")
    fields = dict(model_type=model_type, folds_number=FOLDS, num_classes=CLASSES)
    jp = jorch.cache_probabilities(jconfig.ExperimentConfig(**fields), jorch.WorkLayout("/w"), 1, subset,
                                   bundle=_tiny_jax_bundle(), **kw)
    pp = orch.cache_probabilities(pconfig.ExperimentConfig(**fields), orch.WorkLayout("/w"), 1, subset,
                                  device="cpu", **kw)
    assert pp == jp


def test_cache_probabilities_refusals(orch, workspace):
    pcfg, pl = workspace["port"]
    for kw, words in ((dict(mesh=object()), "item 7"), (dict(fuse_1x1=True), "item 8"),
                      (dict(quant_blocks="mixed", quant="static"), "I3D-family"),
                      (dict(subset="val"), "unknown subset")):
        kw = dict(kw)
        subset = kw.pop("subset", "test")
        with pytest.raises(ValueError, match=words):
            orch.cache_probabilities(pcfg, pl, 0, subset, recompute=True, device="cpu", **kw)


def test_providers_into_evaluate_ensembles_match_jax(torch, orch, workspace, cached):
    """make_prob_provider (cache hits) and min_val_losses_provider feed
    evaluate_ensembles; SUM and VALIDATION_ERROR_INVERSE results equal
    JAX's on JAX's cached probabilities within their 1e-4."""
    from crowded_scenes_ensemble_classification_tpu.ensemble.evaluate import evaluate_ensembles as j_evaluate
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.evaluate import evaluate_ensembles

    (jcfg, jl), (pcfg, pl) = workspace["jax"], workspace["port"]
    jprov = jorch.make_prob_provider(jcfg, jl, bundle=_tiny_jax_bundle(), staging_hw=STAGING)
    pprov = orch.make_prob_provider(pcfg, pl, staging_hw=STAGING, device="cpu")
    assert orch.min_val_losses_provider(pcfg, pl)(0) == jorch.min_val_losses_provider(jcfg, jl)(0)
    for scheme in ("SUM", "VALIDATION_ERROR_INVERSE"):
        kw = {"min_val_losses_provider": orch.min_val_losses_provider(pcfg, pl)}
        p = evaluate_ensembles(pprov, 1, scheme, device="cpu", **kw)
        j = j_evaluate(jprov, 1, scheme, min_val_losses_provider=jorch.min_val_losses_provider(jcfg, jl))
        fp, fj = p.folds[0], j.folds[0]
        np.testing.assert_array_equal(fp.predictions, fj.predictions)
        assert fp.accuracy == fj.accuracy and fp.member_accuracies == fj.member_accuracies
        np.testing.assert_allclose(np.asarray(fp.weights, np.float64), np.asarray(fj.weights, np.float64),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="item 7"):
        orch.make_prob_provider(pcfg, pl, mesh=object())


def test_reference_csv_provider_matches_jax(torch, orch, workspace, cached, tmp_path):
    """The reference's stringified-CSV cache read through both packages'
    providers: the same rows, labels and names."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.probability_store import export_reference_csv

    (jcfg, jl), (pcfg, pl) = workspace["jax"], workspace["port"]
    jp = cached["window"][0]
    export_reference_csv(jp, str(tmp_path / orch.reference_probabilities_csv_name(pcfg, "test")))
    p = orch.prob_provider_from_reference_csvs(pcfg, pl, str(tmp_path))(0, "test")
    j = jorch.prob_provider_from_reference_csvs(jcfg, jl, str(tmp_path))(0, "test")
    np.testing.assert_array_equal(p["probs"], j["probs"])
    np.testing.assert_array_equal(p["labels"], j["labels"])
    assert p["member_names"] == j["member_names"]
    with pytest.raises(KeyError):
        orch.prob_provider_from_reference_csvs(pcfg, pl, str(tmp_path))(1, "test")


def test_train_member_completes_and_recovery_lists(torch, orch, workspace, members, tmp_path, monkeypatch):
    """One port train_member of 1 epoch on a tiny C3D: the (checkpoint,
    history) pair exists, member_is_complete holds, the metrics stream ends
    in member_done, and a recovery launch's commands name exactly the 5
    pending members.  (Training parity is held by test_torch_train*.py.)"""
    monkeypatch.setattr(orch, "build_with_condition", _tiny_build_with_condition(torch))
    pcfg, _ = workspace["port"]
    work = str(tmp_path / "work")
    shutil.copytree(workspace["port"][1].root, work)
    layout = orch.WorkLayout(work)
    cfg = dataclasses.replace(pcfg, input_scale=1 / 255.0)
    out = orch.train_member(cfg, layout, 1, 2, epochs=1, bundle=_tiny_bundle(torch, trainable=True),
                            staging_hw=STAGING, num_workers=2, device="cpu")
    assert np.isfinite(out["test_loss"]) and len(out["history"]["val_loss"]) == 1
    assert orch.member_is_complete(cfg, layout, 1, 2) and not orch.member_is_complete(cfg, layout, 1, 0)
    assert os.path.exists(os.path.join(out["checkpoint_dir"], "best.pt"))
    records = _port("utils.metrics").MetricsLogger(
        os.path.join(work, "metrics", f"{cfg.artifact_stem(1, 2)}.jsonl")).read()
    assert [r["event"] for r in records] == ["epoch", "member_done"]
    pending = orch.pending_members(cfg, layout)
    assert (1, 2) not in pending and len(pending) == 3  # fold 0's two members are in the copied workspace
    cmds = orch.launch_ensemble_training(cfg, None, work, runner="commands", recover=True)
    assert cmds == orch.member_cli_commands(cfg, work, pairs=pending)


def test_launch_local_shares_one_train_and_eval_step(torch, orch, workspace, monkeypatch, tmp_path):
    """launch_ensemble_training (local) builds one train step and one eval
    step for all its members, and each member starts from the weights that
    `train_member(bundle=None)` would build: a seeded build from
    `seed + 1000·t + v`, weight for weight."""
    pcfg, _ = workspace["port"]
    work = str(tmp_path / "work")
    shutil.copytree(os.path.join(workspace["port"][1].root, "Folds"), os.path.join(work, "Folds"))
    build = _tiny_build_with_condition(torch)
    builds = []
    monkeypatch.setattr(orch, "build_with_condition", lambda config, **kw: (builds.append(kw), build(config, **kw))[1])
    calls = {"train": 0, "eval": 0}
    for name, key in (("make_train_step", "train"), ("make_eval_step", "eval")):
        real = getattr(orch, name)
        monkeypatch.setattr(orch, name, lambda *a, _r=real, _k=key, **kw: (calls.__setitem__(_k, calls[_k] + 1),
                                                                          _r(*a, **kw))[1])
    starts = []
    real_fit = orch.fit
    monkeypatch.setattr(orch, "fit", lambda bundle, *a, **kw: (
        starts.append((bundle, kw["initial_variables"])), real_fit(bundle, *a, **kw))[1])
    results = orch.launch_ensemble_training(pcfg, None, work, members=[(2, 0), (2, 1)], epochs=1,
                                            staging_hw=STAGING, num_workers=2, device="cpu")
    assert sorted(results) == [(2, 0), (2, 1)] and calls == {"train": 1, "eval": 1}
    assert [kw["seed"] for kw in builds] == [0, 2000, 2001]  # the shared bundle, then each member's start
    assert starts[0][0] is starts[1][0]
    for (t, v), (_, start) in zip([(2, 0), (2, 1)], starts):
        want = _tiny_bundle(torch, trainable=True, seed=1000 * t + v).module.state_dict()
        assert start.keys() == want.keys() and all(torch.equal(start[k], want[k]) for k in want)
    assert not torch.equal(starts[0][1]["conv1.weight"], starts[1][1]["conv1.weight"])
    assert orch.launch_ensemble_training(pcfg, None, work, members=[(2, 0)], recover=True) == {}
    with pytest.raises(ValueError, match="item 7"):
        orch.launch_ensemble_training(pcfg, None, work, mesh=object())


# ----------------------------------------------------------------------
# Offline augmentation
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def offline(torch, tmp_path_factory):
    """tests/test_augment_offline.py's fixture: 8 mp4 clips (6 frames,
    48×64), 2 folds; each package augments a copy of the fold CSVs into the
    same augmented folder path, the port first."""
    root = tmp_path_factory.mktemp("offaug")
    df = jsynthetic.generate_synthetic_dataset(str(root / "data"), num_scenes=4, clips_per_scene=2, num_classes=2,
                                               num_frames=6, hw=(48, 64), as_videos=True)
    folds, _ = j_generate_folds(df, str(root / "folds"), nb_folds=2)
    aug = str(root / "augmented")
    out = {}
    for side in ("port", "jax"):
        shutil.copytree(folds, str(root / side))
        out[side] = str(root / side)
    _port("data.augment_offline").augment_folds(out["port"], aug, nb_folds=2, augmentation_frequency=2, device="cpu")
    # JAX's augment_videos run finds every copy written (it skips those, as the
    # port does), so it only rewrites its CSVs: its jit compile takes ~3 s
    mtimes = {f: os.path.getmtime(os.path.join(aug, f)) for f in os.listdir(aug)}
    jaug_off.augment_folds(out["jax"], aug, nb_folds=2, augmentation_frequency=2)
    assert {f: os.path.getmtime(os.path.join(aug, f)) for f in os.listdir(aug)} == mtimes
    return root, aug, out


def _csv_bytes(folder):
    return [open(os.path.join(folder, f"fold{i}.csv"), "rb").read() for i in range(2)]


def test_augment_folds_csvs_byte_equal_and_idempotent(torch, offline):
    """The rewritten fold CSVs equal JAX's byte for byte; every copy exists
    as a 224² mp4; a second call encodes nothing and leaves the CSVs."""
    from crowded_scenes_ensemble_classification_tpu_torch.data import augment_offline, video_io

    root, aug, folds = offline
    assert _csv_bytes(folds["port"]) == _csv_bytes(folds["jax"])
    assert b"rgbclips_augmented_1_path" in _csv_bytes(folds["port"])[0]
    table = _port("data.table").ClipTable.read_csv(os.path.join(folds["port"], "fold0.csv"))
    assert video_io.decode_clip(table["rgbclips_augmented_0_path"][0], 6, None).shape == (6, 224, 224, 3)
    mtimes = {f: os.path.getmtime(os.path.join(aug, f)) for f in os.listdir(aug)}
    assert len(mtimes) == 16
    before = _csv_bytes(folds["port"])
    augment_offline.augment_folds(folds["port"], aug, nb_folds=2, augmentation_frequency=2)  # no device needed
    assert {f: os.path.getmtime(os.path.join(aug, f)) for f in os.listdir(aug)} == mtimes
    assert _csv_bytes(folds["port"]) == before


def test_update_links_byte_equal(torch, offline):
    """update_links rewrites the columns to a new folder without encoding,
    byte-equal to JAX's, on both packages' augmented CSVs."""
    from crowded_scenes_ensemble_classification_tpu_torch.data import augment_offline

    root, _, folds = offline
    moved = str(root / "moved")
    jaug_off.augment_folds(folds["jax"], moved, nb_folds=2, augmentation_frequency=2, operation="update_links")
    augment_offline.augment_folds(folds["port"], moved, nb_folds=2, augmentation_frequency=2,
                                  operation="update_links")
    assert _csv_bytes(folds["port"]) == _csv_bytes(folds["jax"]) and os.listdir(moved) == []
    with pytest.raises(ValueError):
        augment_offline.augment_folds(folds["port"], moved, 2, 1, operation="move")


def test_offline_copies_replay_bit_equal(torch, offline, tmp_path):
    """A copy's frames are a pure function of (seed, fold, clip, frequency):
    the same seed gives the same uint8 frames, another seed others."""
    from crowded_scenes_ensemble_classification_tpu_torch.data import augment_offline

    _, _, folds = offline
    table = _port("data.table").ClipTable.read_csv(os.path.join(folds["port"], "fold1.csv"))
    clip = augment_offline._load_full_clip(table["rgbclips_path"][0])
    seeds = [augment_offline.offline_seed(0, 1, 0, f) for f in (0, 0, 1)]
    assert seeds[0] == seeds[1] != seeds[2]
    assert seeds[0] == int(np.random.SeedSequence([0, 1, 0, 0]).generate_state(1, np.uint64)[0])
    a, b, c = (augment_offline.augment_clip(clip, s, "cpu") for s in seeds)
    assert a.dtype == np.uint8 and a.shape == (6, 224, 224, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.fixture(scope="module")
def j_augment():
    """JAX crowd11_augment at 56×48, p=0.85, without and with noise, in one jit."""
    return jax.jit(lambda c, k: tuple(jaugment.crowd11_augment(c, k, (56, 48), p=0.85, apply_noise=n)
                                      for n in (False, True)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("noise", [False, True])
def test_crowd11_augment_u8_matches_jax(torch, j_augment, seed, noise):
    """The single-clip policy's uint8 frames (truncated, as the offline
    writer casts) equal JAX crowd11_augment's on JAX's own decisions: crop
    gate and window, flip, and with noise the salt and pepper gates and
    JAX's per-pixel hits, given to the kernel's plain version as its random
    bits.  A uint8-valued clip as decode gives, at 80×96 → 56×48."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops import augment
    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels.noise import salt_pepper_reference

    clip = np.random.default_rng(seed).integers(0, 256, (5, 80, 96, 3)).astype(np.float32)
    key = jax.random.key(seed)
    k = jax.random.split(key, 7)
    ky, kx = jax.random.split(k[1])
    p = 0.85
    do_crop, flip = bool(jax.random.bernoulli(k[0], p)), bool(jax.random.bernoulli(k[2], p))
    salt, pepper = bool(jax.random.bernoulli(k[3], p)) and noise, bool(jax.random.bernoulli(k[5], p)) and noise
    y0, x0 = int(jax.random.randint(ky, (), 0, 80 - 20 + 1)), int(jax.random.randint(kx, (), 0, 96 - 36 + 1))
    ref = np.asarray(j_augment(clip, key)[noise])
    if noise:
        hits = [np.asarray(jax.random.randint(k[i], ref.shape, 0, 100) == 0) for i in (4, 6)]
    else:
        hits = [np.zeros(ref.shape, bool)] * 2
    one = lambda v: torch.tensor([v])  # noqa: E731
    d = augment.AugmentDecisions(one(do_crop), one(y0), one(x0), one(flip), one(salt), one(pepper), seed=0)
    out = augment.crop_flip_resize(torch.from_numpy(clip)[None], (56, 48), d)
    bits = np.where(hits[0], 0, 0xFFFF) | (np.where(hits[1], 0, 0xFFFF) << 16)
    out = salt_pepper_reference(out, torch.from_numpy(bits.reshape(1, -1).astype(np.int64)), d.salt, d.pepper,
                                augment.NOISE_RATIO)
    got, want = out[0].to(torch.uint8).numpy(), ref.astype(np.uint8)
    # The floats agree within 1e-3 on the 0-255 scale (float32 coordinates
    # and two lerps, fused differently); where JAX's value lies that close to
    # a whole number the truncations may differ by one, elsewhere they are equal.
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-3)
    near = np.abs(ref - np.round(ref)) < 1e-3
    np.testing.assert_array_equal(got[~near], want[~near])
    assert np.abs(got.astype(int) - want).max() <= 1
    if noise:
        assert salt or pepper  # the seeds exercise the noise


def test_crowd11_augment_is_the_batch_form(torch):
    """crowd11_augment(clip) == crowd11_augment_batch(clip[None])[0] on the
    same generator seed."""
    from crowded_scenes_ensemble_classification_tpu_torch.ops import augment

    clip = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (3, 70, 90, 3)).astype(np.float32))
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    one = augment.crowd11_augment(clip, (32, 32), 0.85, g())
    assert torch.equal(one, augment.crowd11_augment_batch(clip[None], (32, 32), 0.85, g())[0])


# ----------------------------------------------------------------------
# Reports, streaming windows, metrics
# ----------------------------------------------------------------------


def test_report_matrices_match_jax(torch):
    """The matrices (the PDFs are rendered on the card's host by
    chip_smoke.py where matplotlib imports: a first render takes ~2 s)."""
    from crowded_scenes_ensemble_classification_tpu import reports as jreports

    reports = _port("reports")
    rng = np.random.default_rng(0)
    labels, preds = rng.integers(0, 11, 200), rng.integers(0, 11, 200)
    probs = rng.dirichlet(np.ones(11), (4, 200)).astype(np.float32)
    for name, args in (("confusion_matrix", (labels, preds, 11)),
                       ("per_fold_confusions", ([labels[:90], labels[90:]], [preds[:90], preds[90:]], 11)),
                       ("members_correct_per_clip", (probs, labels))):
        np.testing.assert_array_equal(getattr(reports, name)(*args), getattr(jreports, name)(*args))
    cm = reports.row_normalize(reports.confusion_matrix(labels, preds, 11))
    np.testing.assert_array_equal(cm, jreports.row_normalize(jreports.confusion_matrix(labels, preds, 11)))
    np.testing.assert_array_equal(reports.difference_matrix(cm, cm.T), jreports.difference_matrix(cm, cm.T))
    counts = reports.members_correct_per_clip(probs, labels)
    np.testing.assert_array_equal(reports.agreement_histogram(counts, 4), jreports.agreement_histogram(counts, 4))
    assert reports.CROWD11_CLASS_NAMES == jreports.CROWD11_CLASS_NAMES



@pytest.mark.parametrize("frames,window,stride", [(80, 20, 10), (45, 16, 8), (16, 16, 8), (10, 16, 8), (33, 20, 7)])
def test_streaming_windows_match_jax(torch, frames, window, stride):
    from crowded_scenes_ensemble_classification_tpu.parallel import streaming as jstreaming

    streaming = _port("parallel.streaming")
    np.testing.assert_array_equal(streaming.window_starts(frames, window, stride),
                                  jstreaming.window_starts(frames, window, stride))
    clip = np.random.default_rng(frames).uniform(0, 255, (frames, 3, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(streaming.extract_windows(torch.from_numpy(clip), window, stride).numpy(),
                                  np.asarray(jstreaming.extract_windows(clip, window, stride)))


def test_streaming_predict_matches_member_scan(torch):
    """streaming_predict and streaming_predict_batch on one bundle equal the
    members' window scan of the same clips (one member)."""
    streaming = _port("parallel.streaming")
    bundle = _tiny_bundle(torch)
    clips = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (2, 40, 32, 32, 3)).astype(np.float32))
    one = torch.stack([streaming.streaming_predict(bundle, c, 8, 1 / 255.0) for c in clips])
    batch = streaming.streaming_predict_batch(bundle, clips, 8, 1 / 255.0)
    scan = streaming.streaming_member_probabilities([bundle.module], clips, 16, 8, 1 / 255.0)[0]
    torch.testing.assert_close(batch, one, atol=1e-6, rtol=0)
    torch.testing.assert_close(scan, one, atol=1e-6, rtol=0)
    torch.testing.assert_close(one.sum(-1), torch.ones(2))


def test_metrics_records_match_jax(torch, tmp_path):
    """MetricsLogger writes JAX's records (apart from the time); StageTimer
    sums stages and rates; profile_trace writes a Chrome trace."""
    from crowded_scenes_ensemble_classification_tpu.utils import metrics as jmetrics

    metrics = _port("utils.metrics")
    logs = [mod.MetricsLogger(str(tmp_path / side / "m.jsonl")) for side, mod in (("p", metrics), ("j", jmetrics))]
    for log in logs:
        log.log("epoch", epoch=0, loss=1.5)
        log.log("member_done", test_index=1, val_index=2)
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]  # noqa: E731
    assert strip(logs[0].read()) == strip(logs[1].read()) and len(logs[0].read()) == 2
    timer = metrics.StageTimer()
    for _ in range(2):
        with timer.stage("augment", items=3, device="cpu"):
            pass
    s = timer.summary()["augment"]
    assert s["items"] == 6 and s["seconds"] == timer.seconds("augment") and timer.rate("none") == 0.0
    with metrics.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(4).sum()
    assert prof is not None and os.path.exists(tmp_path / "trace" / "trace.json")
    with metrics.profile_trace(None) as prof:
        pass
    assert prof is None


def test_build_with_condition_seeded(torch, pconfig, monkeypatch):
    """_SCRATCH: the same seed gives the same weights, another seed others;
    the bundle is trainable on the named device (a width-0.125 C3D: the
    full-width draw takes seconds on the CPU)."""
    from crowded_scenes_ensemble_classification_tpu_torch.models import pretrained
    from crowded_scenes_ensemble_classification_tpu_torch.models.pretrained import build_with_condition

    real = pretrained.build_model
    monkeypatch.setattr(pretrained, "build_model", lambda *a, **kw: real(*a, width=0.125, **kw))
    cfg = pconfig.ExperimentConfig("C3D", num_classes=CLASSES)
    (b0, v0), (_, v1), (_, v2) = (build_with_condition(cfg, seed=s, device="cpu") for s in (4, 4, 5))
    assert b0.trainable and b0.device.type == "cpu" and b0.num_classes == CLASSES
    assert all(torch.equal(v0[k], v1[k]) for k in v0)
    assert not torch.equal(v0["fc6.weight"], v2["fc6.weight"])
