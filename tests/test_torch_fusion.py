"""The port's ensemble evaluation stage against the JAX package, on seeded
probability tensors: the weighting schemes, the homogeneous, global and
combination evaluators, their CSV and npy files (byte for byte), the npz
probability store with its legacy CSV, the accuracy targets, and the
system property that ensembling members that err independently beats the
best of them.  torch and the port are imported by fixtures, not at
collection (tests/torch_port_memory.py)."""

import importlib

import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.ensemble import evaluate as jevaluate
from crowded_scenes_ensemble_classification_tpu.ensemble import fusion as jfusion
from crowded_scenes_ensemble_classification_tpu.ensemble import probability_store as jstore
from crowded_scenes_ensemble_classification_tpu.ensemble import targets as jtargets
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES, FOLDS = 11, 3
SCHEMES = ("GRID_SEARCH", "DIFFERENTIAL_EVOLUTION", "SUM", "VALIDATION_ERROR_INVERSE", "MAXIMUM")


@pytest.fixture(scope="module")
def port(torch):
    names = ("fusion", "evaluate", "probability_store", "targets")
    return {n: importlib.import_module(f"{PORT}.ensemble.{n}") for n in names}


def synthetic(rng, members: int, n: int, labels=None):
    """(M, N, C) float32 softmax-like rows and (N,) int32 labels (drawn
    unless given): Dirichlet noise plus, per member, a boost of the true
    class scaled by its skill, so members differ in accuracy and err
    independently."""
    if labels is None:
        labels = rng.integers(0, CLASSES, n).astype(np.int32)
    skills = np.linspace(0.2, 0.8, members)
    probs = rng.dirichlet(np.ones(CLASSES), size=(members, n))
    probs[:, np.arange(n), labels] += skills[:, None] * rng.random((members, n))
    return (probs / probs.sum(-1, keepdims=True)).astype(np.float32), labels


def provider_of(seed: int, members: int = 4, n: int = 48):
    """A ProbProvider over FOLDS folds of seeded test and train_val tensors;
    the test labels of a fold are the same for every seed, as the global
    ensemble needs."""
    rng = np.random.default_rng(seed)
    data = {}
    for t in range(FOLDS):
        test_labels = np.random.default_rng(1000 + t).integers(0, CLASSES, n).astype(np.int32)
        for subset, labels in (("test", test_labels), ("train_val", None)):
            probs, labels = synthetic(rng, members, n, labels)
            data[t, subset] = {"probs": probs, "labels": labels}
    return lambda t, subset: data[t, subset]


# ----------------------------------------------------------------------
# Weighting schemes
# ----------------------------------------------------------------------


def test_fusion_helpers_match_jax(torch, port):
    """normalize_l1 (with its all-zero passthrough), single-model argmax,
    ensemble_accuracy and the inverse-validation-error weights equal JAX's."""
    f = port["fusion"]
    for w in ([0.2, 0.5, 0.3], [0.0, 0.0], [3.0, 1.0]):
        np.testing.assert_array_equal(f.normalize_l1(w), jfusion.normalize_l1(w))
    probs, labels = synthetic(np.random.default_rng(1), 3, 40)
    np.testing.assert_array_equal(f.single_model_predictions(probs[1]), jfusion.single_model_predictions(probs[1]))
    for w in (f.sum_weights(3), jfusion.normalize_l1([0.1, 0.7, 0.2]), f.MAXIMUM):
        assert f.ensemble_accuracy(torch.from_numpy(probs), w, labels) == jfusion.ensemble_accuracy(probs, w, labels)
    losses = [0.9, 1.3, 0.45]
    np.testing.assert_array_equal(f.validation_error_inverse_weights(losses),
                                  jfusion.validation_error_inverse_weights(losses))


@pytest.mark.parametrize("members", [2, 3, 4])
def test_grid_search_matches_jax(torch, port, members):
    """The same weights as JAX's grid search over the 11^M − 11 candidates
    (14,630 at M=4), candidates in the reference's order."""
    f = port["fusion"]
    np.testing.assert_array_equal(f._grid_candidates(members), jfusion._grid_candidates(members))
    probs, labels = synthetic(np.random.default_rng(members), members, 64)
    got = f.grid_search_weights(torch.from_numpy(probs), labels)
    np.testing.assert_array_equal(got, jfusion.grid_search_weights(probs, labels))
    assert got.dtype == np.float64


def test_grid_search_first_best_on_ties(torch, port):
    """Identical members make every candidate tie: the first candidate in
    itertools.product order, (0, 0, 1), wins on both sides; and chunked
    candidate sums (a chunk of 7 rows) give the same answer."""
    f = port["fusion"]
    probs, labels = synthetic(np.random.default_rng(5), 1, 64)
    probs = np.repeat(probs, 3, axis=0)
    ref = jfusion.grid_search_weights(probs, labels)
    np.testing.assert_array_equal(ref, [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(f.grid_search_weights(torch.from_numpy(probs), labels), ref)
    distinct, labels = synthetic(np.random.default_rng(6), 3, 64)
    whole = f.grid_search_weights(torch.from_numpy(distinct), labels)
    chunk = f.GRID_CHUNK_ELEMENTS
    try:
        f.GRID_CHUNK_ELEMENTS = 7 * 64 * CLASSES
        np.testing.assert_array_equal(f.grid_search_weights(torch.from_numpy(distinct), labels), whole)
    finally:
        f.GRID_CHUNK_ELEMENTS = chunk


def test_differential_evolution_matches_jax(torch, port):
    """Seeded scipy DE over the port's accuracy gives JAX's weights to 1e-12."""
    probs, labels = synthetic(np.random.default_rng(7), 4, 64)
    ref = jfusion.differential_evolution_weights(probs, labels, seed=3)
    got = port["fusion"].differential_evolution_weights(torch.from_numpy(probs), labels, seed=3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compute_weights_matches_jax(torch, port, scheme):
    probs, labels = synthetic(np.random.default_rng(8), 3, 48)
    kw = dict(yhats_trainval=probs, labels_trainval=labels, min_val_losses=[0.7, 1.1, 0.9], de_seed=4)
    ref = jfusion.compute_weights(scheme, 3, **kw)
    got = port["fusion"].compute_weights(scheme, 3, **{**kw, "yhats_trainval": torch.from_numpy(probs)})
    if scheme == "MAXIMUM":
        assert got == ref == port["fusion"].MAXIMUM
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        port["fusion"].compute_weights("MEDIAN", 3)


# ----------------------------------------------------------------------
# Evaluators and their files
# ----------------------------------------------------------------------


def _files(tmp_path, results, writer_j, writer_t):
    """The files each package writes for `results`, as bytes."""
    out = []
    for side, res, write in (("jax", results[0], writer_j), ("port", results[1], writer_t)):
        folder = tmp_path / side
        paths = write(res, str(folder))
        out.append({p.rsplit("/", 1)[-1]: open(p, "rb").read() for p in paths if p})
    return out


def assert_results_equal(got, ref):
    assert (got.name, got.scheme, len(got.folds)) == (ref.name, ref.scheme, len(ref.folds))
    assert got.mean_accuracy == ref.mean_accuracy
    for g, r in zip(got.folds, ref.folds):
        assert (g.test_index, g.accuracy, g.member_accuracies) == (r.test_index, r.accuracy, r.member_accuracies)
        np.testing.assert_array_equal(g.predictions, r.predictions)
        if isinstance(r.weights, str):
            assert g.weights == r.weights
        else:
            np.testing.assert_allclose(g.weights, r.weights, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_evaluate_ensembles_matches_jax(torch, port, tmp_path, scheme):
    """Homogeneous 3-fold evaluation under each scheme: equal accuracies,
    predictions, weights and member accuracies, and byte-equal results CSV
    and (GRID_SEARCH, DE) weights npy."""
    provider = provider_of(11)
    losses = lambda t: [0.8 + 0.1 * t, 1.2, 0.6, 0.95]  # noqa: E731
    kw = dict(name="I3D_cfg", min_val_losses_provider=losses, de_seed=2)
    ref = jevaluate.evaluate_ensembles(provider, FOLDS, scheme, **kw)
    got = port["evaluate"].evaluate_ensembles(provider, FOLDS, scheme, device="cpu", **kw)
    assert_results_equal(got, ref)
    jfiles, tfiles = _files(tmp_path, (ref, got),
                            lambda r, d: (r.save_predictions_csv(d), r.save_weights_npy(d)),
                            lambda r, d: (r.save_predictions_csv(d), r.save_weights_npy(d)))
    assert sorted(tfiles) == sorted(jfiles) and tfiles == jfiles
    assert len(tfiles) == (2 if scheme in ("GRID_SEARCH", "DIFFERENTIAL_EVOLUTION") else 1)
    precomputed = np.stack([f.weights for f in ref.folds]) if scheme == "GRID_SEARCH" else None
    if precomputed is not None:
        again = port["evaluate"].evaluate_ensembles(provider, FOLDS, scheme, precomputed_weights=precomputed,
                                                    device="cpu", **kw)
        assert_results_equal(again, ref)


def test_global_and_combinations_match_jax(torch, port, tmp_path):
    """The global ensemble of three configurations (12 members, equal
    weights), its byte-equal CSV, all 7 subsets in JAX's order with equal
    mean accuracies, and the label-mismatch refusal."""
    providers = {name: provider_of(seed) for name, seed in (("C3D", 21), ("I3D", 22), ("R3D_18", 23))}
    ev = port["evaluate"]
    ref = jevaluate.global_evaluate_ensembles(providers, FOLDS)
    got = ev.global_evaluate_ensembles(providers, FOLDS, device="cpu")
    assert_results_equal(got, ref)
    jfiles, tfiles = _files(tmp_path, (ref, got), lambda r, d: (jevaluate.save_global_predictions_csv(r, d),),
                            lambda r, d: (ev.save_global_predictions_csv(r, d),))
    assert tfiles == jfiles and len(tfiles) == 1
    assert ev.compute_combinations(list(providers)) == jevaluate.compute_combinations(list(providers))
    combos = ev.combine_ensembles(providers, FOLDS, device="cpu")
    assert combos == jevaluate.combine_ensembles(providers, FOLDS) and len(combos) == 7
    bad = {"a": providers["C3D"], "b": lambda t, s: {**providers["I3D"](t, s), "labels": np.zeros(48, np.int32)}}
    with pytest.raises(ValueError, match="label mismatch"):
        ev.global_evaluate_ensembles(bad, FOLDS, device="cpu")


def test_evaluators_run_on_the_card_unless_told(torch, port, monkeypatch):
    """With no device named and no card, the evaluators raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ev = port["evaluate"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.evaluate_ensembles(provider_of(1), FOLDS, "SUM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.combine_ensembles({"a": provider_of(1)}, FOLDS)


def test_fused_accuracy_beats_best_member(torch, port):
    """The system property of the reference's paper (VERDICT.md:272-279):
    five members that are each right 60 % of the time, independently,
    SUM-fuse to an accuracy at least the best member's, on both packages."""
    rng = np.random.default_rng(31)
    n, m = 300, 5
    labels = rng.integers(0, CLASSES, n).astype(np.int32)
    right = rng.random((m, n)) < 0.6
    wrong = (labels + rng.integers(1, CLASSES, (m, n))) % CLASSES  # a random other class
    picked = np.where(right, labels, wrong)
    probs = rng.dirichlet(np.ones(CLASSES), size=(m, n)) * 0.5
    probs[np.arange(m)[:, None], np.arange(n), picked] += 0.5
    probs = probs.astype(np.float32)
    provider = lambda t, subset: {"probs": probs, "labels": labels}  # noqa: E731
    for res in (jevaluate.evaluate_ensembles(provider, 1, "SUM"),
                port["evaluate"].evaluate_ensembles(provider, 1, "SUM", device="cpu")):
        fold = res.folds[0]
        assert fold.accuracy >= max(fold.member_accuracies) + 0.1, (fold.accuracy, fold.member_accuracies)


# ----------------------------------------------------------------------
# Probability store and targets
# ----------------------------------------------------------------------


def test_probability_store_matches_jax(torch, port, tmp_path):
    """The npz store round-trips and reads on both sides; the legacy CSV is
    byte-equal to JAX's export of the same npz; import_reference_csv reads
    JAX's export back to the same tensors and names."""
    st = port["probability_store"]
    assert st.probability_cache_path("d", "ens", 2, "test", "_v") == jstore.probability_cache_path(
        "d", "ens", 2, "test", "_v")
    probs, labels = synthetic(np.random.default_rng(41), 3, 20)
    names = ["m0", "fold,1", 'q"2']  # a comma and a quote exercise the CSV quoting
    path = st.save_probabilities(str(tmp_path / "c" / "p.npz"), probs, labels, names)
    assert st.probabilities_exist(path)
    for load in (st.load_probabilities, jstore.load_probabilities):
        back = load(path)
        np.testing.assert_array_equal(back["probs"], probs)
        np.testing.assert_array_equal(back["labels"], labels)
        assert back["member_names"] == names
    ours = st.export_reference_csv(path, str(tmp_path / "ours.csv"))
    theirs = jstore.export_reference_csv(path, str(tmp_path / "theirs.csv"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = st.import_reference_csv(theirs, CLASSES), jstore.import_reference_csv(theirs, CLASSES)
    np.testing.assert_array_equal(got["probs"], ref["probs"])
    assert got["member_names"] == ref["member_names"] == names
    with pytest.raises(ValueError):
        st.save_probabilities(str(tmp_path / "bad.npz"), probs[0], labels, names)


@pytest.mark.parametrize("measured,per_fold", [(0.71, None), (0.705, [0.7, 0.72]), (0.705, [0.7, 0.75]),
                                               (0.65, None), (0.7, [0.9, 0.7])])
def test_check_target_matches_jax(port, tmp_path, measured, per_fold):
    """check_target's verdicts and messages equal JAX's: within, at and
    past the tolerance, per-fold misses, null fold targets, null and
    missing targets."""
    spec_path = tmp_path / "targets.json"
    spec_path.write_text('{"tolerance_pp": 1.0, "targets": {"A": {"mean_accuracy": 0.7, "per_fold": [0.7, 0.71]},'
                         ' "B": {"mean_accuracy": null}, "C": {"mean_accuracy": 0.7, "per_fold": [null, 0.7]}}}')
    spec = port["targets"].load_targets(str(spec_path))
    assert spec == jtargets.load_targets(str(spec_path))
    for key in ("A", "B", "C", "GLOBAL"):
        got = port["targets"].check_target(spec, key, measured, per_fold)
        ref = jtargets.check_target(spec, key, measured, per_fold)
        assert (got.ok, got.message) == (ref.ok, ref.message)
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError):
        port["targets"].load_targets(str(tmp_path / "bad.json"))
