"""The port's checkpoint drill against the JAX drill on the CPU, on
tests/test_checkpoint_drill.py's spec: reference-layout checkpoints from
tests/oracle_{i3d,r3d}.py behind `file://` URLs, an absent C3D file and a
scratch family.

R3D-18 runs the whole chain through `convert --drill` (`ok`, parity within
1e-4 of the float64 oracle, finite probabilities summing to 1); the
statuses and checksums of the families that stop before conversion (a
checksum mismatch, an absent file, no checkpoint) equal JAX's report; an
`https://` URL is `blocked` with no socket opened.  The full-width I3D
chain at 64² is `slow`, as JAX's `test_drill_end_to_end` is.  No JAX model
is compiled.
"""

import hashlib
import importlib
import json
import os
import socket
from pathlib import Path

import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.models import checkpoint_drill as jdrill
from crowded_scenes_ensemble_classification_tpu.models import weights_io as jwio
from oracle_i3d import random_i3d_h5_layers
from oracle_r3d import random_r3d_h5_layers
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
PORT = "crowded_scenes_ensemble_classification_tpu_torch"


@pytest.fixture(scope="module")
def drill(torch):
    return importlib.import_module(f"{PORT}.models.checkpoint_drill")


@pytest.fixture(scope="module")
def pcli(torch):
    return importlib.import_module(f"{PORT}.cli.main")


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def drill_env(tmp_path_factory):
    """tests/test_checkpoint_drill.py's checkpoints and spec, and an
    https:// TwoStream family."""
    root = tmp_path_factory.mktemp("drill")
    src = root / "src"
    os.makedirs(src)
    i3d_layers = random_i3d_h5_layers(seed=61, stream="rgb", num_classes=11)
    i3d_layers.pop("predictions")  # no-top, like the real release files
    i3d_h5 = jwio.write_keras_h5(str(src / "i3d_rgb.h5"), i3d_layers)
    r3d_h5 = jwio.write_keras_h5(str(src / "r3d18.h5"), random_r3d_h5_layers(seed=62, depth=18, num_classes=11))
    families = {
        "I3D": {"family": "I3D", "model_type": "I3D", "probs_hw": [64, 64], "streams": {
            "rgb": {"url": "file://" + i3d_h5, "filename": "drill_i3d_rgb.h5", "sha256": _sha(i3d_h5)}}},
        "R3D_18": {"family": "R3D_18", "model_type": "R3D_18", "probs_hw": [64, 64], "streams": {
            "rgb": {"url": "file://" + r3d_h5, "filename": "drill_r3d18.h5", "sha256": _sha(r3d_h5)}}},
        "C3D": {"family": "C3D", "model_type": "C3D", "streams": {
            "rgb": {"url": None, "filename": "absent_sports1M.h5", "sha256": None}}},
        "R3D_34": {"family": "R3D_scratch", "model_type": "R3D_34", "streams": {}},
        "TWOSTREAM_I3D": {"family": "TWOSTREAM_I3D", "model_type": "TWOSTREAM_I3D", "streams": {
            "rgb": {"url": "https://example.invalid/rgb.h5", "filename": "ts_rgb.h5", "sha256": None},
            "flow": {"url": "https://example.invalid/flow.h5", "filename": "ts_flow.h5", "sha256": None}}},
    }

    def spec(name, *types):
        path = root / f"{name}.json"
        path.write_text(json.dumps({"families": [families[t] for t in types]}))
        return str(path)

    return {"root": root, "spec": spec, "i3d_h5": i3d_h5, "r3d_h5": r3d_h5}


@pytest.fixture
def no_network(monkeypatch):
    """Every socket connection attempt is recorded and refused."""
    attempts = []

    def refuse(*args, **kwargs):
        attempts.append(args)
        raise AssertionError("the drill opened a socket")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    return attempts


def test_convert_drill_r3d18_ok_others_blocked_or_skipped(pcli, drill_env, no_network, tmp_path, capsys):
    """`convert --drill` on the card's stand-in: R3D-18 ok with its parity
    within 1e-4 and finite probabilities summing to 1 within 1e-5; C3D and
    the https:// TwoStream family blocked, with no socket opened; R3D_34
    skipped; checksums as the JAX drill computes them."""
    spec = drill_env["spec"]("r3d", "R3D_18", "C3D", "R3D_34", "TWOSTREAM_I3D")
    rc = pcli.main(["convert", "--drill", spec, "--work-dir", str(tmp_path / "work"), "--cache-dir",
                    str(tmp_path / "cache")], device="cpu")
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.load(open(lines[-1]))
    fams = report["families"]
    assert {k: v["status"] for k, v in fams.items()} == {"R3D_18": "ok", "C3D": "blocked", "R3D_34": "skipped",
                                                         "TWOSTREAM_I3D": "blocked"}
    delta = fams["R3D_18"]["steps"]["parity"]["max_softmax_delta"]
    assert delta <= 1e-4 and fams["R3D_18"]["steps"]["parity"]["ok"]
    assert lines[:-1] == [f"drill R3D_18: ok parity_delta={delta:.2e}", "drill C3D: blocked", "drill R3D_34: skipped",
                          "drill TWOSTREAM_I3D: blocked"]
    probs = np.load(fams["R3D_18"]["steps"]["probs"]["path"])["probs"]
    assert probs.shape == (1, 4, 11) and np.all(np.isfinite(probs))  # the CLI's 4 clips
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert fams["R3D_18"]["steps"]["fetch_rgb"]["sha256"] == jdrill._sha256(drill_env["r3d_h5"])
    assert fams["R3D_18"]["steps"]["convert"]["path"].endswith("R3D_18.pt")
    for stream in ("rgb", "flow"):
        assert "ROADMAP Queue 1 item 8" in fams["TWOSTREAM_I3D"]["steps"][f"fetch_{stream}"]["blocked"]
    assert no_network == []


def test_statuses_and_checksums_equal_jax(drill, drill_env, tmp_path):
    """The families that stop before conversion give JAX's report: a
    checksum mismatch 'failed' with the observed hash, an absent file
    'blocked', no checkpoint 'skipped'."""
    spec = drill_env["spec"]("stops", "I3D", "C3D", "R3D_34")
    bad = json.load(open(spec))
    bad["families"][0]["streams"]["rgb"]["sha256"] = "0" * 64
    Path(spec).write_text(json.dumps(bad))
    reports = {}
    for side, run in (("jax", jdrill.run_drill), ("port", lambda *a, **k: drill.run_drill(*a, device="cpu", **k))):
        root = tmp_path / side
        report = run(spec, str(root / "work"), cache_dir=str(root / "cache"))
        reports[side] = json.loads(json.dumps(report).replace(str(root), "<root>"))
    assert reports["port"] == reports["jax"]
    fams = reports["port"]["families"]
    assert [fams[t]["status"] for t in ("I3D", "C3D", "R3D_34")] == ["failed", "blocked", "skipped"]
    assert fams["I3D"]["steps"]["fetch_rgb"]["sha256"] == _sha(drill_env["i3d_h5"])


def test_convert_command_writes_the_converted_state_dict(torch, pcli, drill_env, tmp_path, capsys):
    registry = importlib.import_module(f"{PORT}.models.weights_registry")
    out = str(tmp_path / "r3d18.pt")
    assert pcli.main(["convert", "-mt", "R3D_18", "--rgb-h5", drill_env["r3d_h5"], "--num-classes", "11", "--out",
                      out], device="cpu") == 0
    assert capsys.readouterr().out.strip() == out
    _, want = registry.convert_keras_checkpoint("R3D_18", str(tmp_path / "api.pt"), rgb_h5=drill_env["r3d_h5"],
                                                num_classes=11)
    got = registry.load_converted(out)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_shipped_spec_parses_and_covers_all_families(torch):
    registry = importlib.import_module(f"{PORT}.models.weights_registry")
    spec = json.load(open(REPO / "checkpoint_urls.json"))
    by_type = {f["model_type"]: f for f in spec["families"]}
    assert set(by_type) == {"I3D", "TWOSTREAM_I3D", "C3D", "R3D_18"}
    assert by_type["I3D"]["streams"]["rgb"]["url"] == registry.WEIGHTS_PATH_NO_TOP["rgb_imagenet_and_kinetics"]
    assert by_type["TWOSTREAM_I3D"]["streams"]["flow"]["url"] == \
        registry.WEIGHTS_PATH_NO_TOP["flow_imagenet_and_kinetics"]
    assert by_type["C3D"]["streams"]["rgb"]["filename"] == registry.SPORTS1M_FILENAME


@pytest.mark.slow
def test_drill_i3d_end_to_end(drill, drill_env, tmp_path):
    report = drill.run_drill(drill_env["spec"]("i3d", "I3D"), str(tmp_path / "work"),
                             cache_dir=str(tmp_path / "cache"), probs_clips=2, device="cpu")
    entry = report["families"]["I3D"]
    assert entry["status"] == "ok", entry
    assert entry["steps"]["parity"]["max_softmax_delta"] <= 1e-4
    probs = np.load(entry["steps"]["probs"]["path"])["probs"]
    assert probs.shape == (1, 2, 11)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
