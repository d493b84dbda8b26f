"""Checkpoint readiness drill: resolve → checksum → convert → golden parity →
probability cache, one command per spec file.

Counterpart of `crowded_scenes_ensemble_classification_tpu/models/checkpoint_drill.py`
(lines 1-375), run by

    python -m crowded_scenes_ensemble_classification_tpu_torch convert \\
        --drill checkpoint_urls.json --work-dir drill_work

For every family in the spec it
  1. resolves each stream's checkpoint: a `file://` URL is copied, a file
     pre-placed in the cache is taken as it is.  Nothing is downloaded: an
     `http(s)://` URL raises (no network, ROADMAP Queue 1 item 8), so such a
     family, like one whose URL is null and whose cache file is absent,
     reports "blocked", not "failed";
  2. records the observed SHA256 and verifies it when the spec carries an
     expected hash;
  3. converts through the path training loads
     (`weights_registry.convert_keras_checkpoint` → a `.pt` state dict);
  4. runs golden parity: the family's independent float64 oracle
     (tests/oracle_{c3d,i3d,r3d}.py, numpy only) on the checkpoint's own
     weights against the port's forward on `device` in float32 with TF32
     off, softmax within 1e-4;
  5. caches member probabilities on one synthetic fold through
     `ensemble.members.member_probabilities` with the converted file.

The report has the JAX drill's keys and statuses.  Reading an h5 file
needs h5py (`weights_io.read_keras_h5`); `_parity` and `_probs_leg` take
layer dicts and a converted file, so they also run where h5py is absent.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sys
import urllib.parse
import urllib.request
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

PARITY_SOFTMAX_ATOL = 1e-4  # BASELINE.json north-star bar


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _resolve(url: Optional[str], dest: str) -> str:
    """`dest` when it exists, else a copy of the `file://` `url` there.
    Raises for anything else: no URL, or one that needs the network."""
    if os.path.exists(dest):
        return dest
    if not url:
        raise FileNotFoundError(f"no URL given and {dest} is not pre-placed in the cache")
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme in ("http", "https"):
        raise ValueError(f"{url} needs the network, which the port does not use (ROADMAP Queue 1 item 8): "
                         f"download it elsewhere and place it at {dest}")
    if parsed.scheme != "file":
        raise ValueError(f"unsupported URL scheme {parsed.scheme!r} in {url}")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".download"
    try:
        shutil.copyfile(urllib.request.url2pathname(parsed.path), tmp)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return dest


def _oracles():
    """Import the independent float64 oracles from tests/ (shipped in the
    repo; absent in a bare installed package → parity reports skipped)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tests = os.path.join(repo, "tests")
    if not os.path.isdir(tests):
        return None
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import oracle_c3d
    import oracle_i3d
    import oracle_r3d

    return {"c3d": oracle_c3d, "i3d": oracle_i3d, "r3d": oracle_r3d}


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@contextlib.contextmanager
def _exact_float32():
    """TF32 off for cuDNN convolutions and matmuls (PyTorch allows it for
    convolutions by default), restored on leaving."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _head(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The module's fresh 'predictions' Dense in the Keras layout."""
    return {"kernel": module.predictions.weight.detach().double().cpu().numpy().T,
            "bias": module.predictions.bias.detach().double().cpu().numpy()}


def _parity(model_type: str, stream_layers: Dict[str, Dict], device=None) -> Dict:
    """The port's float32 forward on `device` (the card when None) with the
    checkpoint's own weights against the float64 oracle, at JAX's
    geometries.  Returns {'max_softmax_delta': float, 'ok': bool}."""
    from .c3d import C3D
    from .i3d import I3D
    from .pretrained import load_pretrained
    from .r3d import R3D
    from .two_stream_i3d import TwoStreamI3D

    oracles = _oracles()
    if oracles is None:
        return {"skipped": "tests/oracle_*.py unavailable"}
    device = resolve_device(device)
    rng = np.random.default_rng(123)
    generator = torch.Generator(device=device).manual_seed(0)  # the heads a no-top checkpoint leaves fresh

    def run(module, model_type, num_classes, *xs, **sources):
        with torch.device(device):
            module = module()
        load_pretrained(model_type, module.eval(), num_classes, **sources)
        with _exact_float32(), torch.inference_mode():
            logits = module(*(torch.from_numpy(x).to(device) for x in xs))
        return module, logits.double().cpu().numpy()

    if model_type == "C3D":
        layers = stream_layers["rgb"]
        ckpt_classes = int(np.asarray(layers["fc8"]["kernel"]).shape[-1])
        width = np.asarray(layers["conv1"]["kernel"]).shape[-1] / 64.0
        # geometry is pinned by the checkpoint's fc6 fan-in → 16×112×112
        x = rng.uniform(0, 1, (1, 16, 112, 112, 3)).astype(np.float32)
        _, logits = run(lambda: C3D(ckpt_classes, width=width, generator=generator), "C3D", ckpt_classes, x,
                        rgb_h5=layers)
        want = oracles["c3d"].c3d_forward(layers, x)["softmax"]
    elif model_type == "I3D":
        layers = dict(stream_layers["rgb"])
        x = rng.uniform(-1, 1, (1, 16, 32, 32, 3)).astype(np.float32)
        module, logits = run(lambda: I3D(11, frames=16, generator=generator), "I3D", 11, x, rgb_h5=layers)
        # no-top checkpoint: the head is the model's fresh one — inject it
        # into the oracle so the whole trunk is compared through softmax
        layers["predictions"] = _head(module)
        want = oracles["i3d"].i3d_forward(layers, x, stream="rgb")["softmax"]
    elif model_type == "TWOSTREAM_I3D":
        rgb_layers = dict(stream_layers["rgb"])
        flow_layers = dict(stream_layers["flow"])
        rgb_layers.pop("predictions", None)
        flow_layers.pop("predictions", None)
        rgb = rng.uniform(-1, 1, (1, 16, 32, 32, 3)).astype(np.float32)
        flow = rng.uniform(-1, 1, (1, 16, 32, 32, 2)).astype(np.float32)
        module, logits = run(lambda: TwoStreamI3D(11, frames=16, generator=generator), "TWOSTREAM_I3D", 11,
                             rgb, flow, rgb_h5=rgb_layers, flow_h5=flow_layers)
        dummy_head = {"kernel": np.zeros((1024, 11), np.float64), "bias": np.zeros(11, np.float64)}
        fr = oracles["i3d"].i3d_forward({**rgb_layers, "predictions": dummy_head}, rgb, stream="rgb")["features"]
        ff = oracles["i3d"].i3d_forward({**flow_layers, "predictions": dummy_head}, flow, stream="flow")["features"]
        head = _head(module)
        want = _softmax(np.concatenate([fr, ff], -1) @ head["kernel"] + head["bias"])
    elif model_type.startswith("R3D_"):
        depth = int(model_type.split("_")[1])
        layers = stream_layers["rgb"]
        ckpt_classes = int(np.asarray(layers["dense_1"]["kernel"]).shape[-1])
        x = rng.uniform(0, 1, (1, 16, 64, 64, 3)).astype(np.float32)
        _, logits = run(lambda: R3D(ckpt_classes, depth=depth, generator=generator), model_type, ckpt_classes, x,
                        rgb_h5=layers)
        want = oracles["r3d"].r3d_forward(layers, x, depth)["softmax"]
    else:
        return {"skipped": f"no parity oracle for {model_type}"}

    delta = float(np.max(np.abs(_softmax(logits) - want)))
    return {"max_softmax_delta": delta, "ok": delta <= PARITY_SOFTMAX_ATOL}


def _probs_leg(
    model_type: str,
    converted_path: str,
    work_dir: str,
    num_clips: int = 4,
    hw: Optional[tuple] = None,
    device=None,
) -> Dict:
    """Cache member probabilities on one synthetic fold with the converted
    checkpoint on `device` (the card when None) — the store_probabilities
    leg (reference evaluate_ensemble.py:1002-1109) with real converted
    weights."""
    import dataclasses

    from ..data.pipeline import BatchPipeline, SampleSpec
    from ..data.synthetic import generate_synthetic_dataset
    from ..ensemble.members import member_probabilities
    from .pretrained import load_pretrained
    from .registry import build_model

    device = resolve_device(device)
    kw = {"stem_prestaged": True} if model_type in ("I3D", "TWOSTREAM_I3D") else {}  # one shared staging
    bundle = build_model(model_type, num_classes=11, device=device,
                         generator=torch.Generator(device=device).manual_seed(0), **kw)
    if model_type == "C3D":
        # geometry pinned by the checkpoint's fc6 fan-in
        hw = (bundle.clip.height, bundle.clip.width)
    elif hw is not None:
        bundle = dataclasses.replace(bundle, clip=dataclasses.replace(bundle.clip, height=hw[0], width=hw[1]))
    load_pretrained(model_type, bundle.module, 11, rgb_h5=converted_path)

    data_dir = os.path.join(work_dir, "drill_data", model_type)
    table = generate_synthetic_dataset(
        data_dir,
        num_scenes=max(num_clips, 2),
        clips_per_scene=1,
        num_classes=2,
        num_frames=bundle.clip.frames + 2,
        hw=(max(bundle.clip.height, 64), max(bundle.clip.width, 64)),
        as_videos=True,
        write_flow=False,
    ).rename({"label": "class"})
    spec = SampleSpec(
        num_frames=bundle.clip.frames,
        staging_hw=(bundle.clip.height, bundle.clip.width),
        two_stream=bundle.two_stream,
        flow_precomputed=False,
    )
    pipe = BatchPipeline(table.take(range(num_clips)), spec, batch_size=num_clips, shuffle=False, num_workers=2)
    probs = member_probabilities([bundle.module], pipe, (bundle.clip.height, bundle.clip.width))
    out = os.path.join(work_dir, f"drill_probs_{model_type}.npz")
    np.savez(out, probs=probs)
    finite = bool(np.all(np.isfinite(probs)))
    return {"path": out, "shape": list(probs.shape), "finite": finite, "ok": finite}


def run_drill(
    spec_path: str,
    work_dir: str,
    cache_dir: Optional[str] = None,
    probs_clips: int = 4,
    device=None,
) -> Dict:
    """Execute the drill for every family in the spec on `device` (the card
    when None); returns the report (also written to
    {work_dir}/drill_report.json).  Families blocked on missing files or
    the network report status 'blocked'; any failed step makes the family
    'failed'; otherwise 'ok'."""
    from .weights_io import read_keras_h5
    from .weights_registry import convert_keras_checkpoint, default_cache_dir

    with open(spec_path) as f:
        spec = json.load(f)
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(work_dir, exist_ok=True)
    report: Dict = {"spec": os.path.abspath(spec_path), "families": {}}

    for fam in spec["families"]:
        model_type = fam["model_type"]
        entry: Dict = {"steps": {}}
        report["families"][model_type] = entry
        streams = fam.get("streams", {})

        # 1+2: resolve + checksum every stream
        paths: Dict[str, str] = {}
        blocked = failed = False
        for stream, info in streams.items():
            dest = os.path.join(cache_dir, info.get("filename") or f"{model_type}_{stream}.h5")
            step: Dict = {}
            try:
                paths[stream] = _resolve(info.get("url"), dest)
                step["path"] = paths[stream]
                step["sha256"] = _sha256(paths[stream])
                expected = info.get("sha256")
                if expected and expected != step["sha256"]:
                    step["error"] = f"sha256 mismatch: expected {expected}"
                    failed = True
            except (OSError, ValueError) as e:
                step["blocked"] = str(e)
                blocked = True
            entry["steps"][f"fetch_{stream}"] = step

        if not streams:
            entry["status"] = "skipped"
            entry["note"] = fam.get("note", "no checkpoint (trains from scratch in the reference)")
            continue
        if blocked or failed:
            entry["status"] = "failed" if failed else "blocked"
            continue

        # 3: convert through the path training loads; the layer dicts are
        # read once, for the conversion and the parity
        converted = os.path.join(work_dir, f"{model_type}.pt")
        try:
            stream_layers = {s: read_keras_h5(p) for s, p in paths.items()}
            convert_keras_checkpoint(model_type, converted, rgb_h5=stream_layers.get("rgb"),
                                     flow_h5=stream_layers.get("flow"))
            entry["steps"]["convert"] = {"path": converted, "ok": True}
        except Exception as e:  # noqa: BLE001 (the report records every failed step)
            entry["steps"]["convert"] = {"error": str(e)}
            entry["status"] = "failed"
            continue

        # 4: golden parity against the independent float64 oracle
        try:
            par = _parity(model_type, stream_layers, device)
            entry["steps"]["parity"] = par
            if par.get("ok") is False:
                entry["status"] = "failed"
                continue
        except Exception as e:  # noqa: BLE001
            entry["steps"]["parity"] = {"error": str(e)}
            entry["status"] = "failed"
            continue

        # 5: probability cache on one synthetic fold
        try:
            pr = _probs_leg(model_type, converted, work_dir, num_clips=probs_clips,
                            hw=tuple(fam["probs_hw"]) if fam.get("probs_hw") else None, device=device)
            entry["steps"]["probs"] = pr
            entry["status"] = "ok" if pr["ok"] else "failed"
        except Exception as e:  # noqa: BLE001
            entry["steps"]["probs"] = {"error": str(e)}
            entry["status"] = "failed"

    out = os.path.join(work_dir, "drill_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    report["report_path"] = out
    return report
