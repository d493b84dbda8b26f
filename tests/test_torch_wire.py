"""The ragged window wire and the windowed augment of the PyTorch port, on the CPU.

- The port's plan built from JAX's own decisions (`augment_crop_decisions`
  of the same key, step by step) has JAX's `cap`, offsets and window
  sizes, and `pack_ragged_windows` packs the same bytes, in rgb and yuv420
  (cv2's I420), on non-square staging.
- The port's unpack of those bytes equals JAX's unpack: rgb exactly, yuv420
  within ±1 DN (both decode with the same f32 arithmetic).
- `decode_time_eval_resize_u8` within 1 DN of JAX's (a rint of two f32
  resizes fused apart), `pack_windows_host` byte for byte, and the windowed
  augment within 2e-3 on the 0-255 scale of JAX's on the same decisions
  (JAX's own bound, ops/augment.py:299-302); the noise as
  tests/test_torch_data.py holds it: the port's gates off, JAX's hits
  (exact 0 or 255 where the resample is not) left out of the comparison.
- `make_wire_train_step` equals `make_train_step` on the same pixels
  (staging = the model size, 64², so an uncropped clip ships its own frames;
  a plan drawn from the state's seed gives the step's own decisions): loss
  rtol 1e-5 and weights atol 2e-6, JAX's own tolerances (tests/
  test_train.py:291-296); two-stream bundles raise JAX's error.
- A 2-shard sharded wire unpacks to the single wire's rows, and its train
  step over a 2-position CPU mesh equals the single-wire step (float64,
  atol 1e-9).
- `FlatRows` against JAX's class.

torch and the port are imported by fixtures (tests/torch_port_memory.py).
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.data import resident as jresident
from crowded_scenes_ensemble_classification_tpu.data import wire_format as jwire
from crowded_scenes_ensemble_classification_tpu.ops import augment as jaugment
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
B, T, STAGING, OUT, MARGIN, STEPS = 4, 3, (40, 48), (36, 44), 8, 2
FRAMES, SIZE, CLASSES = 16, 32, 3  # the train steps' I3D clips


@pytest.fixture(scope="module")
def port(torch):
    names = ("data.wire_format", "data.resident", "ops.augment", "models.i3d", "models.registry", "core.config",
             "core.mesh", "train", "train.engine")
    return {n: importlib.import_module(f"{PORT}.{n}") for n in names}


def port_decisions(port, do_crop, y0, x0, flip=None):
    import torch

    off = torch.zeros(len(do_crop), dtype=torch.bool)
    flip = off if flip is None else torch.from_numpy(np.asarray(flip))
    return port["ops.augment"].AugmentDecisions(torch.from_numpy(np.asarray(do_crop)), torch.from_numpy(y0),
                                                torch.from_numpy(x0), flip, off, off, seed=1)


def staged(seed, n, hw=STAGING, t=T):
    """Smooth u8 clips (a ramp plus a little noise), where I420's chroma
    loss is small."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(hw[0]), np.arange(hw[1]), indexing="ij")
    base = (yy[..., None] * 3 + xx[..., None] * 2 + np.array([0, 40, 80])) % 200
    return (base[None, None] + rng.integers(0, 30, (n, t, *hw, 3))).astype(np.uint8)


@pytest.fixture(scope="module", params=["rgb", "yuv420"])
def wires(request, port):
    """JAX's plan and the port's plan of JAX's decisions, each step's wire
    from both packers."""
    cs = request.param
    key = jax.random.key(11)
    jplan = jwire.plan_wire_steps(key, STEPS, B, T, STAGING, OUT, p=0.5, crop_margin=MARGIN, colorspace=cs)
    pplan = port["data.wire_format"].plan_wire_from_decisions(
        {s: port_decisions(port, *jplan.steps[s][:3]) for s in range(STEPS)}, B, T, STAGING, OUT, p=0.5,
        crop_margin=MARGIN, colorspace=cs)
    out = []
    for s in range(STEPS):
        do_crop = jplan.steps[s][0]
        clips = staged(20 + s, B)
        eval_u8 = np.stack([jaugment.decode_time_eval_resize_u8(c, OUT) for c in clips])[~do_crop]
        out.append((jwire.pack_ragged_windows(jplan, s, clips[do_crop], eval_u8),
                    port["data.wire_format"].pack_ragged_windows(pplan, s, clips[do_crop], eval_u8)))
    assert any(p[0][1].size for p in out) and any(jplan.steps[s][0].any() and (~jplan.steps[s][0]).any()
                                                  for s in range(STEPS))  # the key mixes crops and full clips
    return dict(cs=cs, key=key, jplan=jplan, pplan=pplan, wires=out)


def test_wire_bytes_equal_jax(wires):
    jplan, pplan = wires["jplan"], wires["pplan"]
    for attr in ("cap", "crop_hw", "crop_ship_hw", "crop_bytes", "full_bytes"):
        assert getattr(pplan, attr) == getattr(jplan, attr), attr
    for s, ((jw, joff), (pw, poff)) in enumerate(wires["wires"]):
        for a, b in zip(pplan.steps[s], jplan.steps[s]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(poff, joff)
        np.testing.assert_array_equal(pw, jw)


def test_wire_unpack_equals_jax(torch, port, wires):
    unpack_j = jwire.make_wire_unpack(wires["jplan"])
    unpack_p = port["data.wire_format"].make_wire_unpack(wires["pplan"])
    for s, ((jw, joff), (pw, poff)) in enumerate(wires["wires"]):
        want = np.asarray(unpack_j(jnp.asarray(jw), jnp.asarray(joff), jax.random.fold_in(wires["key"], s)))
        got = unpack_p(torch.from_numpy(pw), poff, s).numpy()
        assert got.shape == want.shape == (B, T, *OUT, 3)
        if wires["cs"] == "rgb":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got.astype(np.int16), want.astype(np.int16), rtol=0, atol=1)


def test_windowed_augment_matches_jax(torch, port):
    """Host packing, eval resize and the windowed policy on JAX's decisions
    (noise gates off on the port's side, JAX's hits left out), and the
    windowed result against the port's unwindowed augment (whose crop
    margin is the policy's 60)."""
    aug = port["ops.augment"]
    key, p, out_hw, hw, margin = jax.random.key(5), 0.5, (36, 44), (80, 96), aug.CROP_MARGIN
    clips = staged(30, 6, hw)
    do_crop, y0, x0 = jaugment.augment_crop_decisions(key, 6, hw, p, margin)
    flip = np.array([bool(jax.random.bernoulli(jax.random.split(k, 7)[2], p)) for k in jax.random.split(key, 6)])
    assert 0 < do_crop.sum() < 6 and 0 < flip.sum() < 6
    j_eval = np.stack([jaugment.decode_time_eval_resize_u8(c, out_hw) for c in clips])
    p_eval = np.stack([aug.decode_time_eval_resize_u8(c, out_hw) for c in clips])
    np.testing.assert_allclose(p_eval.astype(np.int16), j_eval.astype(np.int16), rtol=0, atol=1)
    windows = jaugment.pack_windows_host(clips, j_eval, do_crop, y0, x0, out_hw, margin)
    np.testing.assert_array_equal(aug.pack_windows_host(clips, j_eval, do_crop, y0, x0, out_hw, margin), windows)
    windowed = jax.jit(jaugment.crowd11_augment_windowed_batch, static_argnums=(2, 3, 4, 5))
    want = np.asarray(windowed(jnp.asarray(windows, jnp.float32), key, out_hw, hw, p, margin))
    d = port_decisions(port, do_crop, y0, x0, flip)
    got = aug.crowd11_augment_windowed_from_decisions(torch.from_numpy(windows), out_hw, hw, d, margin).numpy()
    hits = ((want == 0.0) | (want == 255.0)) & (np.abs(got - want) > 2e-3)
    assert 0 < hits.mean() < 0.03  # JAX's salt and pepper, 1/100 each where a gate is on
    np.testing.assert_allclose(got[~hits], want[~hits], rtol=0, atol=2e-3)
    dense = aug.crowd11_augment_from_decisions(torch.from_numpy(clips), out_hw, d).numpy()
    np.testing.assert_allclose(got[do_crop], dense[do_crop], rtol=0, atol=2e-3)


def _bundle(port, seed=41, two_stream=False, size=SIZE):
    module = port["models.i3d"].I3D(CLASSES, frames=FRAMES, generator=torch_gen(seed))
    return port["models.registry"].ModelBundle("I3D", module, port["core.config"].ClipSpec(FRAMES, size, size),
                                               CLASSES, two_stream, trainable=True)


def torch_gen(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def _wire_batch(port, plan, clips, step=0):
    do_crop = plan.steps[step][0]
    return port["data.wire_format"].pack_ragged_windows(plan, step, clips[do_crop], clips[~do_crop])


def _state_of(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_wire_train_step_matches_dense_step(torch, port):
    """staging = the model size (64², above the policy's crop margin of 60,
    which the dense step takes) and p = 0.75: uncropped clips ship their own
    frames, cropped ones their windows; the plan drawn from the state's seed
    holds the dense step's decisions.  Two-stream bundles raise."""
    wf, engine, train = port["data.wire_format"], port["train.engine"], port["train"]
    size = 64
    clips = staged(40, B, (size, size), FRAMES)
    labels, valid, cw = np.array([0, 2, 1, 2]), np.arange(B) != 1, torch.ones(CLASSES)
    tx = train.keras_sgd(0.01)
    plan = wf.plan_wire_steps(9, 1, B, FRAMES, (size, size), (size, size), p=0.75)
    assert 0 < plan.steps[0][0].sum() < B
    wire, offsets = _wire_batch(port, plan, clips)
    dense, wired = _bundle(port, size=size), _bundle(port, size=size)
    wired.module.load_state_dict(dense.module.state_dict())
    s1, m1 = engine.make_train_step(dense, tx, (size, size), True, input_scale=1 / 255)(
        train.TrainState.create(dense.module, tx, seed=9), {"rgb": clips, "label": labels, "valid": valid}, cw)
    s2, m2 = engine.make_wire_train_step(wired, tx, plan, 9, input_scale=1 / 255)(
        train.TrainState.create(wired.module, tx, seed=9), wire, offsets, 0, labels, valid, cw)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    assert float(m2["accuracy"]) == float(m1["accuracy"]) and s2.step == s1.step == 1
    want = dense.module.state_dict()
    for k, v in wired.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=2e-6, err_msg=k)
    with pytest.raises(ValueError, match="RGB-only"):
        engine.make_wire_train_step(_bundle(port, two_stream=True), tx, plan)
    with pytest.raises(ValueError, match="ShardedWirePlan requires a mesh"):
        engine.make_wire_train_step(wired, tx, wf.shard_wire_plan(plan, 2))


def test_sharded_wire_equals_single_wire(torch, port):
    """2 shards: each position's unpack is its rows of the single wire's,
    and the data-parallel wire step (float64) equals the single-wire step."""
    wf, engine, train = port["data.wire_format"], port["train.engine"], port["train"]
    clips = staged(50, B, (SIZE + 8, SIZE + 8), FRAMES)
    plan = wf.plan_wire_steps(21, 1, B, FRAMES, (SIZE + 8, SIZE + 8), (SIZE, SIZE), p=0.75, crop_margin=8)
    do_crop = plan.steps[0][0]
    assert 0 < do_crop.sum() < B
    eval_u8 = np.stack([port["ops.augment"].decode_time_eval_resize_u8(c, (SIZE, SIZE)) for c in clips[~do_crop]])
    wire, offsets = wf.pack_ragged_windows(plan, 0, clips[do_crop], eval_u8)
    splan = wf.shard_wire_plan(plan, 2)
    wires, soffs = wf.pack_sharded_wires(splan, 0, clips[do_crop], eval_u8)
    assert wires.shape == (2, splan.cap) and soffs.shape == (2, B // 2)
    mesh = port["core.mesh"].make_mesh((("data", 2),), [torch.device("cpu")] * 2)
    single = wf.make_wire_unpack(plan)(torch.from_numpy(wire), offsets, 0)
    parts = wf.make_sharded_wire_unpack(splan, mesh)(wires, soffs, 0)
    assert torch.equal(torch.cat(parts), single)
    labels, valid = np.array([1, 0, 2, 2]), np.ones(B, bool)
    tx = train.keras_sgd(0.01)
    runs = {}
    for name, p, m, w, o in (("single", plan, None, wire, offsets), ("sharded", splan, mesh, wires, soffs)):
        bundle = _bundle(port, 42)
        bundle.module.double()
        _, metrics = engine.make_wire_train_step(bundle, tx, p, mesh=m, input_scale=1 / 255)(
            train.TrainState.create(bundle.module, tx, seed=12), w, o, 0, labels, valid,
            torch.ones(CLASSES, dtype=torch.float64))
        runs[name] = (float(metrics["loss"]), _state_of(bundle.module))
    np.testing.assert_allclose(runs["sharded"][0], runs["single"][0], rtol=0, atol=1e-9)
    for k, v in runs["single"][1].items():
        np.testing.assert_allclose(runs["sharded"][1][k].double().numpy(), v.double().numpy(), rtol=0, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("row_shape", [(2, 3, 4), (7,)], ids=["rank3", "rank1"])
def test_flat_rows_match_jax(torch, port, row_shape):
    flat = np.random.default_rng(60).integers(0, 256, (5, int(np.prod(row_shape))), dtype=np.uint8)
    want = jresident.FlatRows(jnp.asarray(flat), row_shape)
    got = port["data.resident"].FlatRows(torch.from_numpy(flat), row_shape)
    assert got.shape == want.shape and len(got) == len(want) and got.nbytes == want.nbytes
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.densify().numpy(), np.asarray(want.densify()))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for i in (0, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    copy.deepcopy(got)
