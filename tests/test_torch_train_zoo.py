"""Parity of the PyTorch port's training of C3D, R3D and TwoStream-I3D (on
precomputed flow and on gray pairs whose Farnebäck flow the step computes),
the gray-pair augment and the multi-member step with the JAX package, on
the CPU.

Variables are drawn with numpy into the flax tree (tests/test_torch_zoo.py)
and converted with `models/convert.py`; both packages take the same numpy
batches.  The train steps are held as I3D's is
(tests/test_torch_train.py::test_train_step_matches_jax), in float64 on
both sides (jax.enable_x64) at rtol 1e-4, atol 1e-6 in loss, params,
BatchNorm statistics and optimizer state, over 2 steps, each from a common
state: the first from the converted variables, the second from the JAX
state after the first, put into the port.  Both packages compute the
logits and the cross-entropy in float32 (the JAX models cast their logits,
e.g. r3d.py:177), so a float64 step agrees only to about 5e-8 of the
gradient's scale, and chained steps compound that: Keras Adam divides each
gradient by its own magnitude (+ eps 1e-7), which after two chained steps
moves a few R3D weights, and R3D-50's stem moments, past 1e-4.  The port's
f32 first step: its loss within 5e-4 of the reference's.  (The I3D test
also holds the f32 params after one step to 0.5 % of each tensor's largest
element of its own float64 run; here the last stages' BatchNorm averages
2-4 samples a channel and near-ties of the max pools route gradients by
rounding, which moves single tensors of TwoStream and R3D-50 0.7-3 % off
float64, so that check does not hold at these sizes.)  Augment and dropout draw from `jax.random` in JAX and
from torch generators here, so the steps run with augment off and dropout
0, except where JAX's own decisions are fed to the port.  torch and the
port are imported by fixtures, not at collection
(tests/torch_port_memory.py).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi

from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec as JClip
from crowded_scenes_ensemble_classification_tpu.flow import farneback as jfb
from crowded_scenes_ensemble_classification_tpu.models import c3d as jc3d
from crowded_scenes_ensemble_classification_tpu.models import common as jcommon
from crowded_scenes_ensemble_classification_tpu.models import r3d as jr3d
from crowded_scenes_ensemble_classification_tpu.models import two_stream_i3d as jts
from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JBundle
from crowded_scenes_ensemble_classification_tpu.ops import augment as jaugment
from crowded_scenes_ensemble_classification_tpu.train import callbacks as jcallbacks
from crowded_scenes_ensemble_classification_tpu.train import engine as jengine
from crowded_scenes_ensemble_classification_tpu.train import multi_member as jmulti
from crowded_scenes_ensemble_classification_tpu.train import state as jstate
from test_torch_zoo import fill_variables, flax_shapes, textured_frames
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES, WIDTH, SCALE = 11, 0.125, 1 / 255.0
FRAMES, OUT, STAGING = 16, 32, 40
RGB_SHAPE = (2, FRAMES, OUT, OUT, 3)
# Compile-bound JAX functions (the preprocessing, the flow) build at XLA's
# backend optimization level 0; the float64 train steps, whose runs at
# level 0 take 10-20× longer than their compiles save, at level 1.
LEVEL0 = {"xla_backend_optimization_level": 0}
LEVEL1 = {"xla_backend_optimization_level": 1}
TOL = dict(rtol=1e-4, atol=1e-6)
# Both sides take this schedule: max_disp=4 clamps nothing of these
# motions and keeps the JAX compile of the separable warp small.
FLOW_PARAMS = dict(jfb.TURBO_PARAMS, max_disp=4)
CLASS_WEIGHTS = np.linspace(0.5, 2.0, CLASSES)


@pytest.fixture(scope="module")
def port(torch):
    """The port's modules by short name."""
    names = ("core.config", "models.c3d", "models.r3d", "models.two_stream_i3d", "models.common",
             "models.convert", "models.registry", "ops.augment", "data.resident", "train", "train.engine")
    return {n.replace("train.engine", "engine").split(".")[-1]: importlib.import_module(f"{PORT}.{n}")
            for n in names}


def _flax_module(model_type, dtype=jnp.float32):
    if model_type == "C3D":
        return jc3d.C3D(num_classes=CLASSES, dtype=dtype, dropout_rate=0.0, width=WIDTH)
    if model_type == "TWOSTREAM_I3D":
        return jts.TwoStreamI3D(num_classes=CLASSES, dtype=dtype)
    return jr3d.R3D(num_classes=CLASSES, depth=int(model_type.split("_")[1]), dtype=dtype, width=WIDTH)


def _port_module(port, model_type):
    if model_type == "C3D":
        return port["c3d"].C3D(CLASSES, WIDTH, dropout_rate=0.0, clip_thw=(FRAMES, OUT, OUT))
    if model_type == "TWOSTREAM_I3D":
        return port["two_stream_i3d"].TwoStreamI3D(CLASSES, frames=FRAMES)
    return port["r3d"].R3D(CLASSES, int(model_type.split("_")[1]), WIDTH)


def _port_bundle(torch, port, model_type, variables, dtype):
    """The port's trainable bundle of `model_type` on the converted flax
    variables, computing in `dtype`, with the family's (tx, l2 weight)."""
    with torch.device("meta"):  # no random init drawn only to be overwritten
        module = _port_module(port, model_type)
    module.load_state_dict(port["convert"].state_dict_from_flax(model_type, variables, dtype), assign=True)
    bundle = port["registry"].ModelBundle(model_type, module, port["config"].ClipSpec(FRAMES, OUT, OUT), CLASSES,
                                          model_type == "TWOSTREAM_I3D", trainable=True)
    return bundle, *port["train"].train_policy(model_type)


def _jax_tx(model_type):
    return jstate.make_optimizer(model_type, jcallbacks.lr_policy_for(model_type).initial_lr)


@functools.lru_cache(maxsize=None)
def _jax_state_fn(tx):
    """`jstate.TrainState.create` with `tx`, jitted: one compile, where the
    optimizer's eager init compiles an op for every parameter shape."""
    return jax.jit(lambda v, key: jstate.TrainState.create(v, tx, key))


def _jax_state(variables, tx, seed=0):
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)  # no XLA convert
    return _jax_state_fn(tx)(v, jax.random.key(seed))


def _as_port(port, model_type, tree):
    """A flax {'params', 'batch_stats'} tree as port state-dict names, numpy
    float64."""
    import torch

    sd = port["convert"].state_dict_from_flax(model_type, jax.tree_util.tree_map(np.asarray, tree), torch.float64)
    return {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}


def _snapshot(port, model_type, jst):
    """What a check reads of a JAX TrainState, as numpy by port name: the
    variables, and the optimizer state (KerasSGD's velocity, KerasAdam's m
    and v).  Taken before the next step, which donates the state."""
    inner = jst.opt_state.inner_state
    names = ("m", "v") if model_type.startswith("R3D") else ("velocity",)
    return {"variables": _as_port(port, model_type, {"params": jst.params, "batch_stats": jst.batch_stats}),
            "moments": {n: _as_port(port, model_type, {"params": getattr(inner, n)}) for n in names}}


def _assert_close(got, want, rtol, atol, what):
    """assert_allclose, with numpy's vectorized test first: hundreds of
    tensors a step make assert_allclose's own bookkeeping the slow part."""
    if not np.all(np.abs(got - want) <= atol + rtol * np.abs(want)):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _check_step(module, opt, snap, jloss, loss, what):
    """Loss, params, BatchNorm statistics and optimizer state against the
    JAX state after the same step (`_snapshot`), at TOL.  An optimizer
    moment's atol is 1e-6 of its tensor's scale where that exceeds 1:
    Adam's moments are the gradient (× 0.1) and its square (× 0.001), not
    lr-scaled like SGD's velocity, and reach 58 and 336 at R3D-50's stem,
    where the float32 cross-entropy of both packages leaves them equal to
    about 2e-7 of their scale."""
    np.testing.assert_allclose(loss, jloss, err_msg=f"{what}: loss", **TOL)
    got = {k: v.numpy() for k, v in module.state_dict().items() if v.is_floating_point()}
    want = snap["variables"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        _assert_close(got[k], v, TOL["rtol"], TOL["atol"], f"{what}: {k}")
    params = dict(module.named_parameters())
    for moment, tree in snap["moments"].items():
        for k, v in tree.items():
            if params[k].requires_grad:
                _assert_close(opt.state[params[k]][moment].numpy(), v, TOL["rtol"],
                              TOL["atol"] * max(1.0, np.abs(v).max()), f"{what}: {moment} {k}")


def _load_snapshot(torch, module, opt, snap):
    """Put the JAX state of `_snapshot` into the port's module and Adam."""
    sd = module.state_dict()
    with torch.no_grad():
        for k, v in snap["variables"].items():
            sd[k].copy_(torch.from_numpy(v))
    for n, p in module.named_parameters():
        if p.requires_grad:
            for moment, tree in snap["moments"].items():
                opt.state[p][moment].copy_(torch.from_numpy(tree[n]))


def _check_f32_loss(torch, port, model_type, variables, batch, step_kw, jloss):
    """The port's f32 first step: its loss within 5e-4 of the reference's."""
    bundle, tx, l2 = _port_bundle(torch, port, model_type, variables, torch.float32)
    hw = batch["rgb"].shape[2:4] if model_type != "TWOSTREAM_I3D" else (OUT, OUT)
    step = port["train"].make_train_step(bundle, tx, hw, l2_weight=l2, input_scale=SCALE, **step_kw)
    _, m = step(port["train"].TrainState.create(bundle.module, tx), _tensors(torch, batch),
                torch.from_numpy(CLASS_WEIGHTS).float())
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=5e-4)


def _hold_step(torch, port, model_type, module, opt, snap, jloss, loss, what):
    """One step against the JAX state after it (`_check_step`), then the
    port takes that JAX state, so the next step starts where JAX's does."""
    _check_step(module, opt, snap, jloss, loss, what)
    _load_snapshot(torch, module, opt, snap)


def _tensors(torch, batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rgb_batches(rng, shape=RGB_SHAPE, steps=2):
    return [{"rgb": rng.integers(0, 256, shape, dtype=np.uint8), "label": np.array([3, 7], np.int32),
             "valid": np.array([True, i == 0])} for i in range(steps)]


# ----------------------------------------------------------------------
# C3D and R3D: the JAX make_train_step, 2 float64 steps
# ----------------------------------------------------------------------


# R3D-50 at 48²: at 32² its last stage's BatchNorm averages 2 samples a
# channel, through which float32 rounding moves its first step 3.5 % off its
# float64 run; at 48², 18.
FAMILY_HW = {"C3D": OUT, "R3D_18": OUT, "R3D_50": 48}


@pytest.mark.parametrize("model_type", sorted(FAMILY_HW))
def test_family_train_steps_match_jax(torch, port, model_type):
    """make_train_step of C3D (width 0.125, plain Keras SGD), R3D-18 and the
    bottleneck R3D-50 (width 0.125, Keras Adam, the l2(1e-4) term in the
    loss) against the JAX make_train_step, each with its family's optimizer
    at its policy's initial rate, at (2,16,32,32,3) uint8 clips (R3D-50:
    48², `FAMILY_HW`), augment off, dropout 0, input_scale 1/255,
    non-uniform class weights and one
    invalid row: 2 float64 steps and the f32 first step's loss as the module
    docstring says."""
    hw = FAMILY_HW[model_type]
    shape = (2, FRAMES, hw, hw, 3)
    variables = fill_variables(flax_shapes(_flax_module(model_type), shape), seed=30)
    batches = _rgb_batches(np.random.default_rng(31), shape)
    l2 = jengine.R3D_L2_WEIGHT if model_type.startswith("R3D") else 0.0
    with jax.enable_x64(True):
        jbundle = JBundle(model_type, _flax_module(model_type, jnp.float64), JClip(FRAMES, hw, hw), CLASSES, False)
        jtx = _jax_tx(model_type)
        jst = _jax_state(variables, jtx)
        jstep = jengine.make_train_step(jbundle, jtx, (hw, hw), augment=False, l2_weight=l2, input_scale=SCALE)
        jstep = jstep.lower(jst, batches[0], jnp.asarray(CLASS_WEIGHTS)).compile(LEVEL1)
        ref = []
        for batch in batches:
            jst, jm = jstep(jst, batch, jnp.asarray(CLASS_WEIGHTS))
            ref.append((float(jm["loss"]), _snapshot(port, model_type, jst)))

    bundle, tx, port_l2 = _port_bundle(torch, port, model_type, variables, torch.float64)
    assert port_l2 == l2
    step = port["train"].make_train_step(bundle, tx, (hw, hw), augment=False, l2_weight=l2, input_scale=SCALE)
    state = port["train"].TrainState.create(bundle.module, tx)
    for i, (batch, (jloss, snap)) in enumerate(zip(batches, ref)):
        state, m = step(state, _tensors(torch, batch), torch.from_numpy(CLASS_WEIGHTS))
        _hold_step(torch, port, model_type, bundle.module, state.optimizer, snap, jloss, float(m["loss"]), f"step {i}")
    assert state.step == 2
    _check_f32_loss(torch, port, model_type, variables, batches[0], {"augment": False}, ref[0][0])


def test_l2_penalty_matches_jax_on_r3d18(torch, port):
    """models.common.l2_param_penalty of R3D-18 (width 0.125) equals the
    JAX function on the same params, over the same kernels:
    every conv, shortcut projection and Dense kernel and nothing else.
    SameConv3d subclasses nn.Conv3d, so all its convs count.  Both sum the
    squares in float32, in other orders: rtol 1e-5."""
    variables = fill_variables(flax_shapes(_flax_module("R3D_18"), RGB_SHAPE), seed=32)
    module = _port_module(port, "R3D_18")
    module.load_state_dict(port["convert"].state_dict_from_flax("R3D_18", variables))
    kernels = [p for p in jax.tree_util.tree_leaves_with_path(variables["params"]) if p[0][-1].key == "kernel"]
    same = [m for m in module.modules() if isinstance(m, port["r3d"].SameConv3d)]
    counted = [m for m in module.modules() if isinstance(m, (torch.nn.Conv3d, torch.nn.Linear))]
    assert all(isinstance(m, torch.nn.Conv3d) for m in same) and len(counted) == len(same) + 1 == len(kernels)
    want = float(jcommon.l2_param_penalty(variables["params"], 1e-4))
    got = float(port["common"].l2_param_penalty(module, 1e-4))
    np.testing.assert_allclose(got, want, rtol=1e-5)  # both sum ~10⁵ squares in float32, in other orders
    assert want > 0


# ----------------------------------------------------------------------
# TwoStream: precomputed flow, gray pairs, augmented gray pairs
# ----------------------------------------------------------------------


def _jax_decisions(rng_aug, batch_size, staging_hw, p):
    """The per-clip draws of JAX crowd11_augment (augment.py:57-82) under
    `rng_aug`: crop gate, y0, x0, flip, salt and pepper gates."""
    h, w = staging_hw
    ch, cw = max(h - jaugment.CROP_MARGIN, 1), max(w - jaugment.CROP_MARGIN, 1)

    def one(key):
        k_crop_gate, k_crop_pos, k_flip, k_salt_gate, _, k_pep_gate, _ = jax.random.split(key, 7)
        ky, kx = jax.random.split(k_crop_pos)
        return (jax.random.bernoulli(k_crop_gate, p), jax.random.randint(ky, (), 0, h - ch + 1),
                jax.random.randint(kx, (), 0, w - cw + 1), jax.random.bernoulli(k_flip, p),
                jax.random.bernoulli(k_salt_gate, p), jax.random.bernoulli(k_pep_gate, p))

    return jax.vmap(one)(jax.random.split(rng_aug, batch_size))


def _step_keys(state_key, step):
    """JAX's split of a step's key (engine.py:195-196): (rng_aug, rng_drop)."""
    return jax.random.split(jax.random.fold_in(state_key, step))


def _port_decisions(torch, port, draws):
    do_crop, y0, x0, flip, salt, pepper = (torch.from_numpy(np.array(a)) for a in draws)
    return port["augment"].AugmentDecisions(do_crop, y0.long(), x0.long(), flip, salt, pepper, seed=0)


AUGMENT_P = 0.3


def _flip_only_seed():
    """A state seed whose first two steps draw, for both clips, no crop and
    no salt or pepper, and a flip for at least one clip of each step.  The
    port's noise is its own Philox draw (ops/kernels/noise.py) and cannot
    equal JAX's, so the step is held where the gates are off; and at this
    40² staging the reference's crop window is 1 px (H − 60), which would
    leave Farnebäck nothing to solve.  The crop and the gray pairs' noise
    are held apart against JAX (test_gray_pair_augment_matches_jax).  The
    draws are taken under x64, as the float64 step takes them (bernoulli and
    randint draw other bits in float64 and int64)."""
    def wanted(seed):
        ok = True
        for step in range(2):
            crop, _, _, flip, salt, pepper = _jax_decisions(_step_keys(jax.random.key(seed), step)[0], 2,
                                                            (STAGING, STAGING), AUGMENT_P)
            ok &= ~(crop.any() | salt.any() | pepper.any()) & flip.any()
        return ok

    with jax.enable_x64(True):
        hits = np.flatnonzero(jax.jit(jax.vmap(wanted))(jnp.arange(2000)))
    assert hits.size, "no seed draws a flip without crop or noise"
    return int(hits[0])


def _swirling_texture(rng, amplitude):
    """FRAMES + 1 gray STAGING² frames of a periodic texture
    (test_torch_zoo.textured_frames), frame t sampled at t·d(y, x) with a
    displacement d of `amplitude` px that turns with position: a flow field
    that varies across the frame, so the flow trunk's BatchNorm and max
    pools see no plateau of equal values."""
    base = textured_frames(rng, 1, STAGING, 0, STAGING)[0]
    yy, xx = np.mgrid[0:STAGING, 0:STAGING].astype(np.float64)
    dy = amplitude * np.sin(2 * np.pi * xx / STAGING)
    dx = amplitude * np.cos(2 * np.pi * yy / STAGING)
    return np.stack([ndi.map_coordinates(base, [yy - t * dy, xx - t * dx], order=1, mode="grid-wrap")
                     for t in range(FRAMES + 1)]).astype(np.float32)


@pytest.fixture(scope="module")
def two_stream_jax():
    """The JAX TwoStream train step's two parts, each compiled once in
    float64 (engine.py:186-203 jits them as one): `apply_update` (forward,
    loss, gradient and Keras SGD update) for the model's f32 inputs, and
    `_preprocess` for each input mode; with the seeded variables and
    batches.  Composing them is the JAX step: the same rng split, the
    same functions."""
    shapes = flax_shapes(_flax_module("TWOSTREAM_I3D"), (1, FRAMES, OUT, OUT, 3), (1, FRAMES, OUT, OUT, 2))
    variables = fill_variables(shapes, seed=33)
    rng = np.random.default_rng(34)
    labels, valid = np.array([3, 7], np.int32), [np.array([True, True]), np.array([True, False])]
    batches = []
    for i in range(2):
        gray = np.stack([_swirling_texture(rng, 1.5 - 3 * c) for c in range(2)])[..., None]
        batches.append({"rgb": rng.integers(0, 256, (2, FRAMES, STAGING, STAGING, 3), dtype=np.uint8),
                        "flow": rng.integers(0, 256, (2, FRAMES, STAGING, STAGING, 2), dtype=np.uint8),
                        "gray": gray[:, :-1].astype(np.uint8), "gray_next": gray[:, 1:].astype(np.uint8),
                        "label": labels, "valid": valid[i]})
    modes = {"flow": dict(augment=False), "gray": dict(augment=False),
             "gray_augmented": dict(augment=True, flow_from_augmented=True)}
    with jax.enable_x64(True):
        jbundle = JBundle("TWOSTREAM_I3D", _flax_module("TWOSTREAM_I3D", jnp.float64), JClip(FRAMES, OUT, OUT),
                          CLASSES, True)
        jtx = _jax_tx("TWOSTREAM_I3D")
        jst = _jax_state(variables, jtx)
        key = jax.random.key(0)
        inputs = {"rgb": jnp.zeros(RGB_SHAPE, jnp.float32), "flow": jnp.zeros(RGB_SHAPE[:4] + (2,), jnp.float32)}
        update = jax.jit(jengine._make_apply_update(jbundle, jtx, 0.0)).lower(
            jst, inputs, labels, jnp.ones(2), jnp.asarray(CLASS_WEIGHTS), key).compile(LEVEL1)
        pre = {}
        for mode, kw in modes.items():
            b = _inputs(_mode_batch(batches[0], mode))

            def fn(batch, rng_aug, kw=kw):
                return jengine._preprocess(batch, rng_aug, (OUT, OUT), kw["augment"], AUGMENT_P, True, SCALE, False,
                                           FLOW_PARAMS, kw.get("flow_from_augmented", False))

            pre[mode] = jax.jit(fn).lower(b, key).compile(LEVEL0)
    return {"variables": variables, "batches": batches, "update": update, "preprocess": pre, "tx": jtx,
            "bundle": jbundle, "modes": modes}


def _inputs(batch):
    return {k: v for k, v in batch.items() if k not in ("label", "valid")}


def _mode_batch(batch, mode):
    keys = ("rgb", "flow") if mode == "flow" else ("rgb", "gray", "gray_next")
    return {k: batch[k] for k in keys + ("label", "valid")}


def _port_inputs(torch, port, batch, decisions, mode):
    """The port's step inputs of `batch` (engine._preprocess), float32."""
    return port["engine"]._preprocess(_tensors(torch, _inputs(batch)), decisions, (OUT, OUT), True, SCALE, False,
                                      FLOW_PARAMS, mode == "gray_augmented")


def _check_inputs(got, want, mode):
    """The port's model inputs against JAX's `_preprocess`: rgb and
    precomputed flow (resized, × 1/255) within 1e-6 (2.6e-4 on the 0-255
    scale: two lerps in float32, fused differently); computed flow within
    1e-3 px, the flow's bound against JAX (tests/test_torch_flow.py)."""
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-6, err_msg="rgb")
    np.testing.assert_allclose(got["flow"].numpy(), np.asarray(want["flow"]), rtol=0,
                               atol=1e-6 if mode == "flow" else 1e-3, err_msg="flow")


@pytest.mark.parametrize("mode", ["flow", "gray", "gray_augmented"])
def test_two_stream_train_steps_match_jax(torch, port, two_stream_jax, monkeypatch, mode):
    """make_train_step of TwoStream-I3D (frames 16, 32², Keras SGD with
    momentum 0.9) against the JAX step on 40²-staged batches: precomputed
    uint8 flow (resized, × input_scale); turbo Farnebäck of textured gray
    pairs (max_disp 4) in the step; and the same with augment on and
    `flow_from_augmented`, the port fed the JAX decisions (flipped clips,
    see `_flip_only_seed`), so that both streams take the flip.

    Each step's inputs are held against JAX's `_preprocess`
    (`_check_inputs`: the flow is float32 Farnebäck in both packages, equal
    to 1e-3 px, not to float64); the JAX update then runs on the port's
    inputs, and the step is held to it as the module docstring says, with
    the f32 first step's loss."""
    j = two_stream_jax
    kw = j["modes"][mode]
    seed = _flip_only_seed() if kw["augment"] else 0
    queue = []
    monkeypatch.setattr(port["engine"], "draw_decisions", lambda *a: queue.pop(0))
    step_kw = dict(kw, flow_params=FLOW_PARAMS, augment_p=AUGMENT_P)
    bundle, tx, _ = _port_bundle(torch, port, "TWOSTREAM_I3D", j["variables"], torch.float64)
    step = port["train"].make_train_step(bundle, tx, (OUT, OUT), input_scale=SCALE, **step_kw)
    state = port["train"].TrainState.create(bundle.module, tx, seed=seed)
    cw = torch.from_numpy(CLASS_WEIGHTS)
    first = None
    with jax.enable_x64(True):
        jst = _jax_state(j["variables"], j["tx"], seed)
        for i, batch in enumerate(_mode_batch(b, mode) for b in j["batches"]):
            rng_aug, rng_drop = _step_keys(jst.rng, jst.step)
            decisions = None
            if kw["augment"]:
                decisions = _port_decisions(torch, port, _jax_decisions(rng_aug, 2, (STAGING, STAGING), AUGMENT_P))
            inputs = _port_inputs(torch, port, batch, decisions, mode)
            _check_inputs(inputs, j["preprocess"][mode](_inputs(batch), rng_aug), mode)
            jst, jm = j["update"](jst, {k: v.numpy() for k, v in inputs.items()}, batch["label"],
                                  batch["valid"].astype(np.float64), jnp.asarray(CLASS_WEIGHTS), rng_drop)
            first = first or (float(jm["loss"]), batch, decisions)
            if decisions is not None:
                queue.append(decisions)
            state, m = step(state, _tensors(torch, batch), cw)
            _hold_step(torch, port, "TWOSTREAM_I3D", bundle.module, state.optimizer,
                       _snapshot(port, "TWOSTREAM_I3D", jst), float(jm["loss"]), float(m["loss"]), f"{mode} step {i}")
    assert state.step == 2 and not queue
    if first[2] is not None:
        queue.append(first[2])
    _check_f32_loss(torch, port, "TWOSTREAM_I3D", j["variables"], first[1], step_kw, first[0])


def test_two_stream_eval_step_on_gray_pairs_matches_jax(torch, port, two_stream_jax):
    """make_eval_step of TwoStream on gray pairs (flow of the unaugmented
    pairs, as JAX eval computes it), float64: its inputs against JAX's
    `_preprocess` (`_check_inputs`), then its loss sum, correct and valid
    counts and probabilities against the flax model in eval mode on those
    inputs, at TOL."""
    j = two_stream_jax
    batch = _mode_batch(j["batches"][1], "gray")
    inputs = _port_inputs(torch, port, batch, None, "gray")
    with jax.enable_x64(True):
        _check_inputs(inputs, j["preprocess"]["gray"](_inputs(batch), jax.random.key(0)), "gray")
        v = _jax_state(j["variables"], j["tx"]).variables()
        logits = jax.jit(lambda v, x: j["bundle"].apply(v, x, train=False))(
            v, {k: x.numpy() for k, x in inputs.items()})
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits), batch["label"][:, None], 1)[:, 0]
        mask = batch["valid"].astype(np.float64)
        ref = {"loss_sum": float(jnp.sum(ce * mask)), "count": float(mask.sum()),
               "correct": float(jnp.sum((jnp.argmax(logits, -1) == batch["label"]) * mask)),
               "probs": np.asarray(jax.nn.softmax(logits, -1))}
    bundle, _, _ = _port_bundle(torch, port, "TWOSTREAM_I3D", j["variables"], torch.float64)
    out = port["train"].make_eval_step(bundle, (OUT, OUT), input_scale=SCALE, flow_params=FLOW_PARAMS)(
        _tensors(torch, batch))
    assert not bundle.module.training
    for k, want in ref.items():
        np.testing.assert_allclose(out[k].numpy(), want, err_msg=k, **TOL)


def test_gray_pair_augment_matches_jax(torch, port):
    """crowd11_augment_gray_pair_from_decisions, given the decisions and
    the per-pixel salt/pepper hits JAX draws (fold_in(k_salt|k_pep, 0|1)),
    equals JAX crowd11_augment_gray_pair_batch on (4, 3, 72, 72, 1) float
    pairs: the crop window (12², resampled back to 72²), the flip, and each
    frame's own noise under the rgb stream's gates.  The noise lands on the
    same pixels exactly; the resampled values agree within 1e-5 of the
    0-255 scale, not exactly: XLA fuses the sampling coordinates'
    arithmetic, which rounds them differently (by up to an ulp of the
    coordinate, times neighbouring pixels up to 255 apart).  The key is one
    whose four clips draw each gate on and off."""
    shape = (4, 3, 72, 72, 1)
    rng = np.random.default_rng(35)
    gray, gray_next = (rng.uniform(0, 255, shape).astype(np.float32) for _ in range(2))
    for seed in range(200):
        key = jax.random.key(seed)
        draws = _jax_decisions(key, 4, shape[2:4], 0.5)
        if all(0 < d.sum() < 4 for d in (draws[0], draws[3], draws[4], draws[5])):
            break
    want = jax.jit(lambda g, gn, k: jaugment.crowd11_augment_gray_pair_batch(g, gn, k, p=0.5))(gray, gray_next, key)

    def hits(k):
        _, _, _, _, k_salt, _, k_pep = jax.random.split(k, 7)
        return [jax.random.randint(jax.random.fold_in(kk, s), shape[1:], 0, jaugment.NOISE_RATIO) == 0
                for s in (0, 1) for kk in (k_salt, k_pep)]

    hit = np.stack([np.stack(h) for h in map(hits, jax.random.split(key, 4))], 1)  # (4, B, T, H, W, 1)
    decisions = _port_decisions(torch, port, draws)
    got = port["augment"].crowd11_augment_gray_pair_from_decisions(
        torch.from_numpy(gray), torch.from_numpy(gray_next), decisions, torch.from_numpy(hit))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == shape and g.dtype == np.float32
        for value in (0.0, 255.0):  # the noise, exactly
            np.testing.assert_array_equal(g == value, w == value)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * 255)
    drawn = port["augment"].crowd11_augment_gray_pair_batch(torch.from_numpy(gray), torch.from_numpy(gray_next),
                                                            decisions)
    noisy = (drawn[0] != got[0]) & ((drawn[0] == 0) | (drawn[0] == 255))
    assert noisy.any()  # the drawn hits differ from JAX's; only gated clips take noise
    gated = torch.from_numpy(np.array(draws[4] | draws[5]))
    assert not noisy[~gated].any()


# ----------------------------------------------------------------------
# The multi-member step
# ----------------------------------------------------------------------


def test_multi_member_step_matches_jax(torch, port):
    """make_multi_member_train_step with M=2 C3D members (width 0.125) over
    stacked (2, 2, 16, 32, 32, 3) batches, 2 float64 steps, against JAX's
    vmapped step: per-member losses (normalised by Σ mask·w, as JAX's
    multi-member step does), accuracies, params and velocities at TOL, each
    step from a common state as the module docstring says.
    stack_states/unstack_states round-trip; zip_member_batches equals
    JAX's."""
    train = port["train"]
    shapes = flax_shapes(_flax_module("C3D"), RGB_SHAPE)
    variables = [fill_variables(shapes, seed=40 + m) for m in range(2)]
    rng = np.random.default_rng(42)
    per_member = [_rgb_batches(rng) for _ in range(2)]
    batches = list(jmulti.zip_member_batches([iter(b) for b in per_member]))
    ours = list(train.zip_member_batches([iter(b) for b in per_member]))
    assert len(ours) == len(batches) == 2
    for a, b in zip(ours, batches):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in b)
    with jax.enable_x64(True):
        jbundle = JBundle("C3D", _flax_module("C3D", jnp.float64), JClip(FRAMES, OUT, OUT), CLASSES, False)
        jtx = _jax_tx("C3D")
        jst = jmulti.stack_states([_jax_state(v, jtx, m) for m, v in enumerate(variables)])
        jstep = jmulti.make_multi_member_train_step(jbundle, jtx, (OUT, OUT), augment=False, input_scale=SCALE)
        jstep = jstep.lower(jst, batches[0], jnp.asarray(CLASS_WEIGHTS)).compile(LEVEL1)
        ref = []
        for batch in batches:
            jst, jm = jstep(jst, batch, jnp.asarray(CLASS_WEIGHTS))
            ref.append((np.asarray(jm["loss"]), np.asarray(jm["accuracy"]),
                        [_snapshot(port, "C3D", s) for s in jmulti.unstack_states(jst, 2)]))

    members = [_port_bundle(torch, port, "C3D", v, torch.float64) for v in variables]
    tx = members[0][1]
    bundle = members[0][0]
    states = train.stack_states([train.TrainState.create(b.module, tx, seed=m) for m, (b, _, _) in enumerate(members)])
    step = train.make_multi_member_train_step(bundle, tx, (OUT, OUT), augment=False, input_scale=SCALE)
    for i, (batch, (jloss, jacc, jstates)) in enumerate(zip(batches, ref)):
        states, m = step(states, batch, torch.from_numpy(CLASS_WEIGHTS))
        assert m["loss"].shape == m["accuracy"].shape == (2,)
        np.testing.assert_allclose(m["accuracy"].numpy(), jacc, **TOL)
        for k, (state, jst_k) in enumerate(zip(train.unstack_states(states, 2), jstates)):
            _hold_step(torch, port, "C3D", state.module, state.optimizer, jst_k, jloss[k], float(m["loss"][k]),
                       f"member {k} step {i}")
    assert [s.step for s in states] == [2, 2]
    with pytest.raises(ValueError):
        train.unstack_states(states, 3)


# ----------------------------------------------------------------------
# C3D's dropout: an explicit, step-seeded generator
# ----------------------------------------------------------------------


def test_c3d_dropout_draws_from_an_explicit_generator(torch, port):
    """models.c3d.dropout keeps 0.5 ± 0.02 of 10⁵ elements at rate 0.5 and
    scales them by 2, from the generator only (equal generators, equal
    masks; torch's global RNG untouched).  C3D in eval mode is deterministic
    and ignores a generator; in train mode it refuses to run without one."""
    c3d = port["c3d"]
    x = torch.ones(10**5)
    state = torch.get_rng_state()
    a = c3d.dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = c3d.dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(torch.get_rng_state(), state) and torch.equal(a, b)
    assert abs((a != 0).float().mean().item() - 0.5) <= 0.02 and set(a.unique().tolist()) == {0.0, 2.0}
    module = c3d.C3D(CLASSES, WIDTH, clip_thw=(FRAMES, OUT, OUT), generator=torch.Generator().manual_seed(2))
    clips = torch.from_numpy(np.random.default_rng(43).uniform(0, 1, RGB_SHAPE).astype(np.float32))
    with torch.no_grad():
        module.eval()
        assert torch.equal(module(clips), module(clips, torch.Generator().manual_seed(3)))
        module.train()
        with pytest.raises(ValueError, match="generator"):
            module(clips)
        one, two = (module(clips, torch.Generator().manual_seed(s)) for s in (4, 5))
        assert not torch.equal(one, two)
        assert torch.equal(one, module(clips, torch.Generator().manual_seed(4)))


def test_c3d_fit_with_dropout_resumes_exactly(torch, port, tmp_path):
    """fit of a trainable C3D (width 0.125, dropout 0.5, augment on) on
    resident sets: a run stopped after epoch 0 (save_full_every=1) and
    resumed with resume_full ends with the same weights, velocities and
    history as an uninterrupted run, bit for bit: the dropout masks follow
    (seed, step) like the augment decisions.  Two steps at one (seed, step)
    but another seed give other losses."""
    train, resident, registry = port["train"], port["resident"], port["registry"]

    def setup():
        module = port["c3d"].C3D(CLASSES, WIDTH, clip_thw=(FRAMES, OUT, OUT),
                                 generator=torch.Generator().manual_seed(6))
        bundle = registry.ModelBundle("C3D", module.train(), port["config"].ClipSpec(FRAMES, OUT, OUT), CLASSES,
                                      False, trainable=True)
        rng = np.random.default_rng(7)
        clips = lambda n: {"rgb": rng.integers(0, 256, (n, FRAMES, STAGING, STAGING, 3), dtype=np.uint8)}  # noqa
        tr = resident.ResidentClips(clips(4), rng.integers(0, CLASSES, 4), 2, seed=7, device="cpu")
        va = resident.ResidentClips(clips(2), rng.integers(0, CLASSES, 2), 2, shuffle=False, device="cpu")
        return bundle, tr, va

    kw = dict(augment=True, input_scale=SCALE, seed=3)
    bundle, tr, va = setup()
    whole = train.fit(bundle, tr, va, epochs=2, **kw)
    assert whole["state"].step == 4 and np.isfinite(whole["history"]["loss"]).all()
    first, tr1, va1 = setup()
    train.fit(first, tr1, va1, epochs=1, checkpoint_dir=str(tmp_path), save_full_every=1, **kw)
    resumed, tr2, va2 = setup()
    out = train.fit(resumed, tr2, va2, epochs=2, checkpoint_dir=str(tmp_path), resume_full=True, **kw)
    assert out["history"] == whole["history"] and out["state"].step == 4
    ref = bundle.module.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in resumed.module.state_dict().items())
    opt_a, opt_b = out["state"].optimizer, whole["state"].optimizer
    for (_, pa), (_, pb) in zip(resumed.module.named_parameters(), bundle.module.named_parameters()):
        assert torch.equal(opt_a.state[pa]["velocity"], opt_b.state[pb]["velocity"])

    losses = []
    for seed in (1, 1, 2):
        b, t, _ = setup()
        tx = train.make_optimizer("C3D", 0.003)
        step = train.make_resident_train_step(b, tx, (OUT, OUT), augment=False, input_scale=SCALE)
        losses.append(float(step(train.TrainState.create(b.module, tx, seed=seed), next(t.batches(0)),
                                 torch.ones(CLASSES))[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]
