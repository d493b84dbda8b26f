"""Data-parallel training of the PyTorch port on the CPU, over 4 positions.

- JAX parity: the port's `make_train_step(mesh=)` and
  `make_resident_train_step(mesh=)` (a `ResidentClips` sharded over the same
  mesh) against JAX's `make_train_step(mesh=)` on 4 of the 8 virtual CPU
  devices, for I3D, C3D and R3D-18 (widths 0.125 where the family has one;
  I3D has none) on the same numpy-seeded flax variables and batch, augment
  off: loss, updated parameters and running statistics.  Both sides take
  plain Keras SGD and compute in float64 (jax.enable_x64), at rtol 1e-4,
  atol 1e-6, as tests/test_torch_train*.py hold the unsharded steps: in
  f32 the two frameworks' rounding alone, through BatchNorm over the few
  samples a channel of these sizes, moves I3D's stem BatchNorm bias by
  1.2e-4 after one step (C3D and R3D-18 hold 2e-5 in f32).  One JAX
  compile a model, shared by the dense and the resident case.
- Port against port with augment on: the sharded step equals the unsharded
  step on the same global batch (C3D with its dropout, R3D-18, TwoStream on
  gray pairs augmented with the rgb's decisions): in float64 over 2 steps
  (TwoStream 1; loss at atol 1e-6, every weight and running statistic at
  atol 1e-9),
  in f32 the first step's loss at atol 2e-5; and each position's
  preprocessed inputs are bit-equal to the unsharded ones' rows: the noise
  through the plain version at each position's clip offset.
- Positions on a device other than the module's train through copies
  whose gradients add onto the module's, equal to the unsharded step.
- BatchNorm over shards of different means takes the global moments.
- The sharded `ResidentClips` against JAX's `ResidentClips(mesh=)`: shards,
  padding, batches, `valid` and `index` (numpy only, nothing compiled).
- The multi-member step on a (member 2, data 2) mesh equals the unsharded
  member loop.
- The mesh serving artifact, served over a (member 2, data 2) mesh, equals
  the single-card artifact.
- The noise plain version on rows [k, k + n) with `clip_offset=k` equals
  those rows of the whole call, exactly.

Global B=8 (4 a position), 16×32² clips staged at 40².  torch and the port
are imported by fixtures (tests/torch_port_memory.py).
"""

import copy
import functools
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.core import mesh as jmesh
from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec as JClip
from crowded_scenes_ensemble_classification_tpu.data import resident as jresident
from crowded_scenes_ensemble_classification_tpu.flow import farneback as jfb
from crowded_scenes_ensemble_classification_tpu.models import c3d as jc3d
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from crowded_scenes_ensemble_classification_tpu.models import r3d as jr3d
from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JBundle
from crowded_scenes_ensemble_classification_tpu.train import engine as jengine
from crowded_scenes_ensemble_classification_tpu.train import state as jstate
from test_torch_zoo import fill_variables, flax_shapes
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
N, B, CLASSES, FRAMES, OUT, STAGING = 4, 8, 3, 16, 32, 40
LR, SCALE, F32_ATOL = 0.01, 1 / 255.0, 2e-5
JAX_TOL = dict(rtol=1e-4, atol=1e-6)
CLASS_WEIGHTS = np.array([0.5, 1.0, 2.0], np.float32)
FLOW_PARAMS = dict(jfb.TURBO_PARAMS, max_disp=4)  # as tests/test_torch_zoo.py
LEVEL1 = {"xla_backend_optimization_level": 1}  # float64 steps run 10-20× slower at level 0


@pytest.fixture(scope="module")
def port(torch):
    names = ("core.mesh", "core.lockstep", "core.config", "models.c3d", "models.r3d", "models.i3d",
             "models.two_stream_i3d", "models.common", "models.convert", "models.registry", "data.resident",
             "ops.augment", "ops.kernels.noise", "train", "train.engine", "train.multi_member", "ensemble.members")
    return SimpleNamespace(**{n.replace(".", "_"): importlib.import_module(f"{PORT}.{n}") for n in names})


@pytest.fixture(scope="module")
def cpu_mesh(torch, port):
    return port.core_mesh.make_mesh((("data", N),), [torch.device("cpu")] * N)


def _flax_module(kind, dtype=jnp.float32):
    if kind == "I3D":
        return ji3d.I3D(num_classes=CLASSES, dtype=dtype)
    if kind == "C3D":
        return jc3d.C3D(num_classes=CLASSES, width=0.125, dropout_rate=0.0, dtype=dtype)
    return jr3d.R3D(num_classes=CLASSES, depth=18, width=0.125, dtype=dtype)


def _port_module(port, kind, **kw):
    if kind == "I3D":
        return port.models_i3d.I3D(CLASSES, frames=FRAMES, **kw)
    if kind == "C3D":
        return port.models_c3d.C3D(CLASSES, 0.125, clip_thw=(FRAMES, OUT, OUT), **kw)
    if kind == "TWOSTREAM_I3D":
        return port.models_two_stream_i3d.TwoStreamI3D(CLASSES, frames=FRAMES, **kw)
    return port.models_r3d.R3D(CLASSES, 18, 0.125, **kw)


def _bundle(torch, port, kind, module):
    return port.models_registry.ModelBundle(kind, module, port.core_config.ClipSpec(FRAMES, OUT, OUT), CLASSES,
                                            kind == "TWOSTREAM_I3D", trainable=True)


def _batch(seed, gray=False):
    rng = np.random.default_rng(seed)
    out = {"rgb": rng.integers(0, 256, (B, FRAMES, STAGING, STAGING, 3), dtype=np.uint8),
           "label": rng.integers(0, CLASSES, B).astype(np.int32),
           "valid": np.arange(B) != 5}  # one invalid row, on the third position
    if gray:
        base = rng.integers(0, 256, (B, FRAMES, STAGING, STAGING, 1)).astype(np.float32)
        out["gray"], out["gray_next"] = base, np.roll(base, 1, axis=3)
    return out


@functools.lru_cache(maxsize=None)
def _jax_reference(kind):
    """JAX's float64 data-parallel step on ('data', 4): (variables, batch,
    loss, the updated variables by port name)."""
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.models.convert import state_dict_from_flax

    variables = fill_variables(flax_shapes(_flax_module(kind), (1, FRAMES, OUT, OUT, 3)), seed=40)
    batch = _batch(41)
    with jax.enable_x64(True):
        module = _flax_module(kind, jnp.float64)
        mesh = jmesh.make_mesh((("data", N),), jax.devices()[:N])
        tx = jstate.keras_sgd(LR)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        state = jax.jit(lambda v, k: jstate.TrainState.create(v, tx, k))(v64, jax.random.key(0))
        step = jengine.make_train_step(JBundle(kind, module, JClip(FRAMES, OUT, OUT), CLASSES, False), tx,
                                       (OUT, OUT), augment=False, mesh=mesh, input_scale=SCALE)
        cw = jnp.asarray(CLASS_WEIGHTS, jnp.float64)
        state, metrics = step.lower(state, batch, cw).compile(LEVEL1)(state, batch, cw)
        tree = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    updated = {k: v.numpy() for k, v in state_dict_from_flax(kind, tree, torch.float64).items()
               if v.is_floating_point()}
    return variables, batch, float(metrics["loss"]), updated


def _state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items() if v.is_floating_point()}


def _assert_state(module, want, what, rtol, atol):
    got = _state(module)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if not np.all(np.abs(got[k] - v) <= atol + rtol * np.abs(v)):  # the vectorized test first: many tensors
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


# ----------------------------------------------------------------------
# JAX parity: the data-parallel steps
# ----------------------------------------------------------------------


@pytest.mark.parametrize("resident", [False, True], ids=["dense", "resident"])
@pytest.mark.parametrize("kind", ["I3D", "C3D", "R3D_18"])
def test_data_parallel_step_matches_jax(torch, port, cpu_mesh, kind, resident):
    """One float64 data-parallel step over 4 positions against JAX's GSPMD
    step on the same variables and global batch: loss, parameters after the
    update and running statistics (global-batch BatchNorm)."""
    variables, batch, jloss, want = _jax_reference(kind)
    with torch.device("meta"):
        module = _port_module(port, kind, **({"dropout_rate": 0.0} if kind == "C3D" else {}))
    start = port.models_convert.state_dict_from_flax(kind, variables, torch.float64)
    module.load_state_dict({k: v.clone() for k, v in start.items()}, assign=True)
    bundle = _bundle(torch, port, kind, module)
    tx = port.train.keras_sgd(LR)
    state = port.train.TrainState.create(module, tx)
    engine = port.train_engine
    if resident:
        clips = port.data_resident.ResidentClips({"rgb": batch["rgb"]}, batch["label"], B, shuffle=False,
                                                 mesh=cpu_mesh)
        step_batch = next(iter(clips.batches(0)))
        np.testing.assert_array_equal(step_batch["index"], np.arange(B))  # the dense batch's rows, in order
        step_batch["valid"] = batch["valid"]
        step = engine.make_resident_train_step(bundle, tx, (OUT, OUT), False, input_scale=SCALE, mesh=cpu_mesh)
    else:
        step_batch = batch
        step = engine.make_train_step(bundle, tx, (OUT, OUT), False, input_scale=SCALE, mesh=cpu_mesh)
    state, metrics = step(state, step_batch, torch.from_numpy(CLASS_WEIGHTS).double())
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jloss, **JAX_TOL)
    _assert_state(module, want, f"{kind} {'resident' if resident else 'dense'}", **JAX_TOL)


# ----------------------------------------------------------------------
# Port against port, augment on
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["C3D", "R3D_18", "TWOSTREAM_I3D"])
def test_sharded_augmented_step_equals_unsharded(torch, port, cpu_mesh, kind):
    """Augment on (C3D with dropout 0.5; TwoStream's flow from gray pairs
    augmented with the rgb's decisions): every position's inputs are the
    unsharded inputs' rows bit for bit; 2 sharded float64 steps (TwoStream:
    1) equal the unsharded ones (loss, accuracy, weights, running
    statistics), and the first f32 step's loss too (not TwoStream's)."""
    engine = port.train_engine
    two = kind == "TWOSTREAM_I3D"
    batch = _batch(50, gray=two)
    kw = dict(input_scale=SCALE, flow_params=FLOW_PARAMS, flow_from_augmented=True) if two else \
        dict(input_scale=SCALE)

    decisions = port.ops_augment.draw_decisions(port.ops_augment.step_generator(7, 0), B, (STAGING, STAGING), 0.75)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    args = ((OUT, OUT), two, SCALE, False, kw.get("flow_params"), two)
    full = engine._preprocess(tensors, decisions, *args)
    for shard, start in zip(engine._split_batch(batch, [torch.device("cpu")] * N), range(0, B, B // N)):
        part = engine._preprocess(shard, decisions.rows(start, start + B // N), *args, start, B)
        assert part.keys() == full.keys()
        for k in full:
            assert torch.equal(part[k], full[k][start:start + B // N]), (k, start)

    module = _port_module(port, kind, generator=torch.Generator().manual_seed(51))
    tx = port.train.keras_sgd(LR)
    # TwoStream, at full width, takes one float64 step and no f32 one: the file's time budget
    runs = ((torch.float64, [batch]),) if two else ((torch.float64, [batch, _batch(52)]), (torch.float32, [batch]))
    for dtype, batches in runs:
        plain = _bundle(torch, port, kind, copy.deepcopy(module).to(dtype))
        sharded = _bundle(torch, port, kind, copy.deepcopy(plain.module))
        states = [port.train.TrainState.create(b.module, tx, seed=7) for b in (plain, sharded)]
        steps = [engine.make_train_step(plain, tx, (OUT, OUT), True, **kw),
                 engine.make_train_step(sharded, tx, (OUT, OUT), True, mesh=cpu_mesh, **kw)]
        cw = torch.from_numpy(CLASS_WEIGHTS).to(dtype)
        for i, b in enumerate(batches):
            (_, want), (_, got) = (step(state, b, cw) for step, state in zip(steps, states))
            np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=0,
                                       atol=1e-6 if dtype == torch.float64 else F32_ATOL, err_msg=f"{dtype} step {i}")
            assert float(got["accuracy"]) == float(want["accuracy"])
        if dtype == torch.float64:
            _assert_state(sharded.module, _state(plain.module), kind, rtol=0, atol=1e-9)


def test_positions_off_the_module_device_train_through_copies(torch, port):
    """Positions on a device other than the module's (here `cpu:0`, which
    torch tells apart from `cpu` though both are the host) train a copy of
    the module, refreshed each step, whose gradients add onto the module's:
    2 float64 steps and an eval over such a mesh equal the unsharded ones
    (R3D-18, BatchNorm in every block)."""
    engine = port.train_engine
    mesh = port.core_mesh.make_mesh((("data", N),), [torch.device("cpu"), torch.device("cpu", 0)] * (N // 2))
    module = _port_module(port, "R3D_18", generator=torch.Generator().manual_seed(55)).double()
    plain, sharded = (_bundle(torch, port, "R3D_18", m) for m in (module, copy.deepcopy(module)))
    tx = port.train.keras_sgd(LR)
    states = [port.train.TrainState.create(b.module, tx, seed=3) for b in (plain, sharded)]
    steps = [engine.make_train_step(plain, tx, (OUT, OUT), True, input_scale=SCALE),
             engine.make_train_step(sharded, tx, (OUT, OUT), True, input_scale=SCALE, mesh=mesh)]
    cw = torch.from_numpy(CLASS_WEIGHTS).double()
    for seed in (56, 57):
        (_, want), (_, got) = (step(state, _batch(seed), cw) for step, state in zip(steps, states))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=0, atol=1e-6)
    _assert_state(sharded.module, _state(plain.module), "copies", rtol=0, atol=1e-9)
    evals = [engine.make_eval_step(plain, (OUT, OUT), input_scale=SCALE),
             engine.make_eval_step(sharded, (OUT, OUT), input_scale=SCALE, mesh=mesh)]
    want, got = (e(_batch(58)) for e in evals)
    for k in ("loss_sum", "correct", "count", "probs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


def test_batch_norm_moments_are_global(torch, port):
    """Positions whose shards have different means normalise by the global
    batch's moments, as BatchNorm over the concatenated batch does; the
    running statistics move once, by those moments; gradients through the
    summed moments equal the unsharded ones."""
    lockstep = port.core_lockstep
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, 5, 2, 3, 3, generator=gen) + torch.arange(B).repeat_interleave(B // N).view(-1, 1, 1, 1, 1)[:B]
    x = (x + 3.0 * torch.arange(N).repeat_interleave(B // N).view(-1, 1, 1, 1, 1)).requires_grad_(True)
    bn = port.models_common.KerasBatchNorm3d(5, scale=True).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0.0, 0.3, generator=gen)
    ref = copy.deepcopy(bn)
    w = torch.randn(x.shape, generator=gen)

    y_ref = ref(x)
    (y_ref * w).sum().backward()
    grads_ref = [t.grad.clone() for t in (x, ref.weight, ref.bias)]
    x.grad = None

    rows = B // N
    step = lockstep.Lockstep(N)
    shards = [lockstep.Shard(i, torch.device("cpu"), i * rows, rows, B, step, i == 0) for i in range(N)]
    ys = lockstep.run_positions(lambda s: bn(x[s.start:s.start + s.rows]), shards)
    y = torch.cat(ys)
    (y * w).sum().backward()
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=0)
    for got, want in zip((x.grad, bn.weight.grad, bn.bias.grad), grads_ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(bn.running_mean, ref.running_mean, atol=1e-6, rtol=0)
    torch.testing.assert_close(bn.running_var, ref.running_var, atol=1e-5, rtol=1e-6)
    alone = copy.deepcopy(ref).train()(x[:rows].detach())  # a shard's own moments normalise differently
    assert (alone - y[:rows]).abs().max() > 0.5


# ----------------------------------------------------------------------
# The sharded ResidentClips against JAX's
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,pad_to,preshuffle,tile,drop_last", [
    (10, 4, None, 3, 1, False),
    (13, 8, 20, None, 2, False),
    (7, 4, None, 5, 1, True),
    (9, 8, None, None, 1, False),
])
def test_sharded_resident_clips_match_jax(torch, port, cpu_mesh, n, batch, pad_to, preshuffle, tile, drop_last):
    rng = np.random.default_rng(n)
    rgb = rng.integers(0, 256, (n, 2, 3, 3, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, n)
    kw = dict(seed=11, augmentation_frequency=tile, drop_last=drop_last, preshuffle=preshuffle, pad_to=pad_to)
    j = jresident.ResidentClips({"rgb": rgb}, labels, batch, mesh=jmesh.make_mesh((("data", N),),
                                                                                 jax.devices()[:N]), **kw)
    p = port.data_resident.ResidentClips({"rgb": rgb}, labels, batch, mesh=cpu_mesh, **kw)
    assert (p.n_shards, p.n_padded, len(p)) == (j.n_shards, j.n_padded, len(j))
    for name in ("rgb", "label"):
        shards = p.resident[name]
        assert len(shards) == N and all(s.shape[0] == p.n_padded // N for s in shards)
        np.testing.assert_array_equal(np.concatenate([s.numpy() for s in shards]), np.asarray(j.resident[name]))
    assert p.nbytes == p.n_padded * (rgb[0].size + 4)
    for epoch in (0, 1):
        got, want = list(p.batches(epoch)), list(j.batches(epoch))
        assert len(got) == len(want) == len(p)
        for g, w in zip(got, want):
            for k in ("indices", "valid", "index"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ----------------------------------------------------------------------
# The member-sharded multi-member step
# ----------------------------------------------------------------------


def test_member_sharded_multi_member_step_equals_the_loop(torch, port):
    """4 R3D-18 members (BatchNorm in every block) on a (member 2, data 2)
    mesh: 2 float64 steps with augment on equal the unsharded member loop's,
    member by member (loss, accuracy, weights, running statistics)."""
    mm = port.train_multi_member
    mesh = port.core_mesh.make_mesh((("member", 2), ("data", 2)), [torch.device("cpu")] * 4)
    members = [_port_module(port, "R3D_18", generator=torch.Generator().manual_seed(60 + m)).double()
               for m in range(4)]
    twins = [copy.deepcopy(m) for m in members]
    bundle = _bundle(torch, port, "R3D_18", members[0])
    tx = port.train.keras_sgd(LR)
    plain = mm.make_multi_member_train_step(bundle, tx, (OUT, OUT), True, input_scale=SCALE)
    sharded = mm.make_multi_member_train_step(bundle, tx, (OUT, OUT), True, input_scale=SCALE, mesh=mesh)
    states = [[port.train.TrainState.create(m, tx, seed=s) for s, m in enumerate(ms)] for ms in (members, twins)]
    cw = torch.from_numpy(CLASS_WEIGHTS).double()
    for i in range(2):
        batches = [_batch(70 + 4 * i + m) for m in range(4)]
        stacked = {k: np.stack([b[k][:4] for b in batches]) for k in batches[0]}
        (_, want), (_, got) = plain(states[0], stacked, cw), sharded(states[1], stacked, cw)
        np.testing.assert_allclose(got["loss"].numpy(), want["loss"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["accuracy"].numpy(), want["accuracy"].numpy())
    for m, t in zip(members, twins):
        _assert_state(t, _state(m), "member", rtol=0, atol=1e-9)


# ----------------------------------------------------------------------
# The mesh serving artifact
# ----------------------------------------------------------------------


def test_mesh_artifact_equals_single_card_artifact(torch, port, tmp_path):
    """4 width-0.125 C3D members exported over a (member 2, data 2) mesh
    (the lean program of one position, metadata "mesh"), saved, loaded and
    served with their stacked params: probabilities and fused scores equal
    the baked single-card artifact's at atol 2e-5 (JAX
    tests/test_serving.py:232-262), predictions equal."""
    serving = importlib.import_module(f"{PORT}.serving")
    members = [_bundle(torch, port, "C3D", _port_module(port, "C3D", generator=torch.Generator().manual_seed(80 + m))
                       .eval()) for m in range(4)]
    for b in members:
        b.trainable = False
    example = serving.serving_batch_example(members[0], 4, serve_hw=(STAGING, STAGING))
    weights = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
    mesh = port.core_mesh.make_mesh((("member", 2), ("data", 2)), [torch.device("cpu")] * 4)
    served = {}
    for name, kw in (("single", {}), ("mesh", {"mesh": mesh})):
        program = serving.export_ensemble(members, example, weights=weights, input_scale=SCALE, **kw)
        meta = {"fusion_weights": weights.tolist(), "mesh": {"member": 2, "data": 2} if kw else None}
        fn, loaded = serving.load_serving_artifact(
            serving.save_serving_artifact(str(tmp_path / f"{name}.zip"), program, meta), "cpu")
        assert loaded["device"] == "cpu"
        batch = {"rgb": torch.from_numpy(_batch(81)["rgb"][:4])}
        params = port.ensemble_members.stack_variables([b.module.state_dict() for b in members])
        served[name] = fn(params, batch) if kw else fn(batch)
    for k in ("probs", "fused"):
        torch.testing.assert_close(served["mesh"][k], served["single"][k], atol=2e-5, rtol=0)
    assert served["mesh"]["probs"].shape == (4, 4, CLASSES)
    assert torch.equal(served["mesh"]["preds"], served["single"]["preds"])


# ----------------------------------------------------------------------
# The noise kernel's clip offset
# ----------------------------------------------------------------------


@pytest.mark.parametrize("start,rows", [(0, 3), (2, 3), (5, 2), (6, 1)])
def test_noise_clip_offset_draws_the_global_rows(torch, port, start, rows):
    """The plain version (and the op's CPU path) on rows [start, start +
    rows) with clip_offset=start equals those rows of the call on all 7,
    exactly; so do the Philox words."""
    noise = port.ops_kernels_noise
    gen = torch.Generator().manual_seed(start)
    x = torch.randint(1, 255, (7, 5, 6, 6, 3), generator=gen).float()
    salt, pepper = torch.rand(7, generator=gen) < 0.75, torch.rand(7, generator=gen) < 0.75
    seed = 2**45 + 9
    full = noise.salt_pepper_plain(x, seed, salt, pepper, 20)
    part = slice(start, start + rows)
    got = noise.salt_pepper_plain(x[part], seed, salt[part], pepper[part], 20, clip_offset=start)
    assert torch.equal(got, full[part])
    assert torch.equal(noise.salt_pepper(x[part].contiguous(), seed, salt[part], pepper[part], 20, start), got)
    assert torch.equal(noise.philox_bits(seed, rows, 540, "cpu", start), noise.philox_bits(seed, 7, 540, "cpu")[part])
    assert not torch.equal(noise.salt_pepper_plain(x[part], seed, salt[part], pepper[part], 20), got) or start == 0
    with pytest.raises(ValueError, match="clip_offset"):
        noise.salt_pepper(x[part].contiguous(), seed, salt[part], pepper[part], 20, 2**32 - rows + 1)
