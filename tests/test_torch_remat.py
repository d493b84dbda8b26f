"""Rematerialised I3D blocks (`remat`, `remat_blocks`) of the PyTorch port, on the CPU.

- One Mixed_3b block (JAX's test shape, (2, 4, 8, 8, 192), f32) in train
  mode through `models.common.remat_call` against JAX's `nn.remat` of the
  same block on the same numpy-seeded variables: output and the gradients
  of Σ y·r within 1e-4 of each value or of its tensor's largest element
  (tests/test_torch_train.py's tolerance for the plain block), and equal to
  the port's plain block bit for bit, running statistics included (the
  recompute updates none, as flax's remat discards its mutations).
- A whole I3D (16×32², f32) through one train step of `make_train_step`
  with remat=True, remat_blocks (a name of no block ignored) and neither:
  the same loss, updated weights and running statistics, bit for bit.
- `quant` with remat raises JAX's ValueError.
- A 2-position CPU mesh step with remat=True (float64) equals the
  unsharded remat step and the plain one (atol 1e-9, as
  tests/test_torch_dataparallel.py holds sharded steps): the recompute
  takes the global BatchNorm moments its first forward took.

torch and the port are imported by fixtures (tests/torch_port_memory.py).
"""

import copy
import importlib
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
SPEC = ji3d.INCEPTION_SPECS["Mixed_3b"]
SHAPE = (2, 4, 8, 8, 192)
B, FRAMES, OUT, STAGING, CLASSES = 4, 16, 32, 40, 3


@pytest.fixture(scope="module")
def port(torch):
    names = ("models.common", "models.i3d", "models.convert", "models.registry", "core.config", "core.mesh",
             "train", "train.engine")
    return {n: importlib.import_module(f"{PORT}.{n}") for n in names}


def flax_variables(module, seed):
    shapes = jax.eval_shape(lambda x: module.init(jax.random.key(0), x, train=False),
                            jax.ShapeDtypeStruct(SHAPE, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(math.prod(s.shape[:-1])), s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, s.shape)
        else:
            v = rng.uniform(0.3, 0.7, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def close_to_scale(got, want, what, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()), err_msg=what)


def test_remat_block_matches_flax_remat(torch, port):
    common, i3d, convert = port["models.common"], port["models.i3d"], port["models.convert"]
    flax_mod = nn.remat(ji3d.InceptionBlock, static_argnums=(2,))(SPEC)
    v = flax_variables(ji3d.InceptionBlock(SPEC), 20)
    rng = np.random.default_rng(21)
    x = rng.normal(size=SHAPE).astype(np.float32)
    r = rng.normal(size=SHAPE[:-1] + (256,)).astype(np.float32)

    def loss_fn(params):
        y, new = flax_mod.apply({"params": params, "batch_stats": v["batch_stats"]}, x, True,
                                mutable=["batch_stats"])
        return jnp.sum(y * r), (y, new["batch_stats"])

    (_, (y_ref, stats_ref)), g_ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    blocks, outs = {}, {}
    for form in ("remat", "plain"):
        block = i3d.InceptionBlock(SHAPE[-1], SPEC)
        block.load_state_dict(convert.i3d_state_dict_from_flax(v))
        block.train()
        xt = common.to_ncdhw(torch.from_numpy(x))
        y = common.remat_call(block, xt) if form == "remat" else block(xt)
        (common.to_nthwc(y) * torch.from_numpy(r)).sum().backward()
        blocks[form], outs[form] = block, common.to_nthwc(y).detach()
    got = blocks["remat"]
    close_to_scale(outs["remat"].numpy(), np.asarray(y_ref), "output")
    want = convert.i3d_state_dict_from_flax({"params": g_ref, "batch_stats": stats_ref})
    state = got.state_dict()
    for k in (k for k in want if k.endswith(("running_mean", "running_var"))):
        close_to_scale(state[k].numpy(), want[k].numpy(), k)
    grads = {n: p.grad for n, p in got.named_parameters() if p.requires_grad}
    for n, g in grads.items():
        close_to_scale(g.numpy(), want[n].numpy(), n)
    assert torch.equal(outs["remat"], outs["plain"])
    plain = dict(blocks["plain"].named_parameters())
    assert all(torch.equal(g, plain[n].grad) for n, g in grads.items())
    assert all(torch.equal(state[k], blocks["plain"].state_dict()[k]) for k in state)


def _bundle(port, **kw):
    module = port["models.i3d"].I3D(CLASSES, frames=FRAMES, generator=torch_gen(31), **kw)
    return port["models.registry"].ModelBundle("I3D", module, port["core.config"].ClipSpec(FRAMES, OUT, OUT), CLASSES,
                                               False, trainable=True)


def torch_gen(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 256, (B, FRAMES, STAGING, STAGING, 3), dtype=np.uint8),
            "label": rng.integers(0, CLASSES, B).astype(np.int32), "valid": np.arange(B) != 2}


def _step(torch, port, bundle, mesh=None):
    """One augmented train step (Keras SGD) → (loss, the module's state)."""
    tx = port["train"].keras_sgd(0.01)
    state = port["train"].TrainState.create(bundle.module, tx, seed=5)
    step = port["train.engine"].make_train_step(bundle, tx, (OUT, OUT), True, input_scale=1 / 255, mesh=mesh)
    dtype = next(bundle.module.parameters()).dtype
    _, metrics = step(state, _batch(32), torch.ones(CLASSES, dtype=dtype))
    return float(metrics["loss"]), {k: v.clone() for k, v in bundle.module.state_dict().items()}


def test_remat_train_step_equals_the_plain_step(torch, port):
    """remat=True and remat_blocks (with a name of no block, which JAX
    ignores) against no remat: loss, weights and running statistics after
    one f32 step, bit for bit."""
    plain = _step(torch, port, _bundle(port))
    for kw in (dict(remat=True), dict(remat_blocks=("Mixed_3c", "Mixed_4f", "Mixed_9z"))):
        bundle = _bundle(port, **kw)
        assert len(bundle.module.trunk.remat_blocks) == (9 if kw.get("remat") else 2)
        loss, state = _step(torch, port, bundle)
        assert loss == plain[0], kw
        assert state.keys() == plain[1].keys()
        assert all(torch.equal(state[k], plain[1][k]) for k in state), kw


@pytest.mark.parametrize("kw", [dict(remat=True), dict(remat_blocks=("Mixed_3b",))], ids=["remat", "remat_blocks"])
def test_quant_with_remat_raises(torch, port, kw):
    """JAX's ValueError, raised by the port when the model is built."""
    with pytest.raises(ValueError, match="incompatible with remat") as jax_err:
        module = ji3d.I3D(num_classes=CLASSES, quant=True, **kw)
        jax.eval_shape(lambda x: module.init(jax.random.key(0), x, train=False),
                       jax.ShapeDtypeStruct((1, FRAMES, OUT, OUT, 3), jnp.float32))
    with pytest.raises(ValueError, match="incompatible with remat") as port_err:
        port["models.i3d"].I3D(CLASSES, frames=FRAMES, quant="static", **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_remat_mesh_step_equals_the_unsharded_step(torch, port):
    """remat=True over a 2-position CPU mesh, float64: equal to the
    unsharded remat step and to the plain step (loss atol 1e-9, every
    weight and running statistic atol 1e-9)."""
    mesh = port["core.mesh"].make_mesh((("data", 2),), [torch.device("cpu")] * 2)
    base = _bundle(port, remat=True)
    base.module.double()
    runs = {}
    for name, remat, m in (("sharded", True, mesh), ("unsharded", True, None), ("plain", False, None)):
        bundle = _bundle(port, remat=remat)
        bundle.module.double().load_state_dict(copy.deepcopy(base.module.state_dict()))
        runs[name] = _step(torch, port, bundle, m)
    want_loss, want = runs["plain"]
    for name in ("sharded", "unsharded"):
        loss, state = runs[name]
        np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-9, err_msg=name)
        for k in want:
            np.testing.assert_allclose(state[k].double().numpy(), want[k].double().numpy(), rtol=0, atol=1e-9,
                                       err_msg=f"{name} {k}")
