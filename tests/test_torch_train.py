"""Parity of the PyTorch port's training path with the JAX package and the
float64 oracle (tests/oracle_train.py), on the CPU.

Inputs come from numpy seeds; each check states its tolerance.  The
kernels run their plain versions here (CPU tensors); the card holds them
to those versions (tests/test_torch_cuda.py, chip_smoke.py).  torch and the
port are imported by fixtures, not at collection (tests/torch_port_memory.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import oracle_train
import pytest

from crowded_scenes_ensemble_classification_tpu.models import common as jcommon
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from test_torch_models import random_flax_variables
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"


@pytest.fixture(scope="module")
def port(torch):
    """The port's modules this file drives, by short name."""
    names = ("models.common", "models.i3d", "models.registry", "models.convert", "core.config",
             "ops.kernels.maxpool", "ops.kernels.stem_conv", "data.resident", "train")
    return {n.split(".")[-1]: importlib.import_module(f"{PORT}.{n}") for n in names}


def _rel_close(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)


# ----------------------------------------------------------------------
# Optimizers and BatchNorm against the float64 oracle
# ----------------------------------------------------------------------

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


def _oracle_params(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s) for k, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _port_step(torch, opt, tensors, grads):
    for k, p in tensors.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()


def test_keras_sgd_matches_oracle(torch, port):
    """keras_sgd(momentum 0.9) in float64, 3 steps with a 10× LR drop before
    the third, against oracle_train.keras_sgd_update: params and velocity
    to 1e-5 relative."""
    train = port["train"]
    params, grads = _oracle_params(0)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = train.keras_sgd(0.01, momentum=0.9)(list(tensors.values()))
    velocity = {k: np.zeros(s) for k, s in SHAPES.items()}
    lr = 0.01
    for i, g in enumerate(grads):
        if i == 2:
            lr = 0.001
            train.set_learning_rate(opt, lr)
        params, velocity = oracle_train.keras_sgd_update(params, g, velocity, lr, momentum=0.9)
        _port_step(torch, opt, tensors, g)
        _rel_close({k: t.detach().numpy() for k, t in tensors.items()}, params, 1e-5)
        _rel_close({k: opt.state[t]["velocity"].numpy() for k, t in tensors.items()}, velocity, 1e-5)
    assert train.get_learning_rate(opt) == 0.001


def test_keras_adam_matches_oracle(torch, port):
    """keras_adam(eps=1e-7) in float64, 3 steps, against
    oracle_train.keras_adam_update (eps outside the sqrt, on the
    uncorrected v): params and both moments to 1e-5 relative."""
    train = port["train"]
    params, grads = _oracle_params(1)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = train.keras_adam(1e-3, eps=1e-7)(list(tensors.values()))
    m = {k: np.zeros(s) for k, s in SHAPES.items()}
    v = {k: np.zeros(s) for k, s in SHAPES.items()}
    for t, g in enumerate(grads, start=1):
        params, m, v = oracle_train.keras_adam_update(params, g, m, v, t, 1e-3, eps=1e-7)
        _port_step(torch, opt, tensors, g)
        _rel_close({k: x.detach().numpy() for k, x in tensors.items()}, params, 1e-5)
        _rel_close({k: opt.state[x]["m"].numpy() for k, x in tensors.items()}, m, 1e-5)
        _rel_close({k: opt.state[x]["v"].numpy() for k, x in tensors.items()}, v, 1e-5)


def test_make_optimizer_table(torch, port):
    """The reference's table: SGD momentum 0.9 for I3D, plain SGD for C3D,
    Adam (eps 1e-7) for R3D; not torch.optim's SGD or Adam."""
    state = importlib.import_module(f"{PORT}.train.state")
    p = [torch.zeros(2, requires_grad=True)]
    i3d, c3d, r3d = (port["train"].make_optimizer(t, 0.003)(p) for t in ("I3D", "C3D", "R3D_18"))
    assert type(i3d) is state.KerasSGD and i3d.param_groups[0]["momentum"] == 0.9
    assert type(c3d) is state.KerasSGD and c3d.param_groups[0]["momentum"] == 0.0
    assert type(r3d) is state.KerasAdam and r3d.param_groups[0]["eps"] == 1e-7
    with pytest.raises(ValueError):
        port["train"].make_optimizer("VGG", 0.1)


def test_batchnorm_train_matches_oracle(torch, port):
    """KerasBatchNorm3d in train mode, float64, against oracle_train.bn_train
    / bn_train_bwd: output, the updated running mean and (biased) variance,
    dx and dbias to 1e-5; the frozen weight gets no gradient.  Eval mode is
    nn.BatchNorm3d's."""
    common = port["common"]
    rng = np.random.default_rng(2)
    x = rng.normal(1.5, 2.0, (2, 3, 4, 5, 6))  # NTHWC
    bias, mean, var = rng.normal(size=6), rng.normal(size=6), rng.uniform(0.5, 1.5, 6)
    dy = rng.normal(size=x.shape)
    y_ref, cache, stats = oracle_train.bn_train(x, {"bias": bias}, {"mean": mean, "var": var})
    dx_ref, dparams = oracle_train.bn_train_bwd(dy, cache)

    bn = common.KerasBatchNorm3d(6).double().train()
    with torch.no_grad():
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xt = common.to_ncdhw(torch.from_numpy(x)).requires_grad_()
    y = bn(xt)
    y.backward(common.to_ncdhw(torch.from_numpy(dy)))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(common.to_nthwc(y).detach().numpy(), y_ref, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], **tol)
    np.testing.assert_allclose(common.to_nthwc(xt.grad).numpy(), dx_ref, **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), dparams["bias"], **tol)
    assert bn.weight.grad is None and not bn.weight.requires_grad

    bn.eval()
    with torch.no_grad():
        plain = torch.nn.functional.batch_norm(xt, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                               False, 0.0, bn.eps)
        assert torch.equal(bn(xt), plain)


# ----------------------------------------------------------------------
# The max-pool gradient and the ops' autograd registrations
# ----------------------------------------------------------------------


def _tie_heavy(shape, seed):
    """Integers 0..3 (ties everywhere) with the first half of H zeroed (the
    ReLU plateau), and integer dy, so every sum is exact in any order."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.integers(-3, 4, shape), 0).astype(np.float32)
    x[:, :, : shape[2] // 2] = 0
    return x, rng.integers(-4, 5, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 4), (1, 1, 4, 4, 3), (2, 4, 6, 6, 8), (1, 5, 3, 2, 2)])
def test_max_pool_backward_equals_jax_vjp(torch, port, shape):
    """The plain version of the gradient and autograd through the op both
    equal `jax.vjp` of the JAX `max_pool_3d(x, (3,3,3), (1,1,1), 'SAME')`
    exactly, on tie-heavy integer inputs: the first maximum of each window
    in (t, h, w) order takes the gradient."""
    mp = port["maxpool"]
    x, dy = _tie_heavy(shape, sum(shape))
    _, vjp = jax.vjp(lambda a: jcommon.max_pool_3d(a, (3, 3, 3), (1, 1, 1), "SAME"), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(dy))[0])
    assert (ref != 0).any()
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    np.testing.assert_array_equal(mp.max_pool_3x3x3_backward_reference(xt, dyt).numpy(), ref)
    np.testing.assert_array_equal(mp.max_pool_3x3x3_same_backward(xt, dyt).numpy(), ref)
    xg = xt.clone().requires_grad_()
    mp.max_pool_3x3x3_same(xg).backward(dyt)
    np.testing.assert_array_equal(xg.grad.numpy(), ref)


def test_opcheck_ops_with_a_backward(torch, port):
    """torch.library.opcheck (schema, autograd registration, fake tensors,
    AOT dispatch) of the max-pool op and its gradient op, and of the stem
    op with and without an input gradient."""
    mp, sc = port["maxpool"], port["stem_conv"]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 4, 5, 6, generator=gen)
    torch.library.opcheck(mp._max_pool_op, (x.clone().requires_grad_(),))
    torch.library.opcheck(mp._max_pool_backward_op, (x, torch.randn(x.shape, generator=gen)))
    clips = torch.randn(2, 4, 10, 12, 3, generator=gen)
    w = torch.randn(5, 3, 7, 7, 7, generator=gen).requires_grad_()
    torch.library.opcheck(sc._stem_op, (clips.clone().requires_grad_(), w))
    torch.library.opcheck(sc._stem_op, (clips, w))


def test_stem_op_gradient_is_the_canonical_conv(torch, port):
    """The stem op's gradient in x and weight equals autograd of the plain
    TF-SAME conv (float64, 1e-10), and passes gradcheck."""
    sc = port["stem_conv"]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 10, 12, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(5, 3, 7, 7, 7, dtype=torch.float64, generator=gen, requires_grad=True)
    dy = torch.randn(2, 2, 5, 6, 5, dtype=torch.float64, generator=gen)
    got = torch.autograd.grad(sc.stem_conv_7x7x7_s2(x, w), (x, w), dy)
    want = torch.autograd.grad(sc.stem_conv_7x7x7_s2_reference(x, w), (x, w), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    torch.autograd.gradcheck(sc.stem_conv_7x7x7_s2, (x[:1, :2, :6, :6], w[:2]))


# ----------------------------------------------------------------------
# Modules in train mode against flax
# ----------------------------------------------------------------------


def _flax_tree_to_port(tree):
    """flax {'params', 'batch_stats'} (numpy leaves, any float dtype) → port
    state-dict names with values in their own dtype: models/convert's
    mapping, without its cast to f32."""
    out = {}

    def walk(node, path):
        for k, leaf in node.items():
            if hasattr(leaf, "items"):
                walk(leaf, path + (k,))
                continue
            mod, leaf = ".".join(path[1:]), np.asarray(leaf)
            if k == "kernel":
                out[f"{mod}.weight"] = leaf.transpose(4, 3, 0, 1, 2) if path[-1] == "conv" else leaf.T
            else:
                out[f"{mod}.{ {'bias': 'bias', 'mean': 'running_mean', 'var': 'running_var'}[k] }"] = leaf

    walk(tree, ())
    return out


def _close_to_scale(got, want, what, rtol=1e-4):
    """Elementwise within rtol of the value, or of the tensor's largest
    element for values near zero."""
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()), err_msg=what)


def test_inception_block_train_matches_flax(torch, port):
    """InceptionBlock (Mixed_3b spec) in train mode against flax's
    `InceptionBlock(...)(x, train=True)` with mutable batch_stats, at
    (2,4,8,8,192) f32: outputs, updated batch statistics and the gradients
    of Σ y·r in every parameter to rtol 1e-4 of each value or of its
    tensor's largest element (flax takes the variance as E[x²]−E[x]², torch
    in two passes: a few outputs of O(1) move by up to 3.3e-6)."""
    common, i3d, convert = port["common"], port["i3d"], port["convert"]
    spec = i3d.INCEPTION_SPECS["Mixed_3b"]
    shape = (2, 4, 8, 8, 192)
    flax_mod = ji3d.InceptionBlock(spec)
    v = random_flax_variables(flax_mod, shape, seed=40)
    rng = np.random.default_rng(41)
    x = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=shape[:-1] + (256,)).astype(np.float32)

    def loss_fn(params):
        y, new = flax_mod.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(y * r), (y, new["batch_stats"])

    (_, (y_ref, stats_ref)), g_ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    block = i3d.InceptionBlock(192, spec)
    block.load_state_dict(convert.i3d_state_dict_from_flax(v))
    block.train()
    y = block(common.to_ncdhw(torch.from_numpy(x)))
    (common.to_nthwc(y) * torch.from_numpy(r)).sum().backward()
    _close_to_scale(common.to_nthwc(y).detach().numpy(), np.asarray(y_ref), "output")
    got = block.state_dict()
    for k, want in _flax_tree_to_port({"batch_stats": stats_ref}).items():
        _close_to_scale(got[k].numpy(), want, k)
    grads = {n: p.grad.numpy() for n, p in block.named_parameters() if p.requires_grad}
    want_grads = _flax_tree_to_port({"params": g_ref})
    assert grads.keys() == want_grads.keys()
    for k, want in want_grads.items():
        _close_to_scale(grads[k], want, k)


def _velocity(opt, module):
    return {n: opt.state[p]["velocity"].numpy() for n, p in module.named_parameters() if p.requires_grad}


def test_train_step_matches_jax(torch, port):
    """The whole slice: the port's make_train_step against the JAX
    make_train_step, 2 steps with make_optimizer("I3D", 0.003): full-width
    I3D at (2,16,32,32,3) uint8, augment off, input_scale 1/255, non-uniform
    class weights and one invalid row, weights carried over by
    models/convert.

    Both sides compute in float64 (jax.enable_x64 and I3D(dtype=float64);
    the port's module in double): after each step the loss, params,
    BatchNorm statistics and velocities agree to rtol 1e-4, atol 1e-6.  In
    f32 the frameworks' own rounding (near-ties of the strided max pools,
    BatchNorm over 4 samples a channel at Mixed_5*, flax's E[x²]−E[x]²)
    moves the parameters by up to 1.3 % of a tensor's largest element after
    one step.  So in f32 the port's first-step loss is held to the
    reference's, to 5e-4 relative, and its params and BatchNorm statistics
    after that step to its own float64 run (which the reference holds), to
    0.5 % of each tensor's largest element."""
    from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec as JClip
    from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JBundle
    from crowded_scenes_ensemble_classification_tpu.train import engine as jengine
    from crowded_scenes_ensemble_classification_tpu.train import state as jstate

    i3d, registry, convert, config, train = (port[k] for k in ("i3d", "registry", "convert", "config", "train"))
    shape, scale, lr = (2, 16, 32, 32, 3), 1 / 255.0, 0.003
    v = random_flax_variables(ji3d.I3D(num_classes=11), (1,) + shape[1:], seed=42)
    rng = np.random.default_rng(43)
    batches = [{"rgb": rng.integers(0, 256, shape, dtype=np.uint8), "label": np.array([3, 7], np.int32),
                "valid": np.array([True, i == 0])} for i in range(2)]
    cw = np.linspace(0.5, 2.0, 11)

    def jax_run(dtype, steps):  # → [(loss, params and stats, velocity)] after each step
        flax_mod = ji3d.I3D(num_classes=11, dtype=dtype)
        jbundle = JBundle("I3D", flax_mod, JClip(16, 32, 32), 11, False)
        jtx = jstate.make_optimizer("I3D", lr)
        jstep = jengine.make_train_step(jbundle, jtx, (32, 32), augment=False, input_scale=scale)
        jst = jstate.TrainState.create(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v), jtx,
                                       jax.random.key(0))
        out = []
        for batch in batches[:steps]:
            jst, jm = jstep(jst, {k: jnp.asarray(a) for k, a in batch.items()}, jnp.asarray(cw, dtype))
            velocity = _flax_tree_to_port({"params": jst.opt_state.inner_state.velocity})
            out.append((float(jm["loss"]), _flax_tree_to_port({"params": jst.params, "batch_stats": jst.batch_stats}),
                        velocity))
        return out

    def port_step(dtype):
        module = i3d.I3D(11, frames=16)
        module.load_state_dict(convert.i3d_state_dict_from_flax(v))
        module.to(dtype)
        bundle = registry.ModelBundle("I3D", module, config.ClipSpec(16, 32, 32), 11, False, trainable=True)
        tx = train.make_optimizer("I3D", lr)
        step = train.make_train_step(bundle, tx, (32, 32), augment=False, input_scale=scale)
        return module, train.TrainState.create(module, tx), step

    with jax.enable_x64(True):
        ref = jax_run(jnp.float64, 2)
    module32, state32, step32 = port_step(torch.float32)
    _, m = step32(state32, {k: torch.from_numpy(a) for k, a in batches[0].items()}, torch.from_numpy(cw).float())
    np.testing.assert_allclose(float(m["loss"]), ref[0][0], rtol=5e-4)
    after32 = {k: t.double().numpy() for k, t in module32.state_dict().items() if t.is_floating_point()}
    module, state, step = port_step(torch.float64)
    tol = dict(rtol=1e-4, atol=1e-6)
    for i, (batch, (jloss, jparams, jvelocity)) in enumerate(zip(batches, ref)):
        state, m = step(state, {k: torch.from_numpy(a) for k, a in batch.items()}, torch.from_numpy(cw))
        np.testing.assert_allclose(float(m["loss"]), jloss, **tol)
        got = module.state_dict()
        if i == 0:
            for k, p32 in after32.items():
                p64 = got[k].numpy()
                assert np.abs(p32 - p64).max() <= 5e-3 * np.abs(p64).max(), k
        for k, want in jparams.items():
            np.testing.assert_allclose(got[k].numpy(), want, err_msg=k, **tol)
        got_v = _velocity(state.optimizer, module)
        assert got_v.keys() == jvelocity.keys()
        for k, want in jvelocity.items():
            np.testing.assert_allclose(got_v[k], want, err_msg=k, **tol)
    assert state.step == 2


@pytest.mark.parametrize("variant", ["canonical", "s2d", "pallas", "prestaged"])
def test_backward_through_every_stem(torch, port, variant):
    """backward() runs through every I3D of the port in train mode, and each
    stem's parameter gradients equal the canonical stem's on the same
    weights and clips, in float64 (rtol 1e-6, atol 1e-9): the s2d and
    prestaged stems are exact rewrites summed in another order, the kernel
    stem's gradient is the canonical conv's.  (In f32, train-mode
    BatchNorm over a few samples a channel and near-ties of the max pools
    amplify the rewrites' rounding to about 1e-3 of a gradient's scale.)"""
    i3d, common = port["i3d"], port["common"]
    kwargs = {"canonical": {}, "s2d": {"s2d_stem": True}, "pallas": {"stem_impl": "pallas"},
              "prestaged": {"stem_prestaged": True}}
    x = torch.from_numpy(np.random.default_rng(44).normal(0.0, 1.0, (2, 16, 32, 32, 3)))

    def grads(model, inputs):
        model.train()
        model(inputs).square().sum().backward()
        return {n: p.grad for n, p in model.named_parameters() if p.requires_grad}

    canonical = i3d.I3D(11, frames=16, generator=torch.Generator().manual_seed(5)).double()
    model = i3d.I3D(11, frames=16, **kwargs[variant]).double()
    model.load_state_dict(canonical.state_dict())
    got = grads(model, common.s2d_stem_stage(x) if variant == "prestaged" else x)
    want = grads(canonical, x)
    assert got.keys() == want.keys() and all(g is not None and torch.isfinite(g).all() for g in got.values())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-9, msg=k)


def test_trainable_bundle_keeps_f32_master_weights(torch, port):
    """build_model(trainable=True): every weight f32 (conv weights
    channels_last_3d), computing in bf16, in train mode; one bf16 train step
    on the CPU gives f32 gradients and a finite loss.  An inference bundle
    refuses train=True."""
    registry, train = port["registry"], port["train"]
    bundle = registry.build_model("I3D", dtype=torch.bfloat16, device="cpu", trainable=True,
                                  generator=torch.Generator().manual_seed(6))
    params = list(bundle.module.parameters())
    assert all(p.dtype == torch.float32 for p in params) and bundle.module.dtype == torch.bfloat16
    stem = bundle.module.trunk.Conv3d_1a_7x7.conv.weight
    assert stem.is_contiguous(memory_format=torch.channels_last_3d) and bundle.module.training
    tx = train.make_optimizer("I3D", 0.003)
    state = train.TrainState.create(bundle.module, tx)
    step = train.make_train_step(bundle, tx, (32, 32), augment=False, input_scale=1 / 255)
    rng = np.random.default_rng(45)
    batch = {"rgb": rng.integers(0, 256, (2, 20, 32, 32, 3), dtype=np.uint8), "label": np.array([1, 2]),
             "valid": np.array([True, True])}
    before = stem.detach().clone()
    state, m = step(state, batch, torch.ones(11))
    assert np.isfinite(float(m["loss"])) and not torch.equal(stem, before)
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in params)
    with pytest.raises(ValueError, match="the train state's optimizer"):
        step(train.TrainState.create(bundle.module, train.make_optimizer("I3D", 0.003)), batch, torch.ones(11))
    inference = registry.build_model("I3D", device="cpu")
    with pytest.raises(ValueError, match="trainable=True"):
        inference.apply(inference.dummy_batch(1), train=True)


# ----------------------------------------------------------------------
# Data, callbacks and the epoch loop
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,bs,seed,preshuffle,pad_to,freq,drop_last",
    [(10, 4, 0, None, None, 1, False), (10, 4, 3, 7, 16, 2, False), (7, 3, 1, 2, None, 1, True),
     (5, 8, 2, None, 9, 3, False)],
)
def test_resident_clips_batches_equal_jax(torch, port, n, bs, seed, preshuffle, pad_to, freq, drop_last):
    """ResidentClips on one device yields the JAX class's batches exactly
    (indices, valid, original ids) for the same (n, batch_size, seed,
    epoch, preshuffle, pad_to, augmentation_frequency, drop_last), and holds
    the same padded rows and labels."""
    from crowded_scenes_ensemble_classification_tpu.data.resident import ResidentClips as JResident

    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, 2, 3, 3, 3), dtype=np.uint8)
    labels = rng.integers(0, 11, n)
    kw = dict(seed=seed, augmentation_frequency=freq, drop_last=drop_last, preshuffle=preshuffle, pad_to=pad_to)
    ours = port["resident"].ResidentClips({"rgb": rgb}, labels, bs, device="cpu", **kw)
    ref = JResident({"rgb": rgb}, labels, bs, **kw)
    assert len(ours) == len(ref) and ours.nbytes == ref.nbytes
    np.testing.assert_array_equal(ours.resident["rgb"].numpy(), np.asarray(ref.resident["rgb"]))
    np.testing.assert_array_equal(ours.resident["label"].numpy(), np.asarray(ref.resident["label"]))
    np.testing.assert_array_equal(np.asarray(ours.df["class"]), ref.df["class"].values)
    for epoch in (0, 1):
        for a, b in zip(ours.epoch_local_indices(epoch), ref.epoch_local_indices(epoch), strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.batches(epoch), ref.batches(epoch), strict=True):
            for k in ("indices", "valid", "index"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype


def test_class_weights_balanced_equal_jax(port):
    from crowded_scenes_ensemble_classification_tpu.data.pipeline import class_weights_balanced

    ours = importlib.import_module(f"{PORT}.data.pipeline").class_weights_balanced
    labels = np.random.default_rng(7).integers(0, 9, 50)  # classes 9 and 10 absent
    np.testing.assert_array_equal(ours(labels, 11), class_weights_balanced(labels, 11))


@pytest.mark.parametrize("model_type", ["I3D", "C3D", "R3D_18"])
def test_callbacks_sequences_equal_jax(port, model_type):
    """LR and early-stop sequences of lr_policy_for(model_type) and
    EarlyStopping(patience 3) over a fixed val-loss series: exact."""
    from crowded_scenes_ensemble_classification_tpu.train import callbacks as jcb

    ours = importlib.import_module(f"{PORT}.train.callbacks")
    series = [2.0, 1.5, 1.6, 1.4, 1.4, 1.45, 1.39, 1.5, 1.6, 1.7, 1.2, 1.3]

    def run(cb):
        policy, early = cb.lr_policy_for(model_type), cb.EarlyStopping(patience=3)
        lr, out = policy.initial_lr, []
        for epoch, loss in enumerate(series):
            lr = policy.epoch_begin_lr(epoch, lr)
            lr_end = policy.epoch_end_lr(loss, lr)
            out.append((lr, lr_end, early.update(loss)))
            lr = lr_end
        return out

    assert run(ours) == run(jcb)


def _tiny_fit_setup(torch, port, seed=8):
    """A 16-frame I3D at 32² (weights from a fixed generator) as a trainable
    bundle, and resident train (4 clips) and val (3 clips) sets at 40²."""
    i3d, registry, config, resident = (port[k] for k in ("i3d", "registry", "config", "resident"))
    module = i3d.I3D(11, frames=16, generator=torch.Generator().manual_seed(seed))
    bundle = registry.ModelBundle("I3D", module, config.ClipSpec(16, 32, 32), 11, False, trainable=True)
    rng = np.random.default_rng(seed)
    clips = lambda n: {"rgb": rng.integers(0, 256, (n, 16, 40, 40, 3), dtype=np.uint8)}  # noqa: E731
    tr = resident.ResidentClips(clips(4), rng.integers(0, 11, 4), 2, seed=seed, device="cpu")
    va = resident.ResidentClips(clips(3), rng.integers(0, 11, 3), 2, shuffle=False, device="cpu")
    return bundle, tr, va


def test_fit_checkpoints_and_exact_resume(torch, port, tmp_path):
    """fit on resident sets, 2 epochs with augment and balanced classes:
    finite history; the best checkpoint holds the weights whose val loss is
    best_val_loss; save_best/restore_best round-trip; and a run stopped
    after epoch 0 (save_full_every=1) and resumed with resume_full ends with
    the same weights, BatchNorm statistics, velocities and history as an
    uninterrupted run (bit for bit: the augment draws follow (seed, step))."""
    train = port["train"]
    kw = dict(augment=True, balanced_classes=True, input_scale=1 / 255, seed=3)

    bundle, tr, va = _tiny_fit_setup(torch, port)
    whole = train.fit(bundle, tr, va, epochs=2, checkpoint_dir=str(tmp_path / "a"), **kw)
    hist = whole["history"]
    assert len(hist["val_loss"]) == 2 and np.isfinite(hist["loss"]).all() and whole["state"].step == 4
    best = train.restore_best(str(tmp_path / "a"))
    probe, _, _ = _tiny_fit_setup(torch, port, seed=9)
    probe.module.load_state_dict(best)
    val = train.evaluate_model(probe, va, (32, 32), input_scale=1 / 255)
    assert whole["best_val_loss"] == min(hist["val_loss"])
    np.testing.assert_allclose(val["loss"], whole["best_val_loss"], rtol=1e-6)
    train.save_best(str(tmp_path / "b"), bundle.module.state_dict())
    back = train.restore_best(str(tmp_path / "b"))
    assert all(torch.equal(back[k], v) for k, v in bundle.module.state_dict().items())

    first, tr1, va1 = _tiny_fit_setup(torch, port)
    train.fit(first, tr1, va1, epochs=1, checkpoint_dir=str(tmp_path / "c"), save_full_every=1, **kw)
    assert train.full_exists(str(tmp_path / "c"))
    resumed, tr2, va2 = _tiny_fit_setup(torch, port)
    out = train.fit(resumed, tr2, va2, epochs=2, checkpoint_dir=str(tmp_path / "c"), resume_full=True, **kw)
    assert out["history"] == hist and out["state"].step == 4
    sd, ref = resumed.module.state_dict(), bundle.module.state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in ref)
    v_res, v_ref = _velocity(out["state"].optimizer, resumed.module), _velocity(whole["state"].optimizer, bundle.module)
    assert all(np.array_equal(v_res[k], v_ref[k]) for k in v_ref)


def _tiny_two_stream(torch, port):
    """A trainable TwoStream-I3D for 16-frame 32² clips, weights from a fixed
    generator, with its optimizer."""
    registry, config, train = port["registry"], port["config"], port["train"]
    module = importlib.import_module(f"{PORT}.models.two_stream_i3d").TwoStreamI3D(
        11, frames=16, generator=torch.Generator().manual_seed(10))
    bundle = registry.ModelBundle("TWOSTREAM_I3D", module.train(), config.ClipSpec(16, 32, 32), 11, True,
                                  trainable=True)
    return bundle, train.make_optimizer("TWOSTREAM_I3D", 0.003)


def test_flow_inputs_are_not_ported(torch, port):
    """Flow inputs train: a TwoStream step on a precomputed-flow batch gives
    a finite loss and moves both trunks' weights; a single-stream I3D
    ignores a flow it is given, as the JAX preprocessing does."""
    train = port["train"]
    bundle, tx = _tiny_two_stream(torch, port)
    step = train.make_train_step(bundle, tx, (32, 32), augment=False, input_scale=1 / 255)
    rng = np.random.default_rng(11)
    batch = {"rgb": rng.integers(0, 256, (2, 16, 32, 32, 3), dtype=np.uint8),
             "flow": rng.integers(0, 256, (2, 16, 32, 32, 2), dtype=np.uint8),
             "label": np.array([1, 4], np.int32), "valid": np.ones(2, bool)}
    stems = [bundle.module.rgb_trunk.Conv3d_1a_7x7.conv.weight, bundle.module.flow_trunk.Conv3d_1a_7x7.conv.weight]
    before = [w.detach().clone() for w in stems]
    _, m = step(train.TrainState.create(bundle.module, tx), batch, torch.ones(11))
    assert np.isfinite(float(m["loss"])) and not any(torch.equal(w, b) for w, b in zip(stems, before))

    i3d, _, _ = _tiny_fit_setup(torch, port)
    i3d_tx = train.make_optimizer("I3D", 0.003)
    i3d_step = train.make_train_step(i3d, i3d_tx, (32, 32), augment=False)
    _, with_flow = i3d_step(train.TrainState.create(i3d.module, i3d_tx), batch, torch.ones(11))
    assert np.isfinite(float(with_flow["loss"]))


def test_two_stream_batch_without_flow_raises(torch, port):
    """A two-stream batch with neither precomputed flow nor gray pairs
    raises, in the train and the eval step; gray pairs staged otherwise
    than the rgb cannot take its augment decisions."""
    train = port["train"]
    bundle, tx = _tiny_two_stream(torch, port)
    rgb_only = {"rgb": np.zeros((2, 16, 32, 32, 3), np.uint8), "label": np.zeros(2, np.int32),
                "valid": np.ones(2, bool)}
    step = train.make_train_step(bundle, tx, (32, 32), augment=False)
    with pytest.raises(ValueError, match="gray pairs"):
        step(train.TrainState.create(bundle.module, tx), rgb_only, torch.ones(11))
    with pytest.raises(ValueError, match="gray pairs"):
        train.make_eval_step(bundle, (32, 32))(rgb_only)
    small = dict(rgb_only, **{k: np.zeros((2, 16, 24, 24, 1), np.uint8) for k in ("gray", "gray_next")})
    augmented = train.make_train_step(bundle, tx, (32, 32), augment=True, flow_from_augmented=True)
    with pytest.raises(ValueError, match="staged as the rgb"):
        augmented(train.TrainState.create(bundle.module, tx), small, torch.ones(11))
