"""The fused block-input 1³ convs (`fuse_1x1`) of the PyTorch port, on the CPU.

Held against the JAX package at its own test shapes, `INCEPTION_SPECS
["Mixed_3b"]` on (1, 4, 8, 8, 192) (JAX tests/test_quant.py:300-330,
tests/test_models.py:241-300), on numpy-seeded flax variables converted by
`models/convert.py`:

- the fused f32 block against JAX's fused and unfused blocks, in eval
  (atol 1e-5: the same 1³ sums of 192 products in another order) and train
  mode (outputs and updated batch statistics within 1e-4 of each value or
  of its tensor's largest element, as tests/test_torch_train.py holds the
  unfused block);
- static int8: calibrating through a fused calib block records the unfused
  block's stats bit for bit and JAX's within 1e-5 relative (the existing
  calibration tolerance, tests/test_torch_quant.py); on JAX's baked
  variables the fused static block equals the port's unfused static block
  bit for bit, and both are within 1e-5 of JAX's fused static block (f32
  BatchNorm rounded apart after the exact int8 convs);
- the concatenated packed weights: `pack_int8_weights` of the concatenated
  k8, refreshed after `load_state_dict` of changed branch weights;
- the lean form: a fused static member run as a meta template on its
  stacked state (`stacked_member_softmax`) equals its eager forward;
- whole models on the meta device: fused and unfused I3D and TwoStream state
  dicts have the same keys and shapes;
- `s2d_stem_conv_wfold` / `s2d_stem_conv_hwfold` against JAX's (atol 1e-4:
  sums of 1,029 products).

torch and the port are imported by fixtures (tests/torch_port_memory.py).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.models import common as jcommon
from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
from crowded_scenes_ensemble_classification_tpu.models import quantize as jquant
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
SPEC = ji3d.INCEPTION_SPECS["Mixed_3b"]
SHAPE = (1, 4, 8, 8, 192)
F32_ATOL = 1e-5


@pytest.fixture(scope="module")
def port(torch):
    names = ("models.common", "models.i3d", "models.two_stream_i3d", "models.quantize", "models.convert",
             "ensemble.members", "ops.kernels.int8_conv")
    return {n.split(".")[-1]: importlib.import_module(f"{PORT}.{n}") for n in names}


def flax_variables(module, seed, shape=SHAPE):
    """numpy-seeded params and batch stats of a flax module's tree."""
    shapes = jax.eval_shape(lambda x: module.init(jax.random.key(0), x, train=False),
                            jax.ShapeDtypeStruct(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(math.prod(s.shape[:-1])), s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, s.shape)
        elif name == "var":
            v = rng.uniform(0.3, 0.7, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, {k: v for k, v in shapes.items() if k in ("params", "batch_stats")})


def block_input(seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=SHAPE) * scale).astype(np.float32)


def port_block(port, variables, **kw):
    block = port["i3d"].InceptionBlock(SHAPE[-1], SPEC, **kw)
    block.load_state_dict(port["convert"].i3d_state_dict_from_flax(variables))
    return block


def run(port, block, x):
    c = port["common"]
    return c.to_nthwc(block(c.to_ncdhw(torch_from(x)))).detach().numpy()


def torch_from(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def close_to_scale(got, want, what, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_float_block_matches_flax(torch, port, train):
    """The fused f32 block against JAX's fused block and its unfused one;
    in train mode the updated batch statistics too."""
    v = flax_variables(ji3d.InceptionBlock(SPEC), 1)
    x = block_input(2)
    block = port_block(port, v, fuse_1x1=True).train(train)
    got = run(port, block, x)
    for fuse in (True, False):
        jmod = ji3d.InceptionBlock(SPEC, fuse_1x1=fuse)
        if not train:
            want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(v, x)
            np.testing.assert_allclose(got, np.asarray(want), rtol=F32_ATOL, atol=F32_ATOL, err_msg=f"fuse_1x1={fuse}")
            continue
        y, new = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
        close_to_scale(got, np.asarray(y), f"output, fuse_1x1={fuse}")
        want = port["convert"].i3d_state_dict_from_flax({"params": v["params"], "batch_stats": new["batch_stats"]})
        state = block.state_dict()
        for k in (k for k in want if k.endswith(("running_mean", "running_var"))):
            close_to_scale(state[k].numpy(), want[k].numpy(), f"{k}, fuse_1x1={fuse}")


def _bake(variables):
    """JAX's `quantize_variables` in one jitted call with XLA's algebraic
    simplifier off (tests/test_torch_quant.py `bake`: jitted, XLA multiplies
    by the reciprocal of 127 where the eager call and the port divide)."""
    fn = jax.jit(jquant.quantize_variables).lower(variables).compile({"xla_disable_hlo_passes": "algsimp"})
    return jax.tree_util.tree_map(np.asarray, fn(variables))


@pytest.fixture(scope="module")
def jax_static(port):
    """JAX's Mixed_3b calibrated on one input and baked, with its fused and
    unfused static outputs on another."""
    v = flax_variables(ji3d.InceptionBlock(SPEC), 3)
    x_cal, x_eval = block_input(4, 3.0), block_input(5, 3.0)
    calib = ji3d.InceptionBlock(SPEC, quant="calib")
    _, stats = jax.jit(lambda v, x: calib.apply(v, x, train=False, mutable=["qstats"]))(v, x_cal)
    baked = _bake({**v, **stats})
    outs = {fuse: np.asarray(jax.jit(lambda b, x, f=fuse: ji3d.InceptionBlock(SPEC, quant="static", fuse_1x1=f)
                                     .apply(b, x, train=False))(baked, x_eval)) for fuse in (True, False)}
    return dict(variables=v, x_cal=x_cal, x_eval=x_eval, baked=baked, outs=outs)


def test_fused_calib_records_the_unfused_stats(torch, port, jax_static):
    """'calib' runs unfused (JAX i3d.py:152-155): a fused calib block
    records the unfused one's act_absmax at every site bit for bit, and
    JAX's within 1e-5 relative."""
    q = port["quantize"]
    blocks = {fuse: port_block(port, jax_static["variables"], quant="calib", fuse_1x1=fuse).eval()
              for fuse in (True, False)}
    for block in blocks.values():
        q.calibrate(block, [torch_from(jax_static["x_cal"]).permute(0, 4, 1, 2, 3)])
    fused, plain = (q.calibration_summary(blocks[f]) for f in (True, False))
    assert fused == plain and len(fused) == 6
    want = {k.replace("/", "."): v for k, v in jquant.calibration_summary(jax_static["baked"]).items()}
    assert set(want) == set(fused)
    np.testing.assert_allclose([fused[k] for k in want], list(want.values()), rtol=1e-5)


def test_fused_static_block_is_the_unfused_block(torch, port, jax_static):
    """On JAX's baked variables the fused static block equals the port's
    unfused static block bit for bit (plain int8 conv on the CPU); each is
    within 1e-5 of JAX's block of its form, and JAX's two forms are equal."""
    np.testing.assert_array_equal(jax_static["outs"][True], jax_static["outs"][False])
    got = {}
    for fuse in (True, False):
        block = port_block(port, jax_static["baked"], quant="static", fuse_1x1=fuse).eval()
        with torch.inference_mode():
            got[fuse] = run(port, block, jax_static["x_eval"])
        np.testing.assert_allclose(got[fuse], jax_static["outs"][fuse], rtol=F32_ATOL, atol=F32_ATOL)
    np.testing.assert_array_equal(got[True], got[False])


def test_fused_packed_weights_follow_the_branch_state(torch, port, jax_static):
    """The fused block holds `pack_int8_weights` of the concatenated k8 (not
    the three packed buffers, each padded apart), under the max act_absmax;
    after `load_state_dict` of a changed branch k8 it holds the new one and
    its forward equals the unfused block's on the same state."""
    ic = port["int8_conv"]
    block = port_block(port, jax_static["baked"], quant="static", fuse_1x1=True).eval()
    x = torch_from(jax_static["x_eval"]).permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        block(x)
    state = block.state_dict()
    k8 = [state[f"{b}.conv.k8"] for b in ("b0_1x1", "b1_1x1", "b2_1x1")]
    assert torch.equal(block.static_wp, ic.pack_int8_weights(torch.cat(k8)))
    assert block.static_wp.shape[0] == ic.F_TILE * -(-sum(t.shape[0] for t in k8) // ic.F_TILE)
    changed = dict(state)
    changed["b1_1x1.conv.k8"] = torch.flip(state["b1_1x1.conv.k8"], dims=(1,))
    block.load_state_dict(changed)
    k8[1] = changed["b1_1x1.conv.k8"]
    assert torch.equal(block.static_wp, ic.pack_int8_weights(torch.cat(k8)))
    plain = port["i3d"].InceptionBlock(SHAPE[-1], SPEC, quant="static").eval()
    plain.load_state_dict(changed)
    with torch.inference_mode():
        assert torch.equal(block(x), plain(x))


def test_lean_fused_static_member_equals_eager(torch, port):
    """A fused static I3D member (calibrated and baked in the port, f32,
    16×32²) run as a meta-device template on its stacked state dict — the
    lean serving program's form, which computes the fused operands in the
    call — equals its eager forward, which holds them."""
    members, q = port["members"], port["quantize"]
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 255, (2, 16, 32, 32, 3)).astype(np.float32))
    module = port["i3d"].I3D(5, frames=16, stem_prestaged=True, quant="calib", fuse_1x1=True,
                             generator=torch.Generator().manual_seed(7)).eval()
    q.calibrate(module, [port["common"].s2d_stem_stage(x)])
    q.set_quant_mode(q.quantize_variables(module), "static")
    assert module.trunk.Mixed_4f.static_wp is not None
    template = port["i3d"].I3D(5, frames=16, stem_prestaged=True, quant="static", fuse_1x1=True).to("meta").eval()
    for m in q.static_holders(template):
        m.refresh_static_operands()
    batch = {"rgb": x}
    with torch.inference_mode():
        eager = members.member_softmax([module], batch, (32, 32), share_stem_staging=True)
        lean = members.stacked_member_softmax(template, members.stack_variables([module.state_dict()]), batch,
                                              (32, 32), share_stem_staging=True)
    assert torch.equal(lean, eager)


@pytest.mark.parametrize("quant", [False, "static"], ids=["float", "static"])
@pytest.mark.parametrize("model", ["I3D", "TwoStreamI3D"])
def test_fused_models_keep_the_state_dict(torch, port, model, quant):
    """Fused and unfused I3D and TwoStream (full width, on the meta device)
    have the same state-dict keys, in order, and shapes."""
    cls = getattr(port["i3d"] if model == "I3D" else port["two_stream_i3d"], model)
    with torch.device("meta"):
        a, b = (cls(11, frames=20, quant=quant, fuse_1x1=f).state_dict() for f in (False, True))
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)


@pytest.mark.parametrize("form", ["wfold", "hwfold"])
def test_folded_s2d_stems_match_jax(torch, port, form):
    """`s2d_stem_conv_wfold` / `_hwfold` against JAX's on the same clips and
    canonical kernel (and against the unfolded s2d stem)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 10, 12, 3)).astype(np.float32)
    kernel = rng.normal(0.0, 0.05, (7, 7, 7, 3, 8)).astype(np.float32)  # DHWIO
    want = np.asarray(getattr(jcommon, f"s2d_stem_conv_{form}")(jnp.asarray(x), jnp.asarray(kernel)))
    c = port["common"]
    w = torch_from(kernel.transpose(4, 3, 0, 1, 2))
    got = getattr(c, f"s2d_stem_conv_{form}")(torch_from(x), w).numpy()
    assert got.shape == want.shape == (2, 3, 5, 6, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, c.s2d_stem_conv(torch_from(x), w).numpy(), rtol=1e-4, atol=1e-4)


def test_fused_members_with_a_block_policy_over_a_mesh(torch, port):
    """Static members under quant_blocks='mixed' (int8 at the stem convs and
    Mixed_4f/5b/5c, the other blocks fused in f32), calibrated and baked
    unfused, then loaded into fused twins: `member_probabilities` of the
    twins over a (member 2, data 2) CPU mesh equals the unfused members'
    unsharded one within 1e-5 (the f32 fused blocks sum in another order;
    the int8 ones are exact)."""
    members, q, i3d = port["members"], port["quantize"], port["i3d"]
    mesh = importlib.import_module(f"{PORT}.core.mesh").make_mesh((("member", 2), ("data", 2)),
                                                                   [torch.device("cpu")] * 4)
    rng = np.random.default_rng(9)
    batches = [{"rgb": rng.integers(0, 256, (4, 16, 32, 32, 3), dtype=np.uint8)}]
    kw = dict(frames=16, stem_prestaged=True, quant_blocks="mixed")
    plain = [i3d.I3D(5, quant="calib", generator=torch.Generator().manual_seed(s), **kw).eval() for s in (10, 11)]
    plain = members.calibrate_members(plain, batches, (32, 32), num_batches=1)
    fused = []
    for m in plain:
        twin = i3d.I3D(5, quant="static", fuse_1x1=True, **kw).eval()
        twin.load_state_dict(m.state_dict())
        assert twin.trunk.Mixed_5c.static_wp is not None and not twin.trunk.Mixed_3b.quant
        fused.append(twin)
    want = members.member_probabilities(plain, batches, (32, 32))
    got = members.member_probabilities(fused, batches, (32, 32), mesh=mesh)
    assert got.shape == want.shape == (2, 4, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
