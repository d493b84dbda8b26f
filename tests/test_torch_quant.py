"""Parity of the PyTorch port's int8 inference with the JAX package, on the CPU.

The port's int8 conv and quantize pass run their plain versions here (the
exact float64 integer conv and the same f32 arithmetic), the JAX side its
XLA ops; inputs and variables are drawn with numpy from seeds and fed to
both.  What is held, and how tightly:

- op level (`quant_conv_general`, `static_quant_conv_general`,
  `weight_qparams`), SAME / VALID / explicit pads, strides 1 and 2, Cin 3,
  12 and 24: bit for bit;
- the plain int8 conv against an int64 numpy oracle: exactly;
- `QuantConv` in its three modes and the prestaged s2d stem, f32: the
  int8 paths bit for bit, the exact f32 conv of 'calib' within 1e-5 (XLA
  and torch sum in other orders); `ConvBN(quant)` in bf16 within one bf16
  step (flax's and torch's BatchNorm round their f32 arithmetic apart);
- calibration: the same `calibration_summary` sites, scales within 1e-5
  relative, `k8` equal and `sw` bit for bit;
- whole static-int8 models on JAX's calibrated variables carried across:
  probabilities within 1e-3 and top-1 equal.  Measured: I3D 8.9e-8, C3D
  7.5e-9, R3D-18 6.0e-8, TwoStream 2.4e-7, the calibrated members 1.0e-7.
  What differs is f32 rounding outside the int8 convs (BatchNorm, the
  averaging head, and the scales: jitted, XLA multiplies by the f32
  reciprocal of 127 where the port divides), which rarely moves a code.

Each JAX model is compiled once, with XLA's default optimization (at
level 0 the static int8 I3D runs 13 times slower than it compiles faster),
and JAX's weight baking runs as one jitted call (eagerly it compiles each
op for each kernel shape) with the arithmetic of its eager call (`bake`).  torch and the port are imported by fixtures,
not at collection (tests/torch_port_memory.py).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec
from crowded_scenes_ensemble_classification_tpu.ensemble import members as jmembers
from crowded_scenes_ensemble_classification_tpu.models import build_model as jbuild
from crowded_scenes_ensemble_classification_tpu.models import common as jcommon
from crowded_scenes_ensemble_classification_tpu.models import quantize as jquant
from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JBundle
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES = 11
WHOLE_MODEL_PROB_TOL = 1e-3
_JAX_QUANTIZE_VARIABLES = jquant.quantize_variables


@pytest.fixture(scope="module")
def port(torch):
    names = ("models.common", "models.quantize", "models.convert", "models.i3d", "models.c3d", "models.r3d",
             "models.two_stream_i3d", "models.registry", "ensemble.members", "ops.kernels.int8_conv")
    return {n.split(".")[-1]: importlib.import_module(f"{PORT}.{n}") for n in names}


def fill(shapes, seed):
    """numpy-seeded variables of a flax shape tree: lecun-scaled kernels, BN
    statistics away from (0, 1) so every layer matters."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(math.prod(s.shape[:-1])), s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, s.shape)
        elif name == "var":
            v = rng.uniform(0.3, 0.7, s.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def plain_variables(module, seed, *x_shapes):
    """numpy-filled params and batch stats of `module` (no quant state)."""
    shapes = jax.eval_shape(lambda *xs: module.init(jax.random.key(0), *xs, train=False),
                            *[jax.ShapeDtypeStruct(s, jnp.float32) for s in x_shapes])
    return fill({k: v for k, v in shapes.items() if k in ("params", "batch_stats")}, seed)


def compiled(fn, *args):
    """jit(fn) compiled for these arguments."""
    return jax.jit(fn).lower(*args).compile()


def bake(variables):
    """JAX's `quantize_variables` as one jitted call with XLA's algebraic
    simplifier off, in numpy: jitted, XLA turns its `/ 127.0` into a
    multiply by the f32 reciprocal of 127, which its eager call (how JAX's
    `calibrate_members` bakes) and the port do not."""
    fn = jax.jit(_JAX_QUANTIZE_VARIABLES).lower(variables).compile({"xla_disable_hlo_passes": "algsimp"})
    return numpy_tree(fn(variables))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_numpy(t):
    return t.detach().float().cpu().numpy()


# ----------------------------------------------------------------------
# Op level
# ----------------------------------------------------------------------

# (x NTHWC, F, kernel, strides, padding)
OP_CASES = [
    ((2, 5, 9, 9, 3), 8, (3, 3, 3), (1, 1, 1), "SAME"),
    ((1, 7, 10, 10, 3), 8, (7, 7, 7), (2, 2, 2), "SAME"),
    ((2, 6, 9, 9, 12), 16, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((2, 5, 9, 9, 24), 16, (3, 3, 3), (2, 2, 2), "SAME"),
    ((2, 6, 8, 8, 24), 8, (1, 1, 1), (2, 2, 2), "VALID"),
    ((2, 4, 6, 6, 12), 12, (3, 3, 3), (1, 1, 1), "VALID"),
]
OP_IDS = [f"C{c[0][-1]}-k{c[2][0]}{c[2][1]}{c[2][2]}-s{c[3][0]}-{c[4] if isinstance(c[4], str) else 'explicit'}"
          for c in OP_CASES]


def _op_inputs(case, seed):
    shape, f, kernel, _, _ = case
    rng = np.random.default_rng(seed)
    x = (rng.normal(0.0, 1.0, shape) * 3.0).astype(np.float32)
    w = rng.normal(0.0, 0.2, (*kernel, shape[-1], f)).astype(np.float32)  # DHWIO
    return x, w


def _oidhw(w):
    return np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("case", OP_CASES, ids=OP_IDS)
def test_plain_int8_conv_is_the_exact_integer_conv(torch, port, case):
    """The plain int8 conv against an int64 numpy oracle, exactly: with unit
    scales its f32 output is the integer sum itself (|sum| < 2^24 here)."""
    shape, f, kernel, strides, padding = case
    rng = np.random.default_rng(7)
    x8 = rng.integers(-127, 128, shape).astype(np.int8)
    k8 = rng.integers(-127, 128, (*kernel, shape[-1], f)).astype(np.int8)
    pads = port["common"].conv_pads(shape[1:4], kernel, strides, padding)
    got = port["int8_conv"].int8_conv3d_reference(
        torch.from_numpy(x8), torch.from_numpy(_oidhw(k8)), torch.ones(f), None, strides, pads).numpy()

    xp = np.pad(x8.astype(np.int64), ((0, 0), *pads, (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(xp, kernel, axis=(1, 2, 3))
    win = win[:, ::strides[0], ::strides[1], ::strides[2]]
    want = np.einsum("ndhwcijk,ijkcf->ndhwf", win, k8.astype(np.int64), optimize=True)
    assert np.abs(want).max() < 2 ** 24
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("case", OP_CASES, ids=OP_IDS)
def test_quant_ops_equal_jax(torch, port, case):
    """`weight_qparams`, `quant_conv_general` (dynamic: a division by sx)
    and `static_quant_conv_general` (a multiply by inv, codes saturating
    past the calibrated 0.8·max|x|, and uncalibrated act_scale 0) equal
    JAX's bit for bit."""
    shape, f, kernel, strides, padding = case
    x, w = _op_inputs(case, 11)
    c = port["common"]
    jpad = padding if isinstance(padding, str) else list(padding)

    k8, sw = c.weight_qparams(torch.from_numpy(_oidhw(w)))
    jk8, jsw = jcommon.weight_qparams(jnp.asarray(w))
    np.testing.assert_array_equal(k8.numpy(), _oidhw(np.asarray(jk8)))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))

    got = c.quant_conv_general(torch.from_numpy(x), torch.from_numpy(_oidhw(w)), strides, padding)
    want = jcommon.quant_conv_general(jnp.asarray(x), jnp.asarray(w), strides, jpad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for act in (np.float32(0.8 * np.abs(x).max() / 127.0), np.float32(0.0)):
        got = c.static_quant_conv_general(torch.from_numpy(x), k8, sw, torch.tensor(act), strides, padding)
        want = jcommon.static_quant_conv_general(jnp.asarray(x), jk8, jsw, jnp.asarray(act), strides, jpad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------


def _quant_conv_pair(port, mode, case, seed):
    """A flax QuantConv and the port's, on the same numpy variables (bias
    included), the qstats recorded by JAX's 'calib' on the input and, for
    'static', JAX's baked qparams."""
    import torch

    shape, f, kernel, strides, padding = case
    x, w = _op_inputs(case, seed)
    jpad = padding if isinstance(padding, str) else list(padding)
    bias = np.random.default_rng(seed + 1).normal(0.0, 0.5, f).astype(np.float32)
    variables = {"params": {"kernel": w, "bias": bias}}
    calib = jcommon.QuantConv(f, kernel, strides, jpad, mode="calib")
    _, stats = calib.apply(variables, jnp.asarray(x), mutable=["qstats"])
    variables = {**variables, **numpy_tree(stats)}
    if mode == "static":
        variables = bake(variables)
    jmod = jcommon.QuantConv(f, kernel, strides, jpad, mode=mode)
    tmod = port["common"].QuantConv(shape[-1], f, kernel, strides, padding, mode=mode)
    sd = {"weight": torch.from_numpy(_oidhw(w)), "bias": torch.from_numpy(bias)}
    if mode != "dynamic":
        sd["act_absmax"] = torch.tensor(variables["qstats"]["act_absmax"])
    if mode == "static":
        sd["k8"] = torch.from_numpy(_oidhw(variables["qparams"]["k8"]))
        sd["sw"] = torch.from_numpy(variables["qparams"]["sw"])
    tmod.load_state_dict(sd)
    return x, variables, jmod, tmod


@pytest.mark.parametrize("mode", ["dynamic", "calib", "static"])
@pytest.mark.parametrize("case", [OP_CASES[0], OP_CASES[2], OP_CASES[3]], ids=[OP_IDS[0], OP_IDS[2], OP_IDS[3]])
def test_quant_conv_module_matches_flax(torch, port, mode, case):
    """QuantConv with a bias: 'dynamic' and 'static' (JAX's baked k8/sw
    loaded into the port's buffers) bit for bit; 'calib' records the same
    max|x| exactly and its exact f32 conv agrees within 1e-5 of the
    output's largest magnitude (sums of up to 1,344 terms in other orders)."""
    x, variables, jmod, tmod = _quant_conv_pair(port, mode, case, 3)
    c = port["common"]
    if mode == "calib":
        want, stats = jmod.apply(variables, jnp.asarray(x), mutable=["qstats"])
        tmod.act_absmax.zero_()
        with torch.inference_mode():
            got = c.to_nthwc(tmod(c.to_ncdhw(torch.from_numpy(x))))
        assert float(tmod.act_absmax) == float(stats["qstats"]["act_absmax"])
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        return
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = c.to_nthwc(tmod(c.to_ncdhw(torch.from_numpy(x))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bf16_step_close(got, want):
    """Within one bf16 step (2^-7 of the larger magnitude, or 1e-6 near 0)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    step = np.maximum(np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7, 1e-6)
    assert (np.abs(got - want) <= step).all(), np.abs(got - want).max()


@pytest.mark.parametrize("mode", ["dynamic", "calib", "static"])
def test_convbn_quant_bf16_matches_flax(torch, port, mode):
    """ConvBN(quant) with dtype bf16 on bf16 input: the f32 conv output goes
    through the BatchNorm in f32 and is cast after, on both sides."""
    shape, f, kernel = (2, 5, 9, 9, 24), 32, (3, 3, 3)
    x = jnp.asarray(np.random.default_rng(5).normal(0.0, 2.0, shape).astype(np.float32)).astype(jnp.bfloat16)
    calib = jcommon.ConvBN(f, kernel, dtype=jnp.bfloat16, quant="calib")
    variables = plain_variables(calib, 6, shape)
    _, stats = calib.apply(variables, x, mutable=["qstats"])
    variables = numpy_tree({**variables, **stats})
    if mode == "static":
        variables = bake(variables)
    jmod = jcommon.ConvBN(f, kernel, dtype=jnp.bfloat16, quant=mode if mode != "dynamic" else True)
    want = np.asarray(jmod.apply(variables, x, mutable=["qstats"])[0] if mode == "calib" else
                      jmod.apply(variables, x)).astype(np.float32)
    c = port["common"]
    tmod = c.ConvBN(shape[-1], f, kernel, quant=mode).eval()
    sd = port["convert"].state_dict_from_flax("I3D", variables if mode != "dynamic" else
                                              {k: v for k, v in variables.items() if k != "qstats"})
    tmod.load_state_dict(sd)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    with torch.inference_mode():
        got = c.to_nthwc(tmod(c.to_ncdhw(xt)))
    assert got.dtype == torch.bfloat16
    _bf16_step_close(to_numpy(got), want)


@pytest.mark.parametrize("mode", ["dynamic", "calib", "static"])
def test_prestaged_stem_quant_matches_flax(torch, port, mode):
    """The prestaged s2d stem quantizes its DERIVED kernel in 'dynamic' and
    'static' and records max|xs| in 'calib' at its own scope; f32, BN
    rounding apart (1e-5)."""
    x = np.random.default_rng(8).uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    xs = np.asarray(jcommon.s2d_stem_stage(jnp.asarray(x)))
    calib = jcommon.PrestagedS2DStemConvBN(64, quant="calib")
    variables = plain_variables(calib, 9, xs.shape)
    _, stats = calib.apply(variables, jnp.asarray(xs), mutable=["qstats"])
    variables = numpy_tree({**variables, **stats})
    jmod = jcommon.PrestagedS2DStemConvBN(64, quant=mode if mode != "dynamic" else True)
    want = np.asarray(jmod.apply(variables, jnp.asarray(xs), mutable=["qstats"])[0] if mode == "calib" else
                      jmod.apply(variables, jnp.asarray(xs)))
    c = port["common"]
    tmod = c.PrestagedS2DStemConvBN(3, 64, quant=mode).eval()
    sd = port["convert"].state_dict_from_flax("I3D", variables if mode != "dynamic" else
                                              {k: v for k, v in variables.items() if k != "qstats"})
    tmod.load_state_dict(sd)
    if mode == "calib":
        tmod.act_absmax.zero_()
    with torch.inference_mode():
        got = c.to_nthwc(tmod(torch.from_numpy(xs)))
    if mode != "dynamic":
        assert float(tmod.act_absmax) == float(variables["qstats"]["act_absmax"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("site", ["quant_conv", "prestaged_stem"])
def test_static_sites_trace_as_pure_functions(torch, port, site):
    """A static site (a baked QuantConv, the prestaged stem) holds its packed
    weights and scales as non-persistent buffers: its state dict has none of
    them, and `torch.export` and `torch.compile` (fullgraph) trace it into
    graphs that call the int8 ops on those constants and equal eager bit for
    bit.  An in-place edit of a source (k8, act_absmax, the weight) is seen
    by the next eager call, which equals the uncached computation."""
    c, q = port["common"], port["quantize"]
    gen = torch.Generator().manual_seed(31)
    if site == "quant_conv":
        mod = c.QuantConv(12, 8, (3, 3, 3), mode="calib", generator=gen).eval()
        x = torch.randn(2, 12, 4, 9, 9, generator=gen)  # NCDHW
    else:
        mod = c.PrestagedS2DStemConvBN(3, 16, generator=gen, quant="calib").eval()
        x = c.s2d_stem_stage(torch.rand(2, 8, 16, 16, 3, generator=gen))  # NTHWC staging
    keys = set(q.calibrate(mod, [x]).state_dict()) | ({"k8", "sw"} if site == "quant_conv" else set())
    q.set_quant_mode(q.quantize_variables(mod), "static")
    assert set(mod.state_dict()) == keys and mod.static_wp is not None
    with torch.no_grad():
        eager = mod(x)
        exported = torch.export.export(mod, (x,), strict=False)
        ops = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
        assert {"csec.int8_conv3d.default", "csec.quantize_int8.default"} <= ops
        assert torch.equal(exported.module()(x), eager)
        torch._dynamo.reset()
        assert torch.equal(torch.compile(mod, backend="aot_eager", fullgraph=True)(x), eager)

        if site == "quant_conv":
            mod.k8.mul_(-1)
            mod.act_absmax.mul_(0.5)
            fresh = c.to_ncdhw(c.static_quant_conv_general(
                c.to_nthwc(x), mod.k8, mod.sw, mod.act_absmax / 127.0, (1, 1, 1), "SAME", mod.bias))
        else:
            mod.conv.weight.mul_(-0.5)
            k8, sw = c.weight_qparams(c.s2d_stem_kernel(mod.conv.weight.float()))
            conv = c.static_quant_conv_general(x, k8, sw, mod.act_absmax / 127.0, (2, 1, 1),
                                               ((2, 3), (0, 0), (0, 0)))
            fresh = torch.relu(mod.bn(c.to_ncdhw(conv)).to(x.dtype))
        edited = mod(x)
        assert not torch.equal(edited, eager) and torch.equal(edited, fresh)


# ----------------------------------------------------------------------
# Calibration and whole models, on JAX's calibrated variables
# ----------------------------------------------------------------------


def _i3d_input(seed, batch=2):
    x = np.random.default_rng(seed).uniform(0.0, 1.0, (batch, 16, 32, 32, 3)).astype(np.float32)
    return np.asarray(jcommon.s2d_stem_stage(jnp.asarray(x)))


def _flax_static(jmodule_calib, jmodule_static, variables, calib_args, eval_args):
    """JAX: calibrate on `calib_args` (one jitted apply), bake, then the
    static forward's probabilities on `eval_args`; returns (baked
    variables, probabilities)."""
    step = compiled(lambda v, *a: jmodule_calib.apply(v, *a, train=False, mutable=["qstats"])[1],
                    variables, *calib_args)
    baked = bake({**variables, **step(variables, *calib_args)})
    fwd = compiled(lambda v, *a: jax.nn.softmax(jmodule_static.apply(v, *a, train=False)), baked, *eval_args)
    return baked, fwd


@pytest.fixture(scope="module")
def i3d_static(port):
    """A prestaged I3D (f32) calibrated in JAX on one batch and baked, with
    its static probabilities on another batch."""
    xs_cal, xs_eval = _i3d_input(21), _i3d_input(22)
    kw = dict(num_classes=CLASSES, stem_prestaged=True)
    calib, static = jbuild("I3D", quant="calib", **kw).module, jbuild("I3D", quant="static", **kw).module
    variables = plain_variables(calib, 23, xs_cal.shape)
    baked, fwd = _flax_static(calib, static, variables, (xs_cal,), (xs_eval,))
    return dict(variables=variables, baked=baked, probs=np.asarray(fwd(baked, xs_eval)), fwd=fwd, xs_cal=xs_cal,
                xs_eval=xs_eval)


def _port_model(port, make, model_type, variables):
    """The port's module `make()` on converted flax variables, in eval mode.
    Built on the meta device where the variables fill every tensor (a baked
    tree); a plain tree leaves a quant model's act_absmax to its init."""
    import torch

    full = "qstats" in variables
    with torch.device("meta" if full else "cpu"):
        module = make()
    module.load_state_dict(port["convert"].state_dict_from_flax(model_type, variables), strict=True, assign=full)
    return module.eval()


def test_calibration_matches_jax(torch, port, i3d_static):
    """`calibrate` + `quantize_variables` on the plain variables: the same
    sites as JAX's qstats through the converter's names, scales within 1e-5
    relative, k8 equal and sw bit for bit."""
    q = port["quantize"]
    module = _port_model(port, lambda: port["i3d"].I3D(CLASSES, frames=16, stem_prestaged=True, quant="calib"),
                         "I3D", i3d_static["variables"])
    q.quantize_variables(q.calibrate(module, [torch.from_numpy(i3d_static["xs_cal"])]))
    got = q.calibration_summary(module)
    want = {k.replace("/", "."): v for k, v in jquant.calibration_summary(i3d_static["baked"]).items()}
    assert set(got) == set(want) and len(got) == 57
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-5)
    ref = port["convert"].state_dict_from_flax("I3D", i3d_static["baked"])
    state = module.state_dict()
    keys = [k for k in ref if k.endswith((".k8", ".sw"))]
    assert len(keys) == 2 * 56  # every QuantConv, not the prestaged stem
    for k in keys:
        assert torch.equal(state[k], ref[k]), k


def test_static_i3d_matches_jax(torch, port, i3d_static):
    """A static prestaged I3D on JAX's calibrated and baked variables."""
    module = _port_model(port, lambda: port["i3d"].I3D(CLASSES, frames=16, stem_prestaged=True, quant="static"),
                         "I3D", i3d_static["baked"])
    with torch.inference_mode():
        got = torch.softmax(module(torch.from_numpy(i3d_static["xs_eval"])), -1).numpy()
    np.testing.assert_allclose(got, i3d_static["probs"], rtol=0, atol=WHOLE_MODEL_PROB_TOL)
    np.testing.assert_array_equal(got.argmax(-1), i3d_static["probs"].argmax(-1))


@pytest.mark.parametrize("model_type", ["C3D", "R3D_18"])
def test_static_small_family_matches_jax(torch, port, model_type):
    """C3D and R3D-18 at width 0.125, static int8 on JAX's calibrated
    variables: every conv (R3D's 7³/2 stem on C = 3, its strided 3³ convs
    and 1³/2 VALID projections) on the int8 path, f32 between them."""
    rng = np.random.default_rng(31)
    x_cal, x_eval = (rng.uniform(0.0, 1.0, (2, 16, 32, 32, 3)).astype(np.float32) for _ in range(2))
    calib = jbuild(model_type, num_classes=CLASSES, quant="calib", width=0.125).module
    static = jbuild(model_type, num_classes=CLASSES, quant="static", width=0.125).module
    variables = plain_variables(calib, 32, x_cal.shape)
    baked, fwd = _flax_static(calib, static, variables, (x_cal,), (x_eval,))
    want = np.asarray(fwd(baked, x_eval))
    if model_type == "C3D":
        make = lambda: port["c3d"].C3D(CLASSES, width=0.125, clip_thw=(16, 32, 32), quant="static")  # noqa: E731
    else:
        make = lambda: port["r3d"].R3D(CLASSES, depth=18, width=0.125, quant="static")  # noqa: E731
    module = _port_model(port, make, model_type, baked)
    with torch.inference_mode():
        got = torch.softmax(module(torch.from_numpy(x_eval)), -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WHOLE_MODEL_PROB_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_static_two_stream_matches_jax(torch, port):
    """TwoStream on precomputed flow, both trunks static int8 on the shared
    s2d stagings (4C = 12 and 8)."""
    rng = np.random.default_rng(41)

    def stagings():
        rgb = rng.uniform(0.0, 1.0, (2, 16, 32, 32, 3)).astype(np.float32)
        flow = rng.normal(0.0, 1.0, (2, 16, 32, 32, 2)).astype(np.float32)
        return tuple(np.asarray(jcommon.s2d_stem_stage(jnp.asarray(a))) for a in (rgb, flow))

    cal, ev = stagings(), stagings()
    kw = dict(num_classes=CLASSES, stem_prestaged=True)
    calib = jbuild("TWOSTREAM_I3D", quant="calib", **kw).module
    static = jbuild("TWOSTREAM_I3D", quant="static", **kw).module
    variables = plain_variables(calib, 42, *[a.shape for a in cal])
    baked, fwd = _flax_static(calib, static, variables, cal, ev)
    want = np.asarray(fwd(baked, *ev))
    module = _port_model(port, lambda: port["two_stream_i3d"].TwoStreamI3D(CLASSES, frames=16, stem_prestaged=True,
                                                                            quant="static"),
                         "TWOSTREAM_I3D", baked)
    with torch.inference_mode():
        got = torch.softmax(module(*[torch.from_numpy(a) for a in ev]), -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WHOLE_MODEL_PROB_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


class _Batches:
    """Both packages' calibration input: JAX's `calibrate_members` reads
    `.batches(epoch)`, the port's iterates."""

    def __init__(self, batches):
        self._batches = batches

    def batches(self, epoch):
        return iter(self._batches)

    def __iter__(self):
        return iter(self._batches)


def test_calibrate_members_matches_jax(torch, port, i3d_static, monkeypatch):
    """`calibrate_members` on 2 batches of 0-255 clips (input_scale 1/255,
    3 given so that only 2 are taken) against JAX's: each member switched
    to 'static', its scales within 1e-5 relative, its k8 and sw equal.
    Then `member_probabilities` runs static members unchanged: on JAX's
    calibrated members it gives JAX's probabilities within 1e-3.  (The
    port's own calibration sums its f32 convs in another order: its scales
    differ by up to 1e-6 relative, which moves int8 codes that sit at a
    rounding boundary, and through a random-init member that reached 5e-3
    in probability; so its probabilities are not held to JAX's here.)"""
    monkeypatch.setattr(jquant, "quantize_variables", bake)  # JAX's eager arithmetic, compiled once
    rng = np.random.default_rng(51)
    batches = [{"rgb": rng.integers(0, 256, (2, 16, 32, 32, 3)).astype(np.float32)} for _ in range(3)]
    second = fill(i3d_static["variables"], 52)  # a second member: other values, the same tree
    members_vars = [i3d_static["variables"], second]
    bundle = JBundle("I3D", jbuild("I3D", num_classes=CLASSES, quant="calib").module, ClipSpec(16, 32, 32),
                     CLASSES, False)
    want = [numpy_tree(v) for v in jmembers.calibrate_members(bundle, members_vars, _Batches(batches),
                                                              num_batches=2, input_scale=1 / 255)]
    make = lambda q: lambda: port["i3d"].I3D(CLASSES, frames=16, stem_prestaged=True, quant=q)  # noqa: E731
    members = port["members"].calibrate_members([_port_model(port, make("calib"), "I3D", v) for v in members_vars],
                                                _Batches(batches), (32, 32), num_batches=2, input_scale=1 / 255)
    q = port["quantize"]
    for m, v in zip(members, want):
        assert all(s.quant_mode == "static" for s in q.quant_sites(m).values())
        got = q.calibration_summary(m)
        ref = {k.replace("/", "."): x for k, x in jquant.calibration_summary(v).items()}
        assert set(got) == set(ref)
        np.testing.assert_allclose([got[k] for k in ref], list(ref.values()), rtol=1e-5)
        baked = port["convert"].state_dict_from_flax("I3D", v)
        state = m.state_dict()
        for k in (k for k in baked if k.endswith((".k8", ".sw"))):
            assert torch.equal(state[k], baked[k]), k

    fwd = i3d_static["fwd"]  # the static prestaged I3D's softmax, compiled for (2, 16, 19, 19, 12)
    rgb = jmembers.prepare_member_inputs({"rgb": jnp.asarray(batches[2]["rgb"])}, (32, 32), False, 1 / 255)["rgb"]
    xs = np.asarray(jcommon.s2d_stem_stage(rgb))
    ref_probs = np.stack([np.asarray(fwd(v, xs)) for v in want])
    statics = [_port_model(port, make("static"), "I3D", v) for v in want]
    got_probs = port["members"].member_probabilities(statics, [batches[2]], (32, 32), input_scale=1 / 255)
    np.testing.assert_allclose(got_probs, ref_probs, rtol=0, atol=WHOLE_MODEL_PROB_TOL)
    np.testing.assert_array_equal(got_probs.argmax(-1), ref_probs.argmax(-1))


# ----------------------------------------------------------------------
# Policy, parameter trees, errors
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "all", "mixed", "Mixed_5c, Conv3d_2b_1x1", ("Mixed_4f", "Conv3d_1a_7x7")])
def test_resolve_quant_blocks_matches_jax(port, spec):
    assert port["quantize"].resolve_quant_blocks(spec) == jquant.resolve_quant_blocks(spec)


@pytest.mark.parametrize("prestaged", [True, False], ids=["prestaged", "canonical"])
def test_mixed_policy_quantizes_the_sites_jax_names(torch, port, prestaged):
    """quant_blocks='mixed': the port's calibrated sites are exactly the
    paths of JAX's qstats tree (the stem's at its own scope when prestaged,
    at its conv when canonical)."""
    jm = jbuild("I3D", num_classes=CLASSES, quant="calib", quant_blocks=jquant.MIXED_INT8_POLICY,
                stem_prestaged=prestaged).module
    shape = (1, 16, 19, 19, 12) if prestaged else (1, 16, 32, 32, 3)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.key(0), x, train=False),
                            jax.ShapeDtypeStruct(shape, jnp.float32))
    want = {"/".join(p.key for p in path[:-1])
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes["qstats"])[0]}
    with torch.device("meta"):
        tm = port["i3d"].I3D(CLASSES, frames=16, stem_prestaged=prestaged, quant="calib", quant_blocks="mixed")
    got = {k.replace(".", "/") for k in port["quantize"].quant_sites(tm)}
    assert got == want and len(got) == 3 + 3 * 6


@pytest.mark.parametrize("quant", [True, "calib", "static"])
@pytest.mark.parametrize("model_type", ["I3D", "TWOSTREAM_I3D", "C3D", "R3D_18", "R3D_50"])
def test_quant_models_keep_the_plain_parameters(torch, port, model_type, quant):
    """Parameter names and shapes are those of the plain model in every
    mode (JAX tests/test_quant.py::test_quant_param_tree_identical); only
    the quant buffers are added, and a plain state dict loads strictly."""
    reg = port["registry"]
    kw = {"width": 0.125} if model_type.startswith(("C3D", "R3D")) else {"stem_prestaged": True}
    with torch.device("meta"):
        plain = reg.build_model(model_type, device="meta", **kw).module
        qm = reg.build_model(model_type, device="meta", quant=quant, **kw).module
    shapes = lambda m: {n: tuple(p.shape) for n, p in m.named_parameters()}  # noqa: E731
    assert shapes(qm) == shapes(plain)
    extra = set(qm.state_dict()) - set(plain.state_dict())
    assert all(k.endswith(".act_absmax") for k in extra) and (bool(extra) == (quant != True))  # noqa: E712
    qm.load_state_dict(plain.state_dict(), strict=True, assign=True)


def test_quant_is_inference_only(torch, port):
    """Training a quantized module raises ValueError, as in JAX
    (models/common.py:73-74, :617-618), and build_model refuses a trainable
    quantized bundle."""
    c = port["common"]
    x = jnp.zeros((1, 4, 6, 6, 3))
    jmod = jcommon.ConvBN(4, (3, 3, 3), quant=True)
    with pytest.raises(ValueError, match="inference-only"):
        jmod.apply(jmod.init(jax.random.key(0), x), x, train=True, mutable=["batch_stats"])
    xt = torch.zeros(1, 3, 4, 6, 6)
    modules = [c.ConvBN(3, 4, (3, 3, 3), quant=True), c.PrestagedS2DStemConvBN(3, 8, quant="static"),
               port["c3d"].C3D(CLASSES, width=0.125, clip_thw=(16, 32, 32), quant="calib"),
               port["r3d"].R3D(CLASSES, width=0.125, quant="static")]
    inputs = [xt, torch.zeros(1, 4, 7, 7, 12), torch.zeros(1, 16, 32, 32, 3), torch.zeros(1, 16, 32, 32, 3)]
    for m, inp in zip(modules, inputs):
        with pytest.raises(ValueError, match="inference-only"):
            m.train()(inp)
    with pytest.raises(ValueError, match="inference-only"):
        port["registry"].build_model("I3D", device="cpu", quant="static", trainable=True)


# ----------------------------------------------------------------------
# The int8 conv kernel's layout and walk (csrc/int8_conv3d.cu), which the
# CPU cannot run: the packed weights, the tile choice, and a pure-torch
# emulation of the walk held to the plain version
# ----------------------------------------------------------------------


@pytest.mark.parametrize("features", [13, 48, 64, 192, 208])
@pytest.mark.parametrize("channels", [2, 3, 12, 16, 17, 24, 64])
def test_packed_int8_weights_unpack_exactly(torch, port, channels, features):
    """`unpack_int8_weights(pack_int8_weights(k8)) == k8`, for 3³ and 1³
    kernels; the packed rows are whole 128-byte stages and whole F_TILEs,
    zero past F, past K and in each tap's padded channels."""
    ic = port["int8_conv"]
    gen = torch.Generator().manual_seed(channels * 1000 + features)
    for kernel in ((3, 3, 3), (1, 1, 1)):
        k8 = torch.randint(-127, 128, (features, channels, *kernel), generator=gen, dtype=torch.int8)
        wp = ic.pack_int8_weights(k8)
        cp = ic.padded_channels(channels)
        k = math.prod(kernel) * cp
        assert wp.shape == (-(-features // ic.F_TILE) * ic.F_TILE, -(-k // ic.K_STEP) * ic.K_STEP)
        assert wp.is_contiguous() and ic.K_STEP == 128
        assert torch.equal(ic.unpack_int8_weights(wp, features, kernel, channels), k8)
        taps = wp[:features, :k].reshape(features, -1, cp)
        assert not wp[features:].any() and not wp[:, k:].any() and not taps[..., channels:].any()


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("channels", [2, 3, 8, 12, 16, 24])
def test_quantize_widens_pixels_with_zeros(torch, port, channels, dynamic):
    """`quantize_int8(x, s, dynamic, int8_input_channels(C))` on bf16 x:
    each pixel its C quantized values, then zeros to the int8 conv's pixel
    (16 from 8 to 15 channels, else C); a narrower pixel raises; and the
    int8 conv of the widened x8 equals the conv on its first C channels."""
    ic = port["int8_conv"]
    gen = torch.Generator().manual_seed(channels)
    x = (torch.randn(2, 3, 5, 7, channels, generator=gen) * 3.0).to(torch.bfloat16)
    scalar = x.abs().amax().float() / 127.0 if dynamic else torch.tensor(127.0 / 2.5)
    cp = ic.int8_input_channels(channels)
    assert cp == (16 if 8 <= channels < 16 else channels)
    got, plain = ic.quantize_int8(x, scalar, dynamic, cp), ic.quantize_int8_reference(x, scalar, dynamic)
    assert got.shape == (*x.shape[:-1], cp) and torch.equal(got[..., :channels], plain)
    assert not got[..., channels:].any() and int(plain.abs().max()) == 127
    with pytest.raises(ValueError):
        ic.quantize_int8(x, scalar, dynamic, channels - 1)
    k8 = torch.randint(-127, 128, (13, channels, 3, 3, 3), generator=gen, dtype=torch.int8)
    scale, pads = torch.rand(13, generator=gen), [(1, 1)] * 3
    wide = ic.int8_conv3d(got, ic.pack_int8_weights(k8), scale, None, (3, 3, 3), (1, 1, 1), pads)
    assert torch.equal(wide, ic.int8_conv3d_reference(plain, k8, scale, None, (1, 1, 1), pads))


@pytest.mark.parametrize(
    "m,f,kpad,want",
    [(2007040, 64, 1792, (64, 1)), (501760, 192, 1792, (192, 1)), (125440, 96, 256, (128, 1)),
     (125440, 16, 256, (64, 1)), (15680, 208, 2688, (256, 1)), (15680, 288, 3968, (192, 1)),
     (2352, 384, 896, (192, 1)), (2352, 320, 4352, (192, 3)), (2352, 384, 5248, (192, 3)),
     (2352, 128, 1408, (128, 1)), (105, 13, 256, (64, 1)), (128, 256, 128, (256, 1))],
)
def test_int8_conv_tiling(port, m, f, kpad, want):
    """The kernel's tile choice at I3D's shapes (B=16) and small ones: the F
    tile that wastes least (F = 208 → 256, 288 → 2 × 192, 96 → 128); K
    split only where the row and F tiles fill less than one wave of 132
    SMs and K is long enough to pay for the finish kernel (Mixed_5b/5c's
    3³ convs, M = 2,352; not their 1³ ones), into at most 8 parts, each
    walking at least one stage, that fill at most one wave."""
    ic = port["int8_conv"]
    bn, splits = ic.int8_conv_tiling(m, f, kpad, sms=132)
    assert (bn, splits) == want and bn in ic.F_TILES
    blocks, steps = -(-m // ic.M_TILE) * -(-f // bn), kpad // ic.K_STEP
    assert 1 <= splits <= min(8, steps)
    if splits > 1:
        per = -(-steps // splits)
        assert blocks < 132 and -(-steps // per) == splits and blocks * splits <= 132


def _kernel_walk(torch, ic, x8, wp, scale, bias, kernel, strides, pads, splits):
    """The kernel's computation in torch, as csrc/int8_conv3d.cuh walks it:
    K in stages of 128 bytes (K_STEP), each the 8 16-byte chunks of every
    row of output positions; chunk j of a stage found by a tap cursor that
    starts at the split's first byte and advances 128 bytes a stage by
    additions alone, its byte offset from each row's origin included
    (padded layout, C ≥ 8), or byte by byte at its own tap (C < 8); the
    bytes read from the flat x at origin + offset, zero where the tap falls
    in the padding, past the kernel or past C; each split's exact partial
    sums added, then one f32 dequantize."""
    n, d, h, w, c = x8.shape
    kd, kh, kw = kernel
    cp = ic.padded_channels(c)
    k_real = kd * kh * kw * cp
    out = ic.conv_output_shape((d, h, w), kernel, strides, pads)
    m = torch.arange(n * math.prod(out))
    ow, oh, od, img = m % out[2], m // out[2] % out[1], m // (out[2] * out[1]) % out[0], m // math.prod(out)
    origin = [od * strides[0] - pads[0][0], oh * strides[1] - pads[1][0], ow * strides[2] - pads[2][0]]
    row_ptr = (((img * d + origin[0]) * h + origin[1]) * w + origin[2]) * c  # may lie in the padding
    x_flat = torch.nn.functional.pad(x8.reshape(-1), (0, 16))  # a chunk may run past the last pixel's C

    def cursor_at(k):  # [channel, td, th, tw, offset from a row's origin] of reduction index k
        tap, ch = divmod(k, cp)
        td, rest = divmod(tap, kh * kw)
        th, tw = divmod(rest, kw)
        return [ch, td, th, tw, ((td * h + th) * w + tw) * c + ch]

    def advance(q, step):  # additions alone, as the kernel's `advance`
        q[0] += step
        q[4] += step
        while q[0] >= cp:
            q[0] -= cp
            q[4] += c - cp
            q[3] += 1
            if q[3] == kw:
                q[3] = 0
                q[4] += (w - kw) * c
                q[2] += 1
                if q[2] == kh:
                    q[2] = 0
                    q[4] += (h - kh) * w * c
                    q[1] += 1

    def tap_bytes(q, count):  # (M, count) bytes at channels q[0].. of tap q[1:4], zero outside
        ch, taps, off = q[0], q[1:4], q[4]
        if taps[0] >= kd:
            return torch.zeros(len(m), count, dtype=torch.int8)
        pos = [o + t for o, t in zip(origin, taps)]
        ok = (pos[0] >= 0) & (pos[0] < d) & (pos[1] >= 0) & (pos[1] < h) & (pos[2] >= 0) & (pos[2] < w)
        addr = torch.where(ok, row_ptr + off, 0)[:, None] + torch.arange(count)
        got = torch.where(torch.arange(count) < c - ch, x_flat[addr], 0)  # past C: zero
        return torch.where(ok[:, None], got, torch.zeros_like(got))

    steps = wp.shape[1] // ic.K_STEP
    per = -(-steps // splits)
    acc = torch.zeros(len(m), wp.shape[0], dtype=torch.int64)
    for first in range(0, steps, per):  # one split: its blocks' partial sums, then the atomics
        cursors = [cursor_at(first * 128 + 16 * j) for j in range(8)]
        part = torch.zeros_like(acc)
        for step in range(first, min(first + per, steps)):
            chunks = []
            for j in range(8):
                k = step * 128 + 16 * j
                if cp % 16 == 0:
                    chunks.append(tap_bytes(cursors[j], 16))
                    advance(cursors[j], 128)
                else:
                    cols = [tap_bytes(cursor_at(k + s), 1) if k + s < k_real
                            else torch.zeros(len(m), 1, dtype=torch.int8) for s in range(16)]
                    chunks.append(torch.cat(cols, 1))
            a = torch.cat(chunks, 1).long()
            part += a @ wp[:, step * 128:(step + 1) * 128].long().t()
        acc += part
    f = scale.shape[0]
    assert acc.abs().max() < 2 ** 31  # the kernel's int32 sums
    y = acc[:, :f].to(torch.int32).float() * scale
    if bias is not None:
        y = y + bias
    return y.view(n, *out, f)


# (x NTHWC, F, kernel, strides, pads): the prestaged stem on 4C = 12, ragged
# C = 24 and 17 with asymmetric pads and a (1, 2, 1) stride, C = 3 and 2 on
# the byte-gather layout (the R3D stem's 7³/2), a 1³/2 VALID projection,
# and a small-M 3³ conv on C = 160 (K = 4,320, 34 stages) that splits K.
WALK_CASES = [
    ((1, 6, 9, 9, 12), 13, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((2, 3, 5, 7, 24), 40, (3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1))),
    ((1, 3, 5, 7, 17), 13, (3, 3, 3), (1, 2, 1), ((1, 1), (0, 2), (1, 0))),
    ((1, 4, 6, 6, 3), 8, (3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1))),
    ((1, 4, 8, 8, 2), 16, (7, 7, 7), (2, 2, 2), ((2, 3), (2, 3), (2, 3))),
    ((2, 4, 6, 6, 64), 48, (1, 1, 1), (2, 2, 2), ((0, 0), (0, 0), (0, 0))),
    ((1, 2, 3, 3, 160), 20, (3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1))),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-F{c[1]}")
def test_kernel_walk_equals_plain_int8_conv(torch, port, case):
    """The emulated walk of the int8 conv kernel (`_kernel_walk`) equals
    the plain version bit for bit, unsplit and with K split as the tiling
    chooses at one SM (every small case then splits) and into 3 parts."""
    ic = port["int8_conv"]
    shape, f, kernel, strides, pads = case
    gen = torch.Generator().manual_seed(sum(shape) + f)
    x8 = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    k8 = torch.randint(-127, 128, (f, shape[-1], *kernel), generator=gen, dtype=torch.int8)
    scale, bias = torch.rand(f, generator=gen) * 1e-3, torch.randn(f, generator=gen)
    wp = ic.pack_int8_weights(k8)
    want = ic.int8_conv3d_reference(x8, k8, scale, bias, strides, pads)
    m = want.numel() // f
    _, chosen = ic.int8_conv_tiling(m, f, wp.shape[1], sms=1 if m <= ic.M_TILE else 132)
    steps = wp.shape[1] // ic.K_STEP
    for splits in sorted({1, chosen, min(3, steps)}):
        got = _kernel_walk(torch, ic, x8, wp, scale, bias, kernel, strides, pads, splits)
        assert torch.equal(got, want), splits


def _slab_walk(torch, ic, x8, wp, scale, bias, kernel, strides, pads):
    """The row-slab route's computation in torch, as
    csrc/int8_conv3d_slab.cu walks it: for each output row and each
    temporal tap inside the clip (the others skipped whole), k32 steps j
    over (th, a pair of taps along W): the A operand is 32 bytes of the
    input row, pixels wo + 2 pp and the next (the overlapping core
    matrices), the B operand the 32 bytes at j·32 of the tap's K slice
    (box j // 4, offset (j % 4)·32); then one f32 dequantize."""
    n, d, h, w, c = x8.shape
    kd, kh, kw = kernel
    out = ic.conv_output_shape((d, h, w), kernel, strides, pads)
    f = scale.shape[0]
    acc = torch.zeros(n, *out, wp.shape[0], dtype=torch.int64)
    xl, wl = x8.long(), wp.long()
    for to in range(out[0]):
        t0 = to * strides[0] - pads[0][0]
        for dt in range(max(0, -t0), min(kd, d - t0)):
            for j in range(kh * kw // 2):
                th, pp = divmod(j, kw // 2)
                rows = xl[:, t0 + dt, th:th + out[1]]  # (n, Ho, W, C): input rows ho + th
                a = torch.cat([rows[:, :, 2 * pp:2 * pp + out[2]], rows[:, :, 2 * pp + 1:2 * pp + 1 + out[2]]], -1)
                k0 = dt * kh * kw * 16 + (j // 4) * 128 + (j % 4) * 32
                acc[:, to] += a @ wl[:, k0:k0 + 32].t()
    y = acc[..., :f].to(torch.int32).float() * scale
    return y + bias if bias is not None else y


# (x NTHWC, F, kernel, strides, pads) on the row-slab route: the stem's form
# (a (7, 4, 4) kernel, strides (2, 1, 1), temporal pads (2, 3)) at odd H,
# and a (3, 2, 4) kernel with odd Ho and pads (1, 1) in T.
SLAB_CASES = [
    ((1, 6, 9, 13, 16), 13, (7, 4, 4), (2, 1, 1), ((2, 3), (0, 0), (0, 0))),
    ((2, 4, 6, 9, 16), 20, (3, 2, 4), (1, 1, 1), ((1, 1), (0, 0), (0, 0))),
]


@pytest.mark.parametrize("case", SLAB_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-F{c[1]}")
def test_row_slab_walk_equals_plain_int8_conv(torch, port, case):
    """The row-slab route is chosen for these convs (and not for the stem's
    unpadded 12 channels, nor with a spatial pad), and its emulated walk
    (`_slab_walk`) equals the plain version bit for bit."""
    ic = port["int8_conv"]
    shape, f, kernel, strides, pads = case
    gen = torch.Generator().manual_seed(sum(shape) + f)
    x8 = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    k8 = torch.randint(-127, 128, (f, 16, *kernel), generator=gen, dtype=torch.int8)
    scale, bias = torch.rand(f, generator=gen) * 1e-3, torch.randn(f, generator=gen)
    wp = ic.pack_int8_weights(k8)
    assert ic.int8_conv_route(x8, wp, f, kernel, strides, pads)["slab"] == 1
    assert ic.int8_conv_route(x8[..., :12].contiguous(), ic.pack_int8_weights(k8[:, :12]), f, kernel, strides,
                              pads)["slab"] == 0
    padded = (pads[0], (0, 1), pads[2])
    assert ic.int8_conv_route(x8, wp, f, kernel, strides, padded)["slab"] == 0
    want = ic.int8_conv3d_reference(x8, k8, scale, bias, strides, pads)
    assert torch.equal(_slab_walk(torch, ic, x8, wp, scale, bias, kernel, strides, pads), want)
