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
