"""The port's Keras-layout weights layer (`models/weights_io.py`,
`models/pretrained.py`, `models/weights_registry.py`, `I3DKinetics`)
against the JAX package's, and the int8 accuracy gate on a
reference-layout checkpoint, on the CPU.

The converters are held to JAX `weights_io` leaf for leaf, exactly, on the
same numpy layer dicts (tests/oracle_{i3d,c3d,r3d}.random_*_h5_layers).
The golden forwards take a checkpoint through `write_keras_h5` →
`read_keras_h5` → `load_pretrained` into the port's full-width model and
compare its float32 softmax with the float64 oracles within the BASELINE
bar of 1e-4 (tests/test_keras_parity_golden*.py check the JAX package the
same way).  torch and the port are imported by fixtures, not at collection
(tests/torch_port_memory.py).
"""

import functools
import importlib
import os

import numpy as np
import pytest

from crowded_scenes_ensemble_classification_tpu.models import weights_io as jwio
from crowded_scenes_ensemble_classification_tpu.models import weights_registry as jreg
import oracle_i3d
import oracle_r3d
from oracle_c3d import random_c3d_h5_layers
from oracle_i3d import i3d_forward, i3d_kinetics_forward
from oracle_r3d import r3d_forward
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SOFTMAX_BAR = 1e-4  # BASELINE.json's softmax bar


@pytest.fixture(scope="module")
def wio(torch):
    return importlib.import_module(f"{PORT}.models.weights_io")


@pytest.fixture(scope="module")
def pretrained(torch):
    return importlib.import_module(f"{PORT}.models.pretrained")


@functools.lru_cache(maxsize=None)
def random_i3d_h5_layers(**kw):
    """`oracle_i3d.random_i3d_h5_layers`, drawn once per arguments (the
    callers copy before they change it)."""
    return oracle_i3d.random_i3d_h5_layers(**kw)


@functools.lru_cache(maxsize=None)
def random_r3d_h5_layers(**kw):
    """`oracle_r3d.random_r3d_h5_layers`, drawn once per arguments."""
    return oracle_r3d.random_r3d_h5_layers(**kw)


@pytest.fixture(scope="module", autouse=True)
def drop_layer_caches(release_heap_after_module):  # noqa: F811 (torch_port_memory's fixture, torn down after)
    """Empty the layer-dict caches when the module ends, before its heap is
    handed back: a worker keeps its module globals for the whole run."""
    yield
    random_i3d_h5_layers.cache_clear()
    random_r3d_h5_layers.cache_clear()


def _leaves(tree, prefix=()):
    items = enumerate(tree) if isinstance(tree, tuple) else tree.items()  # a trunk's (params, stats)
    for k, v in items:
        if isinstance(v, (dict, tuple)):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def assert_same_tree(got, want):
    """Same paths, and at each the same dtype, shape and values."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path, leaf in w.items():
        assert g[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(g[path], leaf, err_msg="/".join(path))


def zeros_module(torch, build):
    """`build()` made on the meta device and materialised on the CPU as
    zeros: a full-width model in a fraction of its random init's time, for
    tests whose weights all come from a checkpoint."""
    with torch.device("meta"):
        module = build()
    module.to_empty(device="cpu")
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            t.zero_()
    return module.eval()


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


CONVERSIONS = {
    "C3D": lambda w: (w.c3d_variables_from_keras, (random_c3d_h5_layers(seed=11, width=0.25),), {}),
    "C3D_head_surgery": lambda w: (w.c3d_variables_from_keras, (random_c3d_h5_layers(seed=12, width=0.25),),
                                   {"num_classes": 5, "head_init": np.full((1024, 5), 0.5, np.float32),
                                    "head_bias": np.arange(5, dtype=np.float32)}),
    "I3D": lambda w: (w.i3d_variables_from_keras, (random_i3d_h5_layers(seed=3, num_classes=11),),
                      {"num_classes": 11}),
    "I3D_other_head": lambda w: (w.i3d_variables_from_keras, (random_i3d_h5_layers(seed=4),), {"num_classes": 7}),
    "I3D_flow_trunk": lambda w: (w.i3d_trunk_variables_from_keras,
                                 (random_i3d_h5_layers(seed=5, stream="flow"), "flow"), {}),
    "I3DKinetics": lambda w: (w.i3d_kinetics_variables_from_keras,
                              (random_i3d_h5_layers(seed=31, num_classes=7, include_top=True),), {}),
    "TWOSTREAM_I3D": lambda w: (w.twostream_variables_from_keras,
                                (random_i3d_h5_layers(seed=21), random_i3d_h5_layers(seed=22, stream="flow")), {}),
    "R3D_18": lambda w: (w.r3d_variables_from_keras, (random_r3d_h5_layers(seed=30, depth=18, num_classes=11), 18),
                         {}),
    "R3D_18_head_surgery": lambda w: (w.r3d_variables_from_keras,
                                      (random_r3d_h5_layers(seed=6, depth=18, num_classes=7), 18),
                                      {"num_classes": 11}),
    "R3D_50": lambda w: (w.r3d_variables_from_keras, (random_r3d_h5_layers(seed=40, depth=50), 50), {}),
}


@pytest.mark.parametrize("case", list(CONVERSIONS))
def test_keras_conversion_equals_jax(wio, case):
    """Each family's converter builds JAX weights_io's tree on the same
    layer dicts, leaf for leaf: C3D with and without the head surgery (a
    fresh head in place of a checkpoint head of another width), I3D with
    its Dense and with one of another width (dropped), a flow trunk, the
    Kinetics head, both TwoStream trunks, R3D-18/50 with the auto-named
    walk and with a head of another width (dropped)."""
    port_fn, args, kw = CONVERSIONS[case](wio)
    assert_same_tree(port_fn(*args, **kw), getattr(jwio, port_fn.__name__)(*args, **kw))


@pytest.mark.parametrize("family", ["C3D", "I3D", "I3D_flow", "R3D_18"])
def test_to_keras_round_trips(wio, family):
    """to_keras ∘ from_keras is the identity on the layer dicts, and each
    to_keras equals JAX's on the same variables."""
    if family == "C3D":
        layers = random_c3d_h5_layers(seed=1, width=0.25)
        back = wio.c3d_variables_to_keras(wio.c3d_variables_from_keras(layers))
        want = jwio.c3d_variables_to_keras(jwio.c3d_variables_from_keras(layers))
    elif family.startswith("I3D"):
        stream = "flow" if family == "I3D_flow" else "rgb"
        layers = dict(random_i3d_h5_layers(seed=2, stream=stream))
        if stream == "flow":
            layers.pop("predictions")
        variables = wio.i3d_variables_from_keras(layers, stream=stream)
        back = wio.i3d_variables_to_keras(variables, stream=stream)
        want = jwio.i3d_variables_to_keras(variables, stream=stream)
    else:
        depth = int(family.split("_")[1])
        layers = random_r3d_h5_layers(seed=30, depth=depth, num_classes=11)
        back = wio.r3d_variables_to_keras(wio.r3d_variables_from_keras(layers, depth), depth)
        want = jwio.r3d_variables_to_keras(jwio.r3d_variables_from_keras(layers, depth), depth)
    assert_same_tree(back, layers)
    assert_same_tree(back, want)


def test_merge_pretrained_equals_jax(wio):
    """The overlay keeps fresh leaves the checkpoint lacks and refuses two
    shapes at one leaf, as JAX's merge does."""
    fresh = {"params": {"a": {"kernel": np.zeros((2, 3), np.float32)}, "head": {"bias": np.ones(4, np.float32)}},
             "batch_stats": {"a": {"mean": np.zeros(3, np.float32)}}}
    ckpt = {"params": {"a": {"kernel": np.full((2, 3), 2.0, np.float32)}}}
    assert_same_tree(wio.merge_pretrained(fresh, ckpt), jwio.merge_pretrained(fresh, ckpt))
    bad = {"params": {"a": {"kernel": np.zeros((2, 4), np.float32)}}}
    with pytest.raises(ValueError, match="shape mismatch"):
        wio.merge_pretrained(fresh, bad)


def test_h5_files_round_trip_in_the_keras2_layout(wio, tmp_path):
    """write_keras_h5 → read_keras_h5 returns the layer dicts; the file has
    the Keras 2.x layout (each dataset at the full `layer/base:0` name under
    its layer group), and JAX's reader reads the port's file the same."""
    import h5py

    layers = random_c3d_h5_layers(seed=8, width=0.25)
    path = wio.write_keras_h5(str(tmp_path / "sub" / "c3d.h5"), layers)
    assert_same_tree(wio.read_keras_h5(path), layers)
    assert_same_tree(jwio.read_keras_h5(path), layers)
    with h5py.File(path, "r") as f:
        text = lambda v: v.decode() if isinstance(v, bytes) else str(v)  # noqa: E731
        assert [text(v) for v in f.attrs["layer_names"]] == list(layers)
        for layer in layers:
            for name in f[layer].attrs["weight_names"]:
                assert isinstance(f[layer][text(name)], h5py.Dataset)


def test_registry_tables_equal_jax(torch):
    reg = importlib.import_module(f"{PORT}.models.weights_registry")
    assert reg.WEIGHTS_NAME == jreg.WEIGHTS_NAME
    assert reg.WEIGHTS_PATH == jreg.WEIGHTS_PATH and reg.WEIGHTS_PATH_NO_TOP == jreg.WEIGHTS_PATH_NO_TOP
    assert reg.SPORTS1M_FILENAME == jreg.SPORTS1M_FILENAME
    for name in reg.WEIGHTS_NAME:
        for top in (True, False):
            assert reg.cached_filename(name, top) == jreg.cached_filename(name, top)
    assert not hasattr(reg, "fetch_weights")  # nothing is downloaded


@pytest.mark.parametrize("form", [{}, {"stem_impl": "pallas"}, {"stem_prestaged": True}, {"s2d_stem": True}])
def test_converted_i3d_loads_strictly_into_every_stem_form(torch, wio, form):
    """The canonical, kernel, prestaged and s2d stems share one state dict,
    so a converted checkpoint loads strictly into each; the stem holds the
    checkpoint's 7³ kernel as OIDHW."""
    i3d = importlib.import_module(f"{PORT}.models.i3d")
    layers = random_i3d_h5_layers(seed=3, num_classes=11)
    state = wio.state_dict_from_keras("I3D", layers, num_classes=11)
    module = zeros_module(torch, lambda: i3d.I3D(11, frames=16, **form))
    module.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(module.trunk.Conv3d_1a_7x7.conv.weight.detach().numpy(),
                                  layers["Conv3d_1a_7x7_rgb_conv"]["kernel"].transpose(4, 3, 0, 1, 2))


def test_converted_files_and_twostream_refusals(torch, pretrained, tmp_path):
    """convert_keras_checkpoint writes one state-dict file: TwoStream's two
    streams combined (its flow trunk from the flow file, its head fresh), an
    I3D with include_top routed to the Kinetics head.  Mixed inputs are
    refused as in JAX: a file without a flow trunk, a combined file with a
    flow checkpoint beside it, a converted file as the flow checkpoint; and
    include_top outside I3D."""
    reg = importlib.import_module(f"{PORT}.models.weights_registry")
    two = importlib.import_module(f"{PORT}.models.two_stream_i3d")
    rgb, flow = dict(random_i3d_h5_layers(seed=41)), dict(random_i3d_h5_layers(seed=42, stream="flow"))
    rgb.pop("predictions"), flow.pop("predictions")
    out, state = reg.convert_keras_checkpoint("TWOSTREAM_I3D", str(tmp_path / "ts.pt"), rgb, flow)
    assert not os.path.exists(out + ".tmp")
    module = zeros_module(torch, lambda: two.TwoStreamI3D(11, frames=16))
    head = module.predictions.weight.detach().clone()
    pretrained.load_pretrained("TWOSTREAM_I3D", module, 11, rgb_h5=out)
    np.testing.assert_array_equal(module.flow_trunk.Conv3d_1a_7x7.conv.weight.detach().numpy(),
                                  flow["Conv3d_1a_7x7_flow_conv"]["kernel"].transpose(4, 3, 0, 1, 2))
    assert torch.equal(module.predictions.weight, head)

    rgb_only = str(tmp_path / "rgb_only.pt")
    torch.save({k: v for k, v in state.items() if k.startswith("rgb_trunk.")}, rgb_only)
    with pytest.raises(ValueError, match="flow_trunk"):
        pretrained.load_pretrained("TWOSTREAM_I3D", module, 11, rgb_h5=rgb_only)
    with pytest.raises(ValueError, match="combined"):
        pretrained.load_pretrained("TWOSTREAM_I3D", module, 11, rgb_h5=out, flow_h5=flow)
    with pytest.raises(ValueError, match="converted"):
        pretrained.load_pretrained("TWOSTREAM_I3D", module, 11, rgb_h5=rgb, flow_h5=out)

    top = random_i3d_h5_layers(seed=61, num_classes=7, include_top=True)
    _, kin = reg.convert_keras_checkpoint("I3D", str(tmp_path / "top.pt"), top, include_top=True)
    np.testing.assert_array_equal(kin["Conv3d_6a_1x1.conv.weight"].numpy()[:, :, 0, 0, 0],
                                  top["Conv3d_6a_1x1_rgb_conv"]["kernel"][0, 0, 0].T)
    assert torch.equal(reg.load_converted(str(tmp_path / "top.pt"))["Conv3d_6a_1x1.conv.bias"],
                       kin["Conv3d_6a_1x1.conv.bias"])
    with pytest.raises(ValueError, match="include_top"):
        reg.convert_keras_checkpoint("C3D", str(tmp_path / "x.pt"), top, include_top=True)


def test_c3d_and_r3d_head_surgery_on_load(torch, pretrained):
    """A C3D checkpoint of another head width loads its trunk and keeps the
    module's fresh fc8; an R3D one likewise keeps its fresh head; R3D with
    no checkpoint is a no-op; a trunk of another shape raises."""
    c3d_mod = importlib.import_module(f"{PORT}.models.c3d")
    r3d_mod = importlib.import_module(f"{PORT}.models.r3d")
    c3d = c3d_mod.C3D(11, 0.25, clip_thw=(16, 112, 112)).eval()
    fc8 = c3d.fc8.weight.detach().clone()
    layers = random_c3d_h5_layers(seed=13, width=0.25, num_classes=487)
    pretrained.load_pretrained("C3D", c3d, 11, rgb_h5=layers)
    assert torch.equal(c3d.fc8.weight, fc8)
    np.testing.assert_array_equal(c3d.fc7.weight.detach().numpy(), layers["fc7"]["kernel"].T)

    r3d = zeros_module(torch, lambda: r3d_mod.R3D(11, 18))
    before = {k: v.clone() for k, v in r3d.state_dict().items()}
    pretrained.load_pretrained("R3D_18", r3d, 11)
    assert all(torch.equal(v, before[k]) for k, v in r3d.state_dict().items())
    pretrained.load_pretrained("R3D_18", r3d, 11, rgb_h5=random_r3d_h5_layers(seed=6, depth=18, num_classes=7))
    assert torch.equal(r3d.predictions.weight, before["predictions.weight"])
    assert not torch.equal(r3d.conv1.weight, before["conv1.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        pretrained.load_pretrained("C3D", c3d, 11, rgb_h5=random_c3d_h5_layers(seed=15, width=0.5))


# ----------------------------------------------------------------------
# Golden forwards: Keras file → port model → float64 oracle
# ----------------------------------------------------------------------


def _golden(torch, wio, pretrained, tmp_path, model_type, module, layers, x, num_classes):
    path = wio.write_keras_h5(str(tmp_path / "ckpt.h5"), layers)
    pretrained.load_pretrained(model_type, module.eval(), num_classes, rgb_h5=path)
    with torch.inference_mode():
        return module(torch.from_numpy(x)).numpy()


def test_full_i3d_keras_checkpoint_forward_matches_oracle(torch, wio, pretrained, tmp_path):
    """The full-width I3D from `random_i3d_h5_layers(seed=3)` on (1, 16,
    32, 32, 3): f32 softmax within 1e-4 of the float64 oracle (measured
    about 1e-8)."""
    i3d = importlib.import_module(f"{PORT}.models.i3d")
    x = np.random.default_rng(7).uniform(-1, 1, (1, 16, 32, 32, 3)).astype(np.float32)
    layers = random_i3d_h5_layers(seed=3, num_classes=11)
    module = zeros_module(torch, lambda: i3d.I3D(11, frames=16))
    logits = _golden(torch, wio, pretrained, tmp_path, "I3D", module, layers, x, 11)
    oracle = i3d_forward(layers, x)
    np.testing.assert_allclose(logits, oracle["logits"], atol=1e-5)
    np.testing.assert_allclose(_softmax(logits), oracle["softmax"], atol=SOFTMAX_BAR)


def test_i3d_kinetics_keras_checkpoint_forward_matches_oracle(torch, wio, pretrained, tmp_path):
    """The with-top Kinetics I3D (the `Conv3d_6a_1x1` conv head) on the
    smallest clip its (2, 7, 7) pool admits, (1, 9, 193, 193, 3): logits
    within 2e-5 of the oracle (JAX's bar at 224²), softmax within 1e-4."""
    i3d = importlib.import_module(f"{PORT}.models.i3d")
    x = np.random.default_rng(32).uniform(-1, 1, (1, 9, 193, 193, 3)).astype(np.float32)
    layers = random_i3d_h5_layers(seed=31, num_classes=7, include_top=True)
    module = zeros_module(torch, lambda: i3d.I3DKinetics(7))
    logits = _golden(torch, wio, pretrained, tmp_path, "I3D", module, layers, x, 7)
    oracle = i3d_kinetics_forward(layers, x)
    np.testing.assert_allclose(logits, oracle, atol=2e-5)
    np.testing.assert_allclose(_softmax(logits), _softmax(oracle), atol=SOFTMAX_BAR)


def test_full_r3d18_keras_checkpoint_forward_matches_oracle(torch, wio, pretrained, tmp_path):
    """R3D-18 at full width on (1, 16, 112, 112, 3), JAX's golden geometry:
    the stride and channel projections, full-affine BN."""
    r3d = importlib.import_module(f"{PORT}.models.r3d")
    x = np.random.default_rng(31).uniform(0, 1, (1, 16, 112, 112, 3)).astype(np.float32)
    layers = random_r3d_h5_layers(seed=30, depth=18, num_classes=11)
    module = zeros_module(torch, lambda: r3d.R3D(11, 18))
    logits = _golden(torch, wio, pretrained, tmp_path, "R3D_18", module, layers, x, 11)
    oracle = r3d_forward(layers, x, 18)
    np.testing.assert_allclose(logits, oracle["logits"], atol=2e-5)
    np.testing.assert_allclose(_softmax(logits), oracle["softmax"], atol=SOFTMAX_BAR)


def test_committed_stem_fixture_matches_golden(torch, wio):
    """The committed Keras-2.x file `tests/fixtures/stem_convbn.h5` through
    the port's reader into a 7³/2 ConvBN: within 1e-6 of
    `stem_convbn_golden.npz`, as JAX's ConvBN is held."""
    common = importlib.import_module(f"{PORT}.models.common")
    convert = importlib.import_module(f"{PORT}.models.convert")
    layers = wio.read_keras_h5(os.path.join(FIXTURES, "stem_convbn.h5"))
    gold = np.load(os.path.join(FIXTURES, "stem_convbn_golden.npz"))
    conv, bn = layers["Conv3d_1a_7x7_rgb_conv"], layers["Conv3d_1a_7x7_rgb_bn"]
    variables = {"params": {"conv": {"kernel": conv["kernel"]}, "bn": {"bias": bn["beta"]}},
                 "batch_stats": {"bn": {"mean": bn["moving_mean"], "var": bn["moving_variance"]}}}
    module = common.ConvBN(conv["kernel"].shape[3], conv["kernel"].shape[4], (7, 7, 7), (2, 2, 2)).eval()
    module.load_state_dict(convert.i3d_state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        out = common.to_nthwc(module(common.to_ncdhw(torch.from_numpy(gold["x"])))).numpy()
    np.testing.assert_allclose(out, gold["golden"], atol=1e-6)


# ----------------------------------------------------------------------
# The int8 accuracy gate (JAX tests/test_quant.py:97-125, :222-258)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def gate(torch, pretrained):
    """The f32 I3D on `random_i3d_h5_layers(seed=3)` and two raw 0-255
    batches (2, 16, 32, 32, 3) from default_rng(11), the JAX gate's
    checkpoint and inputs, with the f32 softmax of each."""
    i3d = importlib.import_module(f"{PORT}.models.i3d")
    layers = random_i3d_h5_layers(seed=3, num_classes=11)
    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(rng.uniform(0, 255, (2, 16, 32, 32, 3)).astype(np.float32)) for _ in range(2)]
    f32 = zeros_module(torch, lambda: i3d.I3D(11, frames=16))
    pretrained.load_pretrained("I3D", f32, 11, rgb_h5=layers)
    with torch.inference_mode():
        return layers, xs, [torch.softmax(f32(x), -1) for x in xs]


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_i3d_close_to_f32_on_reference_checkpoint(torch, pretrained, gate, mode):
    """The dynamic I3D, and the static one calibrated on the first batch
    (`calibrate` → `quantize_variables` → 'static'), within 0.05 of the
    f32 softmax with top-1 unchanged; the static one on the held-out batch
    finite with top-1 stable."""
    i3d = importlib.import_module(f"{PORT}.models.i3d")
    quantize = importlib.import_module(f"{PORT}.models.quantize")
    layers, (x, held), (p32, f_held) = gate
    quant = "calib" if mode == "static" else True
    module = pretrained.load_pretrained("I3D", zeros_module(torch, lambda: i3d.I3D(11, frames=16, quant=quant)), 11,
                                        rgb_h5=layers)
    if mode == "static":
        summary = quantize.calibration_summary(quantize.calibrate(module, [x]))
        assert len(summary) == 57 and all(v > 0 for v in summary.values())
        quantize.set_quant_mode(quantize.quantize_variables(module), "static")
    with torch.inference_mode():
        p8 = torch.softmax(module(x), -1)
        q_held = torch.softmax(module(held), -1)
    assert torch.equal(p8.argmax(-1), p32.argmax(-1)), "top-1 changed under int8"
    assert (p8 - p32).abs().max().item() < 0.05
    if mode == "static":
        assert bool(torch.isfinite(q_held).all())
        assert torch.equal(q_held.argmax(-1), f_held.argmax(-1))
