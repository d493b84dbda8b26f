"""The port's distribution layer, part 1, against the JAX package on the CPU.

- `core/mesh`: the same mesh shapes and the same errors for the same
  arguments; `shard_batch`/`gather`; no card and no devices raises.
- `parallel/temporal_halo`: `halo_exchange`, `halo_conv3d` (the four
  (kt, st) of the I3D stem and its 3³ convs), `halo_max_pool3d` (the four
  I3D pools, the 3³/1 one on the max-pool kernel's plain version) and
  `time_sharded_conv_stack` against JAX's `shard_map` forms on a JAX mesh
  of the same size, f32, atol 1e-4 (tests/test_parallel.py:188); the
  time-sharded I3D trunk against JAX's on the same numpy-seeded flax
  variables with planted BN statistics, converted by `models.convert`
  (atol 2e-3, rtol 1e-4, tests/test_parallel.py:217), and against the
  port's unsharded `I3DTrunk`.
- `parallel/halo_train`: the sharded train step's loss, gradients and
  batch moments, and `update_running_stats`, against JAX's step on
  `_ConvBNStack`'s specs (tests/test_parallel.py:223-237) and on the I3D
  front end with a 3³/1 pool, at tests/test_parallel.py:290-319's
  tolerances.
- `member_probabilities(mesh=)` against JAX's on tests/test_ensemble.py:
  287-309's geometry (C3D at width 0.125), and equal to the unsharded form.
- `probs --mesh-data 2` and `cache_probabilities` over a member mesh give
  the npz of the unsharded run, and `train_member` over a mesh trains as
  without one; `my_member_assignments` in one process.

Small sizes: 4 positions on the CPU, 32-frame clips at 32² for the trunk.
torch and the port are imported by fixtures (tests/torch_port_memory.py).
"""

import importlib
import re
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from crowded_scenes_ensemble_classification_tpu.core import mesh as jmesh
from crowded_scenes_ensemble_classification_tpu.parallel import distributed as jdistributed
from crowded_scenes_ensemble_classification_tpu.parallel import halo_train as jhalo_train
from crowded_scenes_ensemble_classification_tpu.parallel import temporal_halo as jhalo
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

PORT = "crowded_scenes_ensemble_classification_tpu_torch"
N = 4  # positions


@pytest.fixture(scope="module")
def port(torch):
    names = ("core.mesh", "parallel.temporal_halo", "parallel.halo_train", "parallel.distributed", "parallel",
             "models.i3d", "models.convert", "models.c3d", "ensemble.members")
    return SimpleNamespace(**{n.replace(".", "_"): importlib.import_module(f"{PORT}.{n}") for n in names})


@pytest.fixture(scope="module")
def cpu_mesh(torch, port):
    return port.core_mesh.make_mesh((("time", N),), [torch.device("cpu")] * N)


def _jax_time_sharded(fn):
    """fn inside shard_map over a JAX ('time', N) mesh, in and out sharded on axis 1."""
    mesh = jmesh.make_mesh((("time", N),), jax.devices()[:N])
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P(None, "time"), out_specs=P(None, "time")))


def _port_sharded(torch, port, mesh, x, fn):
    """fn over the port's time-sharded form of numpy x, gathered to numpy."""
    shards = port.parallel_temporal_halo.shard_time(torch.from_numpy(x), mesh)
    return port.core_mesh.gather(fn(shards), dim=1).numpy()


def _oidhw(k):
    """A JAX DHWIO kernel as the port's (F, C, kt, kh, kw) tensor."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(4, 3, 0, 1, 2)))


# ----------------------------------------------------------------------
# core/mesh
# ----------------------------------------------------------------------


@pytest.mark.parametrize("axes,count", [
    ((("data", -1),), 8), ((("member", 2), ("data", -1)), 8), ((("member", 4), ("data", 2)), 8),
    ((("time", 4),), 4), ((("a", -1), ("b", -1)), 8), ((("a", 3), ("b", -1)), 8), ((("a", 3),), 8),
])
def test_make_mesh_matches_jax(torch, port, axes, count):
    """The same shape, or the same ValueError, for the same arguments."""
    try:
        want = jmesh.make_mesh(axes, jax.devices()[:count])
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{re.escape(str(e))}$"):
            port.core_mesh.make_mesh(axes, [torch.device("cpu")] * count)
        return
    got = port.core_mesh.make_mesh(axes, [torch.device("cpu")] * count)
    assert got.axis_names == want.axis_names and got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape


@pytest.mark.parametrize("members", [1, 2, 3, 4, 8, 16])
def test_ensemble_and_data_meshes_match_jax(torch, port, members):
    cpu = [torch.device("cpu")] * 8
    assert port.core_mesh.ensemble_mesh(members, cpu).shape == dict(jmesh.ensemble_mesh(members, jax.devices()).shape)
    assert port.core_mesh.data_parallel_mesh(cpu).shape == dict(jmesh.data_parallel_mesh(jax.devices()).shape)


def test_shard_batch_gather_and_no_card(torch, port):
    mesh = port.core_mesh.make_mesh((("member", 2), ("data", 4)), [torch.device("cpu")] * 8)
    x = torch.arange(8 * 3.0).view(8, 3)
    shards = port.core_mesh.shard_batch(x, mesh)
    want = np.asarray(jmesh.shard_batch(np.arange(8 * 3.0).reshape(8, 3), jmesh.make_mesh(
        (("member", 2), ("data", 4)), jax.devices())).addressable_shards[0].data)
    assert len(shards) == 4 and all(s.shape == (2, 3) for s in shards)
    np.testing.assert_array_equal(shards[0].numpy(), want)
    assert torch.equal(port.core_mesh.gather(shards), x)
    with pytest.raises(ValueError, match="does not divide"):
        port.core_mesh.shard_batch(torch.zeros(6, 3), mesh)
    assert mesh.grid("data", "member").shape == (4, 2) and mesh.grid("time").shape == (1,)
    if not torch.cuda.is_available():  # devices=None means the visible cards: none here
        for make in (port.core_mesh.make_mesh, port.core_mesh.data_parallel_mesh,
                     lambda: port.core_mesh.ensemble_mesh(2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_member_assignments_single_process(torch, port):
    """Every k·(k−1) member in one process, in JAX's order (tests/test_parallel.py:86-88)."""
    assert not port.parallel_distributed.is_multi_process()
    for k in (3, 5):
        assert port.parallel.my_member_assignments(k) == jdistributed.my_member_assignments(k)
    assert len(port.parallel.my_member_assignments(5)) == 20
    port.parallel_distributed.initialize_distributed()  # single process: a no-op
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------------------------
# parallel/temporal_halo
# ----------------------------------------------------------------------


@pytest.mark.parametrize("left,right,fill", [(2, 3, 0.0), (1, 1, float("-inf")), (0, 2, 0.0)])
def test_halo_exchange_matches_jax(torch, port, cpu_mesh, left, right, fill):
    x = np.random.default_rng(0).normal(size=(2, 16, 5, 6, 3)).astype(np.float32)
    want = np.asarray(_jax_time_sharded(lambda a: jhalo.halo_exchange(a, left, "time", right, fill))(x))
    got = _port_sharded(torch, port, cpu_mesh, x,
                        lambda s: port.parallel_temporal_halo.halo_exchange(s, left, right, fill))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kt,st", [(7, 2), (3, 2), (7, 1), (3, 1)])
def test_halo_conv3d_matches_jax(torch, port, cpu_mesh, kt, st):
    """TF-SAME with asymmetric spatial pads (7 rows at stride 2, 6 columns)."""
    rng = np.random.default_rng(kt * 10 + st)
    x = rng.normal(size=(2, 32, 7, 6, 3)).astype(np.float32)
    k = (rng.normal(size=(kt, 3, 3, 3, 5)) * 0.2).astype(np.float32)
    strides = (st, 2, 2)
    want = np.asarray(_jax_time_sharded(lambda a: jhalo.halo_conv3d(a, jnp.asarray(k), strides, "time"))(x))
    got = _port_sharded(torch, port, cpu_mesh, x,
                        lambda s: port.parallel_temporal_halo.halo_conv3d(s, _oidhw(k), strides))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    unsharded = jax.lax.conv_general_dilated(x, k, strides, "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    np.testing.assert_allclose(got, np.asarray(unsharded), atol=1e-4)


@pytest.mark.parametrize("window,strides", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                                            ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2))])
def test_halo_max_pool3d_matches_jax(torch, port, cpu_mesh, window, strides):
    """The four I3D pools on odd spatial sizes; equal to the unsharded
    TF-SAME pool too."""
    x = np.random.default_rng(1).normal(size=(2, 16, 7, 9, 4)).astype(np.float32)
    want = np.asarray(_jax_time_sharded(lambda a: jhalo.halo_max_pool3d(a, window, strides, "time"))(x))
    got = _port_sharded(torch, port, cpu_mesh, x,
                        lambda s: port.parallel_temporal_halo.halo_max_pool3d(s, window, strides))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    unsharded = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1,) + window + (1,), (1,) + strides + (1,), "SAME")
    np.testing.assert_array_equal(got, np.asarray(unsharded))


# The halo-padded (T_loc + 2)-frame inputs of the 3³/1 pool in the
# time-sharded trunk of chip_smoke.py phase 24 (a): (2, 64, 224, 224, 3)
# over 4 positions, Mixed_3*, Mixed_4* and Mixed_5*.
HALO_POOL_SHAPES = [(2, 10, 28, 28, 192), (2, 10, 28, 28, 256), (2, 6, 14, 14, 480), (2, 6, 14, 14, 528),
                    (2, 4, 7, 7, 832)]


def test_halo_pool_kernel_form_on_padded_shards(torch, port, monkeypatch):
    """The 3³/1 halo pool hands the max-pool op each halo-padded shard,
    contiguous NTHWC of T_loc + 2 frames; the kernel's walk, emulated on
    those inputs, equals the plain version, and its tiles cover the trunk's
    halo shapes once."""
    from test_torch_kernels import _emulate_maxpool_kernel

    from crowded_scenes_ensemble_classification_tpu_torch.ops.kernels import maxpool

    seen = []
    real = port.parallel_temporal_halo.max_pool_3x3x3_same
    monkeypatch.setattr(port.parallel_temporal_halo, "max_pool_3x3x3_same",
                        lambda x: (seen.append(x), real(x))[1])
    x = torch.randn(2, 8, 5, 7, 16, generator=torch.Generator().manual_seed(0))
    shards = port.parallel_temporal_halo.halo_max_pool3d(list(torch.chunk(x, N, dim=1)), (3, 3, 3), (1, 1, 1))
    assert [tuple(p.shape) for p in seen] == [(2, 4, 5, 7, 16)] * N and all(p.is_contiguous() for p in seen)
    assert torch.equal(torch.cat(shards, 1), maxpool.max_pool_3x3x3_reference(x))
    for p in seen:
        assert torch.equal(_emulate_maxpool_kernel(torch, p, maxpool.max_pool_tiling(p.shape, 4)),
                           maxpool.max_pool_3x3x3_reference(p))
    for shape in HALO_POOL_SHAPES:
        for itemsize in (2, 4):
            tiling = maxpool.max_pool_tiling(shape, itemsize)
            b, _, h, w, c = shape
            count = np.zeros((b, h, w, c), np.int32)
            for block in range(tiling.grid):
                b0, h0, w0, c0 = tiling.tile_origin(block)
                count[b0, h0:h0 + tiling.ht, w0:w0 + tiling.wt, c0:c0 + tiling.cb] += 1
            assert (count == 1).all(), shape


def test_halo_conv_rejects_misaligned_shards(torch, port):
    shards = list(torch.zeros(1, 12, 4, 4, 3).chunk(4, dim=1))  # 3 frames a shard
    with pytest.raises(ValueError, match="not divisible by stride 2"):
        port.parallel_temporal_halo.halo_conv3d(shards, torch.zeros(5, 3, 3, 3, 3), (2, 1, 1))
    with pytest.raises(ValueError, match="not divisible by stride 2"):
        port.parallel_temporal_halo.halo_max_pool3d(shards, (2, 2, 2), (2, 2, 2))


def test_time_sharded_conv_stack_matches_jax(torch, port, cpu_mesh):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 32, 8, 8, 4)).astype(np.float32)
    kernels = [(rng.normal(size=(kt, 3, 3, 4, 4)) * 0.2).astype(np.float32) for kt in (7, 3)]
    want = np.asarray(jhalo.time_sharded_conv_stack(jmesh.make_mesh((("time", N),), jax.devices()[:N]),
                                                    [jnp.asarray(k) for k in kernels])(x))
    fn = port.parallel_temporal_halo.time_sharded_conv_stack(cpu_mesh, [_oidhw(k) for k in kernels])
    got = port.core_mesh.gather(fn(port.parallel_temporal_halo.shard_time(torch.from_numpy(x), cpu_mesh)), dim=1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.fixture(scope="module")
def trunk_case(torch, port):
    """Numpy-seeded flax I3DTrunk variables (lecun-scaled kernels, small BN
    biases, BN statistics planted in [0.5, 1.5]), a (1, 32, 32, 32, 3)
    clip, JAX's time-sharded trunk on it over 4 devices, and the port's
    I3DTrunk loaded with the converted variables."""
    from crowded_scenes_ensemble_classification_tpu.models.i3d import I3DTrunk as JTrunk

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 32, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: JTrunk().init(k, jnp.zeros(x.shape), train=False), jax.random.key(0))

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "bias":
            return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)  # planted mean and var

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    want = np.asarray(jhalo.time_sharded_i3d_trunk(jmesh.make_mesh((("time", N),), jax.devices()[:N]),
                                                   variables)(x))
    trunk = port.models_i3d.I3DTrunk().eval()
    trunk.load_state_dict(port.models_convert.state_dict_from_flax("I3D", variables))
    return x, want, trunk


def test_time_sharded_i3d_trunk_matches_jax(torch, port, cpu_mesh, trunk_case):
    x, want, trunk = trunk_case
    th = port.parallel_temporal_halo
    with torch.inference_mode():
        got = port.core_mesh.gather(th.time_sharded_i3d_trunk(cpu_mesh, trunk)(th.shard_time(torch.from_numpy(x),
                                                                                              cpu_mesh)), dim=1)
        unsharded = trunk(torch.from_numpy(x)).permute(0, 2, 3, 4, 1)  # NCDHW → NTHWC
    assert got.shape == want.shape == (1, 4, 1, 1, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), unsharded.numpy(), atol=2e-3, rtol=1e-4)


def test_time_sharded_i3d_trunk_takes_any_stem_form(torch, port, cpu_mesh, trunk_case):
    """A prestaged-stem trunk holds the canonical 7³ weight: the sharded
    trunk built from it equals the one built from the canonical trunk."""
    x, _, trunk = trunk_case
    prestaged = port.models_i3d.I3DTrunk(stem_prestaged=True).eval()
    prestaged.load_state_dict(trunk.state_dict())
    th = port.parallel_temporal_halo
    two = port.core_mesh.make_mesh((("time", 2),), [torch.device("cpu")] * 2)
    shards = th.shard_time(torch.from_numpy(x[:, :16]), two)
    with torch.inference_mode():
        a = th.time_sharded_i3d_trunk(two, trunk)(shards)
        b = th.time_sharded_i3d_trunk(two, prestaged)(shards)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    with pytest.raises(ValueError, match="not divisible by stride 2"):
        th.time_sharded_i3d_trunk(cpu_mesh, trunk)(list(torch.zeros(1, 12, 32, 32, 3).chunk(N, dim=1)))


# ----------------------------------------------------------------------
# parallel/halo_train
# ----------------------------------------------------------------------

# _ConvBNStack's layers (tests/test_parallel.py:223-237) and the I3D front
# end with a 3³/1 pool (chip_smoke.py phase 24's stack at narrow widths)
TRAIN_STACKS = {
    "convbn_stack": (
        (2, 32, 12, 12, 3),
        [((7, 3, 3), 6, {"strides": (2, 2, 2), "pool": ((3, 3, 3), (2, 2, 2))}),
         ((3, 3, 3), 8, {"strides": (1, 1, 1)})],
    ),
    "i3d_front_end": (
        (1, 32, 16, 16, 3),
        [((7, 7, 7), 8, {"strides": (2, 2, 2), "pool": ((1, 3, 3), (1, 2, 2))}),
         ((1, 1, 1), 8, {"strides": (1, 1, 1)}),
         ((3, 3, 3), 12, {"strides": (1, 1, 1), "pool": ((3, 3, 3), (1, 1, 1))})],
    ),
}


@pytest.mark.parametrize("stack", sorted(TRAIN_STACKS))
def test_halo_train_step_matches_jax(torch, port, cpu_mesh, stack):
    """Loss (rtol 1e-5), gradients (atol 2e-4, rtol 1e-4) and the running
    moments after `update_running_stats` (atol 1e-5) equal JAX's sharded
    step's, which tests/test_parallel.py holds to the unsharded flax step."""
    shape, layers = TRAIN_STACKS[stack]
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    cin, params = shape[-1], []
    for k, f, _ in layers:
        params.append({"kernel": (rng.normal(size=k + (cin, f)) / np.sqrt(np.prod(k) * cin)).astype(np.float32),
                       "bias": (rng.normal(size=(f,)) * 0.1).astype(np.float32)})
        cin = f
    specs = [spec for _, _, spec in layers]
    jstep = jhalo_train.make_time_sharded_convbn_train_step(jmesh.make_mesh((("time", N),), jax.devices()[:N]), specs)
    th = port.parallel_temporal_halo
    target_shape = list(shape)  # TF-SAME: ceil(n / stride) at every conv and pool
    for (k, f, spec) in layers:
        st = spec["strides"]
        target_shape = [target_shape[0]] + [-(-n // s) for n, s in zip(target_shape[1:4], st)] + [f]
        if "pool" in spec:
            ps = spec["pool"][1]
            target_shape = [target_shape[0]] + [-(-n // s) for n, s in zip(target_shape[1:4], ps)] + [f]
    target = rng.normal(size=target_shape).astype(np.float32)
    jloss, jgrads, jstats = jstep(tuple({k: jnp.asarray(v) for k, v in p.items()} for p in params), x, target)

    step = port.parallel_halo_train.make_time_sharded_convbn_train_step(cpu_mesh, specs)
    tparams = tuple({"kernel": _oidhw(p["kernel"]), "bias": torch.from_numpy(p["bias"])} for p in params)
    loss, grads, stats = step(tparams, th.shard_time(torch.from_numpy(x), cpu_mesh),
                              th.shard_time(torch.from_numpy(target), cpu_mesh))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    running = tuple({"mean": np.full(p["bias"].shape, 0.5, np.float32), "var": np.ones_like(p["bias"])}
                    for p in params)
    got_running = port.parallel_halo_train.update_running_stats(
        tuple({k: torch.from_numpy(v) for k, v in r.items()} for r in running), stats)
    want_running = jhalo_train.update_running_stats(running, jstats)
    for i in range(len(layers)):
        np.testing.assert_allclose(grads[i]["kernel"].numpy(), np.asarray(_oidhw(jgrads[i]["kernel"])),
                                   atol=2e-4, rtol=1e-4, err_msg=f"layer {i}")
        np.testing.assert_allclose(grads[i]["bias"].numpy(), np.asarray(jgrads[i]["bias"]), atol=2e-4, rtol=1e-4)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_running[i][k].numpy(), np.asarray(want_running[i][k]), atol=1e-5)
            np.testing.assert_allclose(stats[i][k].numpy(), np.asarray(jstats[i][k]), atol=1e-5)


def test_halo_conv_bn_relu_train_moments_are_global(torch, port):
    """The summed moments are the gathered tensor's biased ones, not a
    shard's: equal to the unsharded conv's mean and E[y²] − E[y]²."""
    th, ht = port.parallel_temporal_halo, port.parallel_halo_train
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 6, 6, 3, generator=gen) + torch.linspace(0, 3, 8).view(1, 8, 1, 1, 1)
    k = torch.randn(5, 3, 3, 3, 3, generator=gen) * 0.2
    y, mean, var = ht.halo_conv_bn_relu_train(list(x.chunk(N, dim=1)), k, torch.zeros(5))
    full = torch.cat(th.halo_conv3d([x], k, (1, 1, 1)), 1).double()
    torch.testing.assert_close(mean.double(), full.mean((0, 1, 2, 3)), atol=1e-5, rtol=0)
    torch.testing.assert_close(var.double(), full.var((0, 1, 2, 3), unbiased=False), atol=1e-5, rtol=0)
    assert len(y) == N and y[0].shape == (2, 2, 6, 6, 5)


# ----------------------------------------------------------------------
# ensemble/members and orchestration over a mesh
# ----------------------------------------------------------------------


def test_member_probabilities_on_mesh_matches_jax(torch, port):
    """tests/test_ensemble.py:287-309's geometry with C3D at width 0.125:
    2 members over ('member', 2) × ('data', 4), 8 clips of 16×32²."""
    from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu.ensemble.members import member_probabilities as j_probs
    from crowded_scenes_ensemble_classification_tpu.models import C3D as JC3D
    from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle

    bundle = ModelBundle(model_type="C3D", module=JC3D(num_classes=3, width=0.125),
                         clip=ClipSpec(frames=16, height=32, width=32), num_classes=3, two_stream=False)
    shapes = jax.eval_shape(lambda k: bundle.init(k), jax.random.key(0))
    variables = []
    for i in range(2):
        rng = np.random.default_rng(10 + i)
        variables.append(jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10.0)
                       ).astype(np.float32), shapes))
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 255, (8, 16, 32, 32, 3)).astype(np.uint8), "label": rng.integers(0, 3, 8),
             "valid": np.ones(8, bool), "index": np.arange(8)}

    class FakePipe:
        def batches(self, epoch=0):
            yield batch

    jm = jmesh.make_mesh((("member", 2), ("data", -1)), jax.devices())
    want = j_probs(bundle, variables, FakePipe(), mesh=jm, input_scale=1 / 255.0)
    members = []
    for v in variables:
        m = port.models_c3d.C3D(3, width=0.125, clip_thw=(16, 32, 32)).eval()
        m.load_state_dict(port.models_convert.state_dict_from_flax("C3D", v))
        members.append(m)
    mesh = port.core_mesh.make_mesh((("member", 2), ("data", -1)), [torch.device("cpu")] * 8)
    mp = port.ensemble_members.member_probabilities
    got = mp(members, [batch], (32, 32), input_scale=1 / 255.0, mesh=mesh)
    assert got.shape == want.shape == (2, 8, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, mp(members, [batch], (32, 32), input_scale=1 / 255.0), atol=1e-6)
    # 3 members do not divide a member axis of 2: the unsharded form, as in JAX
    three = members + members[:1]
    np.testing.assert_array_equal(mp(three, [batch], (32, 32), input_scale=1 / 255.0, mesh=mesh),
                                  mp(three, [batch], (32, 32), input_scale=1 / 255.0))
    forward = port.ensemble_members.make_member_forward(members, (32, 32), input_scale=1 / 255.0, mesh=mesh)
    with pytest.raises(ValueError, match="does not divide"):
        forward({"rgb": torch.from_numpy(batch["rgb"][:6])})
    with pytest.raises(ValueError, match="do not divide"):
        port.ensemble_members.make_member_forward(three, (32, 32), mesh=mesh)


CLASSES, FOLDS = 3, 3
BASE = ["-mt", "C3D", "-fn", str(FOLDS), "--num-classes", str(CLASSES), "-bs", "6", "-e", "1"]


@pytest.fixture(scope="module")
def ws(torch, tmp_path_factory):
    """tests/test_torch_cli.py's workspace: a prepared C3D experiment with
    test fold 0's two members (seeded width-0.125 C3Ds at 16×112²)."""
    from crowded_scenes_ensemble_classification_tpu.data import synthetic as jsynthetic

    orch = importlib.import_module(f"{PORT}.orchestration")
    registry = importlib.import_module(f"{PORT}.models.registry")
    root = tmp_path_factory.mktemp("mesh_cli")
    df = jsynthetic.generate_synthetic_dataset(str(root / "data"), num_scenes=9, clips_per_scene=3,
                                               num_classes=CLASSES, num_frames=16, hw=(40, 40), as_videos=False)
    df.to_csv(root / "clips.csv", index=False)
    table = importlib.import_module(f"{PORT}.data.table").ClipTable.read_csv(str(root / "clips.csv"))
    cfg = importlib.import_module(f"{PORT}.core.config").ExperimentConfig(
        model_type="C3D", folds_number=FOLDS, num_classes=CLASSES, batch_size=6, epochs=1)
    layout = orch.prepare_ensemble(cfg, table, str(root / "work"), device="cpu")
    for v in (1, 2):
        bundle = registry.build_model("C3D", CLASSES, device="cpu", trainable=True, width=0.125,
                                      generator=torch.Generator().manual_seed(v))
        importlib.import_module(f"{PORT}.train.checkpoints").save_best(layout.checkpoint_dir(cfg, 0, v),
                                                                       bundle.module.state_dict())
    return SimpleNamespace(cfg=cfg, layout=layout, work=layout.root, orch=orch, registry=registry)


@pytest.fixture
def tiny_builds(ws, monkeypatch):
    """Every `build_model` the command line reaches builds width-0.125 C3Ds."""
    real = ws.registry.build_model

    def build(model_type, num_classes=11, **kw):
        kw.setdefault("width", 0.125)
        return real(model_type, num_classes, **kw)

    for name in ("models.registry", "models.pretrained", "orchestration"):
        monkeypatch.setattr(importlib.import_module(f"{PORT}.{name}"), "build_model", build)


def test_probs_mesh_data_equals_unsharded(torch, ws, tiny_builds, capsys, tmp_path):
    """`probs --mesh-data 2` (a data mesh: the unsharded form, as in JAX)
    and `cache_probabilities` over a ('member', 2) mesh write the npz of the
    unsharded run; training over a data mesh of 2 positions trains member
    (0, 1) as without one, within bf16's rounding (rtol 1e-2; the
    width-0.125 C3Ds compute in bf16)."""
    pcli = importlib.import_module(f"{PORT}.cli.main")
    store = importlib.import_module(f"{PORT}.ensemble.probability_store")
    got = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh-data", "2"])):
        assert pcli.main(["probs", "--work-dir", ws.work, *BASE, "-t", "0", "--recompute", *extra], device="cpu") == 0
        got[name] = store.load_probabilities(capsys.readouterr().out.strip())
    member_mesh = importlib.import_module(f"{PORT}.core.mesh").make_mesh((("member", 2), ("data", -1)),
                                                                          [torch.device("cpu")] * 2)
    got["member"] = store.load_probabilities(ws.orch.cache_probabilities(
        ws.cfg, ws.layout, 0, recompute=True, device="cpu", mesh=member_mesh))
    assert got["plain"]["probs"].shape == (2, 9, CLASSES)
    for name in ("mesh", "member"):
        for k in ("probs", "labels"):
            np.testing.assert_array_equal(got[name][k], got["plain"][k])
    data_mesh = importlib.import_module(f"{PORT}.core.mesh").make_mesh((("data", 2),), [torch.device("cpu")] * 2)
    trained = {}
    for name, mesh in (("plain", None), ("data", data_mesh)):
        shutil.copytree(ws.work, tmp_path / name)
        trained[name] = ws.orch.train_member(ws.cfg, ws.orch.WorkLayout(str(tmp_path / name)), 0, 1, mesh=mesh,
                                             device="cpu")
    assert trained["data"]["test_loss"] == pytest.approx(trained["plain"]["test_loss"], rel=1e-2)
    assert trained["data"]["history"]["val_loss"] == pytest.approx(trained["plain"]["history"]["val_loss"], rel=1e-2)
