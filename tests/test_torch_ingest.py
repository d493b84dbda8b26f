"""The port's data ingest against the JAX package's on the CPU: frame
selection, the synthetic dataset, cv2 decode, the clip table, fold and split
CSVs (byte for byte), the native clip cache (shards read across packages),
`BatchPipeline` batches over two epochs, `prefetch_batches`, and the slice
as a whole: `member_probabilities` over a pipeline against JAX's on a small
I3D, and `fit` over a pipeline against `fit` over the same batches held in
memory.

Small sizes throughout: clips of 12 frames at 40×48, 10 scenes of 2 clips,
written once per module as mp4 (rgb) and avi (flow) files by the port's
generator.  torch and the port are imported by fixtures, not at collection
(tests/torch_port_memory.py).
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pandas
import pytest

from crowded_scenes_ensemble_classification_tpu.data import clip_cache as jcache
from crowded_scenes_ensemble_classification_tpu.data import crowd11 as jcrowd11
from crowded_scenes_ensemble_classification_tpu.data import folds as jfolds
from crowded_scenes_ensemble_classification_tpu.data import pipeline as jpipeline
from crowded_scenes_ensemble_classification_tpu.data import splits as jsplits
from crowded_scenes_ensemble_classification_tpu.data import synthetic as jsynthetic
from crowded_scenes_ensemble_classification_tpu.data import video_io as jvideo
from crowded_scenes_ensemble_classification_tpu.ops.temporal import select_frame_indices as j_select
from torch_port_memory import release_heap_after_module, torch  # noqa: F401 (fixtures)

FOLDS, SCENES, CLIPS, CLASSES, FRAMES, HW = 4, 10, 2, 4, 12, (40, 48)


@pytest.fixture(scope="module")
def data(torch):
    import crowded_scenes_ensemble_classification_tpu_torch.data as data

    return data


@pytest.fixture(scope="module")
def dataset(data, tmp_path_factory):
    """(root, port clip table) of mp4/avi clips written by the port."""
    root = str(tmp_path_factory.mktemp("ingest"))
    table = data.generate_synthetic_dataset(root, num_scenes=SCENES, clips_per_scene=CLIPS, num_classes=CLASSES,
                                            num_frames=FRAMES, hw=HW, seed=0, as_videos=True)
    return root, table


@pytest.fixture(scope="module")
def splits(data, dataset, tmp_path_factory):
    """The fold CSVs and split matrix, written by both packages from the
    same clip directory: {"jax": (folds dir, splits dir), "port": ...}."""
    root, _ = dataset
    out = {}
    for side, build, gen, load, write in (
        ("jax", jcrowd11.build_clip_table, jfolds.generate_folds, jsplits.load_fold_csvs, jsplits.write_split_matrix),
        ("port", data.build_clip_table, data.generate_folds, data.load_fold_csvs, data.write_split_matrix),
    ):
        base = tmp_path_factory.mktemp(side)
        folder, _ = gen(build(root), str(base / "folds"), FOLDS)
        write(load(folder, FOLDS), str(base / "splits"))
        out[side] = (folder, str(base / "splits"))
    return out


def split_tables(data, splits, name="test", t=0, v=1):
    """(JAX DataFrame, port ClipTable) of one split CSV."""
    path = lambda side: os.path.join(splits[side][1], f"split_test{t}_val{v}", f"{name}.csv")  # noqa: E731
    return pandas.read_csv(path("jax")), data.ClipTable.read_csv(path("port"))


def assert_batches_equal(jax_batches, port_batches):
    jax_batches, port_batches = list(jax_batches), list(port_batches)
    assert len(jax_batches) == len(port_batches) > 0
    for a, b in zip(jax_batches, port_batches):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("total,n", [(12, 8), (12, 12), (48, 20), (5, 20), (1, 3), (41, 20)])
def test_select_frame_indices_matches_jax(torch, total, n):
    from crowded_scenes_ensemble_classification_tpu_torch.ops.temporal import select_frame_indices

    np.testing.assert_array_equal(select_frame_indices(total, n), j_select(total, n))


def test_synthetic_arrays_bit_equal(data, tmp_path):
    """as_videos=False: the same .npy arrays and the same table rows, drawn
    from the same default_rng stream."""
    kw = dict(num_scenes=3, clips_per_scene=2, num_classes=3, num_frames=5, hw=(12, 16), seed=7, as_videos=False)
    ref = jsynthetic.generate_synthetic_dataset(str(tmp_path / "j"), **kw)
    got = data.generate_synthetic_dataset(str(tmp_path / "p"), **kw)
    assert got.columns == list(ref.columns)
    for a, b in zip(ref.to_dict("records"), got.records()):
        assert b == {k: v.replace(f"{os.sep}j{os.sep}", f"{os.sep}p{os.sep}") if isinstance(v, str) else v
                     for k, v in a.items()}
        for col in ("rgbclips_path", "x_axis_flowclips_path", "y_axis_flowclips_path"):
            np.testing.assert_array_equal(np.load(b[col]), np.load(a[col]))
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(data.make_clip_array(2, rng_b, 4, (8, 8), 5),
                                  jsynthetic.make_clip_array(2, rng_a, 4, (8, 8), 5))


@pytest.mark.parametrize("num_frames,staging,gray", [
    (8, (36, 36), False),   # longer clip: stride selection, resize to a square staging
    (16, None, False),      # shorter clip: cycled, no resize
    (5, (24, 30), True),    # gray, resize to a non-square staging
    (20, (40, 48), True),   # gray, shorter, staging equal to the clip (no resize)
])
def test_decode_matches_jax(data, dataset, num_frames, staging, gray):
    """decode_clip, decode_twostream_staging and decode_flow_pair of the
    same mp4/avi files give JAX's arrays bit for bit."""
    root, table = dataset
    row = table.row(3)
    assert data.video_frame_count(row["rgbclips_path"]) == jvideo.video_frame_count(row["rgbclips_path"]) == FRAMES
    got = data.decode_clip(row["rgbclips_path"], num_frames, staging, gray=gray)
    ref = jvideo.decode_clip(row["rgbclips_path"], num_frames, staging, gray=gray)
    assert got.shape == ref.shape == (num_frames, *(staging or HW), 1 if gray else 3)
    np.testing.assert_array_equal(got, ref)
    from crowded_scenes_ensemble_classification_tpu_torch.data import video_io

    got = video_io.decode_twostream_staging(row["rgbclips_path"], num_frames, staging)
    ref = jvideo.decode_twostream_staging(row["rgbclips_path"], num_frames, staging)
    assert sorted(got) == sorted(ref) == ["gray", "gray_next", "rgb"]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    fx, fy = row["x_axis_flowclips_path"], row["y_axis_flowclips_path"]
    np.testing.assert_array_equal(data.decode_flow_pair(fx, fy, num_frames, staging),
                                  jvideo.decode_flow_pair(fx, fy, num_frames, staging))
    frames = [np.full((2, 2, 1), i, np.uint8) for i in range(3)]
    assert [int(f[0, 0, 0]) for f in video_io._pad_cycle(list(frames), 7)] == \
        [int(f[0, 0, 0]) for f in jvideo._pad_cycle(list(frames), 7)]


def test_write_video_matches_jax(data, tmp_path):
    """write_video: mp4v at 20 fps with the true (width, height): the same
    bytes from both packages."""
    clip = np.random.default_rng(4).integers(0, 256, (6, 20, 28, 3), dtype=np.uint8)
    data.write_video(str(tmp_path / "p.mp4"), clip)
    jvideo.write_video(str(tmp_path / "j.mp4"), clip)
    assert (tmp_path / "p.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    assert data.decode_clip(str(tmp_path / "p.mp4"), 6).shape == (6, 20, 28, 3)


@pytest.mark.parametrize("with_database", [False, True])
def test_build_clip_table_matches_jax(data, dataset, tmp_path, with_database):
    """The same rows, with and without a database CSV that re-labels and
    re-scenes some clips (and names one that is not on disk)."""
    root, table = dataset
    db = None
    if with_database:
        db = str(tmp_path / "db.csv")
        pandas.DataFrame({
            "video_name": ["clip.mp4", "missing.mp4"],  # inner name of every clip: {label}_{scene}_{idx}_clip
            "scene_number": [77, 78],
            "label": [9, 8],
        }).to_csv(db, index=False)
    ref = jcrowd11.build_clip_table(root, db)
    got = data.build_clip_table(root, db)
    assert got.columns == list(ref.columns)
    assert got.records() == ref.to_dict("records")
    assert len(got) == SCENES * CLIPS
    if with_database:
        assert set(got["label"].tolist()) == {9}


def test_folds_and_split_matrix_byte_equal(data, dataset, splits):
    """Fold CSVs and every split CSV of the k×(k−1) matrix equal JAX's
    pandas files byte for byte; the folds are the same scene sets; the
    histograms agree; an existing split CSV is kept unless overwrite."""
    jf, js = splits["jax"]
    pf, ps = splits["port"]
    for i in range(FOLDS):
        name = f"fold{i}.csv"
        assert open(os.path.join(pf, name), "rb").read() == open(os.path.join(jf, name), "rb").read()
    pairs = data.write_split_matrix(data.load_fold_csvs(pf, FOLDS), ps)  # existing files: kept
    assert len(pairs) == FOLDS * (FOLDS - 1)
    for t, v, d in pairs:
        assert os.path.basename(d) == jsplits.split_dir_name(t, v)
        for name in ("train", "val", "test"):
            rel = os.path.join(jsplits.split_dir_name(t, v), f"{name}.csv")
            assert open(os.path.join(ps, rel), "rb").read() == open(os.path.join(js, rel), "rb").read(), rel
    root, _ = dataset
    jtable, table = jcrowd11.build_clip_table(root), data.build_clip_table(root)
    scenes_j = jfolds.assign_scenes_to_folds(jfolds.scene_labels_from_dataframe(jtable), FOLDS)
    scenes_p = data.assign_scenes_to_folds(data.scene_labels_from_dataframe(table), FOLDS)
    assert [[int(s) for s in f] for f in scenes_p] == [[int(s) for s in f] for f in scenes_j]
    assert data.verify_folds_disjoint(scenes_p) and not data.verify_folds_disjoint([[1, 2], [2]])
    np.testing.assert_array_equal(data.fold_class_histograms(table, scenes_p, CLASSES),
                                  jfolds.fold_class_histograms(jtable, scenes_j, CLASSES))
    path = os.path.join(ps, jsplits.split_dir_name(0, 1), "test.csv")
    open(path, "w").write("kept\n")
    data.write_split_matrix(data.load_fold_csvs(pf, FOLDS), ps)
    assert open(path).read() == "kept\n"
    data.write_split_matrix(data.load_fold_csvs(pf, FOLDS), ps, overwrite=True)
    assert open(path, "rb").read() == open(os.path.join(js, jsplits.split_dir_name(0, 1), "test.csv"), "rb").read()


@pytest.mark.parametrize("writer_side", ["jax", "port"])
def test_clip_cache_shards_cross_read(torch, tmp_path, writer_side):
    """A shard written by one package's ClipCacheWriter is read by the
    other's reader: every clip, label and key, and read_batch (with repeats)
    equal to the writer side's own reader."""
    from crowded_scenes_ensemble_classification_tpu_torch.data import clip_cache as pcache

    write, read = (jcache, pcache) if writer_side == "jax" else (pcache, jcache)
    rng = np.random.default_rng(5)
    clips = [rng.integers(0, 256, (4, 10, 12, 3), dtype=np.uint8) for _ in range(6)]
    path = str(tmp_path / "clips.ccache")
    w = write.ClipCacheWriter(path)
    for i, c in enumerate(clips):
        w.add(f"k{i}", c, label=i % 4)
    w.finish()
    assert not os.path.exists(path + ".tmp")
    r, own = read.ClipCacheReader(path), write.ClipCacheReader(path)
    assert len(r) == 6 and r.keys == own.keys == {f"k{i}": i for i in range(6)}
    for i, c in enumerate(clips):
        clip, label = r.read(i)
        np.testing.assert_array_equal(clip, c)
        assert label == i % 4 and r.shape(i) == own.shape(i)
    idx = [5, 0, 3, 3, 1]
    got, ref = r.read_batch(idx, num_threads=3), own.read_batch(idx, num_threads=2)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype == np.int32
    r.close()
    own.close()
    assert pcache.cache_path_for("abc", "/d") == jcache.cache_path_for("abc", "/d")


PIPELINE_CASES = {
    "shuffled": dict(spec=(8, (36, 36)), bs=4),
    "tiled": dict(spec=(8, (24, 30)), bs=3, augmentation_frequency=2),
    "unshuffled_padded": dict(spec=(5, (32, 32)), bs=4, shuffle=False),
    "drop_last": dict(spec=(8, (32, 32)), bs=4, drop_last=True, augmentation_frequency=2),
    "cached": dict(spec=(8, (36, 36)), bs=4, cache=True),
    "two_stream_flow": dict(spec=(6, (32, 32), True, True), bs=3),
    "two_stream_gray_pairs": dict(spec=(6, (32, 40), True, False), bs=4),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_batch_pipeline_matches_jax(data, splits, tmp_path, case):
    """BatchPipeline over a train split CSV: two epochs of batches equal to
    JAX's key for key (rgb, flow or gray pairs, label, valid, index) and the
    same length; the cache route populates a shard on the first epoch and
    reads it after."""
    kw = dict(PIPELINE_CASES[case])
    spec, bs, cache = kw.pop("spec"), kw.pop("bs"), kw.pop("cache", False)
    jdf, pdf = split_tables(data, splits, "train")
    jpipe = jpipeline.BatchPipeline(jdf, jpipeline.SampleSpec(*spec), bs, seed=3, num_workers=2,
                                    cache_file=str(tmp_path / "j.ccache") if cache else None, **kw)
    ppipe = data.BatchPipeline(pdf, data.SampleSpec(*spec), bs, seed=3, num_workers=2,
                               cache_file=str(tmp_path / "p.ccache") if cache else None, **kw)
    assert len(ppipe) == len(jpipe)
    for epoch in (0, 1):
        np.testing.assert_array_equal(ppipe.epoch_indices(epoch), jpipe.epoch_indices(epoch))
        assert_batches_equal(jpipe.batches(epoch), ppipe.batches(epoch))
    if cache:
        assert ppipe.cached and os.path.exists(str(tmp_path / "p.ccache"))
        assert_batches_equal(jpipe.batches(2), data.BatchPipeline(  # a new pipeline reads the finished shard
            pdf, data.SampleSpec(*spec), bs, seed=3, num_workers=2, cache_file=str(tmp_path / "p.ccache")).batches(2))


def test_stale_cache_shard_is_rebuilt(data, splits, tmp_path):
    """A shard whose clip count is not the table's is dropped and rebuilt."""
    _, pdf = split_tables(data, splits, "test")
    path = str(tmp_path / "c.ccache")
    spec = data.SampleSpec(4, (16, 16))
    data.BatchPipeline(pdf.take([0, 1]), spec, 2, cache_file=path, num_workers=2).populate()
    pipe = data.BatchPipeline(pdf, spec, 2, cache_file=path, num_workers=2, shuffle=False)
    assert not pipe.cached
    assert_batches_equal(data.BatchPipeline(pdf, spec, 2, num_workers=2, shuffle=False).batches(0), pipe.batches(0))
    assert pipe.cached


def test_expand_precomputed_augmentation_matches_jax(data, splits):
    jdf, pdf = split_tables(data, splits, "val")
    for i in range(2):
        jdf[f"rgbclips_augmented_{i}_path"] = jdf["rgbclips_path"] + f".aug{i}.mp4"
    pdf = data.ClipTable({**{c: pdf[c] for c in pdf.columns},
                          **{f"rgbclips_augmented_{i}_path": [p + f".aug{i}.mp4" for p in pdf["rgbclips_path"]]
                             for i in range(2)}})
    ref = jpipeline.expand_precomputed_augmentation(jdf, 2)
    got = data.expand_precomputed_augmentation(pdf, 2)
    assert got.columns == list(ref.columns)
    assert [{k: (None if isinstance(v, float) else v) for k, v in r.items()} for r in ref.to_dict("records")] == \
        [{k: (None if v == "" else v) for k, v in r.items()} for r in got.records()]
    with pytest.raises(KeyError):
        data.expand_precomputed_augmentation(pdf, 3)


def _settled_thread_count(before: int) -> int:
    deadline = time.time() + 30
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    return threading.active_count()


def test_prefetch_early_exit_and_errors(data, splits):
    """A consumer that takes two batches and breaks leaves no producer or
    decode thread running (as JAX tests/test_data.py::
    test_prefetch_batches_early_exit_releases_producer), a full pass still
    yields every batch, `iterate_batches` closes its prefetch on leaving
    the block, and a producer error is raised in the consumer after the
    batches before it."""
    _, pdf = split_tables(data, splits, "train")
    pipe = data.BatchPipeline(pdf, data.SampleSpec(4, (16, 16)), 1, num_workers=2)
    assert len(pipe) > 4  # more batches than the queue holds, so the producer would block
    before = threading.active_count()
    taken = []
    for batch in data.prefetch_batches(pipe, epoch=0):
        taken.append(batch)
        if len(taken) == 2:
            break
    assert len(taken) == 2 and _settled_thread_count(before) <= before
    assert sum(1 for _ in data.prefetch_batches(pipe, epoch=1)) == len(pipe)
    with data.iterate_batches(pipe, 0) as batches:
        next(batches)
    assert _settled_thread_count(before) <= before

    class Failing(data.BatchPipeline):
        def batches(self, epoch=0):
            yield from list(super().batches(epoch))[:2]
            raise IOError("decode failed")

    bad = Failing(pdf, data.SampleSpec(4, (16, 16)), 2, num_workers=2)
    seen = []
    with pytest.raises(IOError, match="decode failed"):
        for batch in data.prefetch_batches(bad, 0):
            seen.append(batch)
    assert len(seen) == 2 and _settled_thread_count(before) <= before


def test_resident_from_pipeline(torch, data, splits, tmp_path):
    """ResidentClips.from_pipeline holds the pipeline's decoded samples in
    row order (decode route and cache route alike) and carries over its
    shuffle, seed, tiling and drop_last."""
    _, pdf = split_tables(data, splits, "train")
    spec = data.SampleSpec(6, (24, 24))
    for cache in (None, str(tmp_path / "r.ccache")):
        pipe = data.BatchPipeline(pdf, spec, 3, seed=5, augmentation_frequency=2, drop_last=True, num_workers=2,
                                  cache_file=cache)
        res = data.ResidentClips.from_pipeline(pipe, device="cpu")
        ref = data.ClipSource(spec)
        rows = [ref(pdf.row(i)) for i in range(len(pdf))]
        np.testing.assert_array_equal(res.resident["rgb"].numpy(), np.stack([r["rgb"] for r in rows]))
        np.testing.assert_array_equal(res.resident["label"].numpy(), [r["label"] for r in rows])
        assert (res.seed, res.tile, res.drop_last, res.batch_size, len(res)) == (5, 2, True, 3, len(pipe))


@pytest.fixture(scope="module")
def i3d_member(torch):
    """A full-width I3D for 12 × 32² clips: numpy-seeded flax variables
    (the head scaled by 0.01, so the softmax is not saturated), converted
    into the port's prestaged I3D, f32."""
    from test_torch_zoo import fill_variables, flax_shapes

    from crowded_scenes_ensemble_classification_tpu.models import i3d as ji3d
    from crowded_scenes_ensemble_classification_tpu_torch.models import convert
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D

    flax_mod = ji3d.I3D(num_classes=CLASSES)
    variables = fill_variables(flax_shapes(flax_mod, (1, FRAMES, 32, 32, 3)), 60)
    variables["params"]["predictions"]["kernel"] *= 0.01
    with torch.device("meta"):
        member = I3D(CLASSES, frames=FRAMES, stem_prestaged=True)
    member.load_state_dict(convert.state_dict_from_flax("I3D", variables), strict=True, assign=True)
    return flax_mod, variables, member.eval()


def test_member_probabilities_over_pipeline_matches_jax(torch, data, splits, i3d_member):
    """The slice as a whole: the split matrix's test CSV → BatchPipeline
    (cv2 decode of 12 frames, resize 40×48 → 36², a padded last batch) →
    member_probabilities of an I3D member (resize to 32², × 1/255, shared
    stem staging) against the JAX function over the JAX pipeline, within
    1e-4; the same over the batches held in memory, equal."""
    from crowded_scenes_ensemble_classification_tpu.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu.ensemble.members import member_probabilities as j_probs
    from crowded_scenes_ensemble_classification_tpu.models.registry import ModelBundle as JBundle
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import member_probabilities

    flax_mod, variables, member = i3d_member
    jdf, pdf = split_tables(data, splits, "test")
    spec = (FRAMES, (36, 36))
    jpipe = jpipeline.BatchPipeline(jdf, jpipeline.SampleSpec(*spec), 4, shuffle=False, num_workers=2)
    ppipe = data.BatchPipeline(pdf, data.SampleSpec(*spec), 4, shuffle=False, num_workers=2)
    assert len(pdf) % 4 != 0  # the last batch is padded
    bundle = JBundle("I3D", flax_mod, ClipSpec(FRAMES, 32, 32), CLASSES, False)
    ref = j_probs(bundle, [variables], jpipe, input_scale=1 / 255.0)
    got = member_probabilities([member], ppipe, (32, 32), input_scale=1 / 255.0)
    assert got.shape == ref.shape == (1, len(pdf), CLASSES)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got.sum(-1) - 1).max() < 1e-5
    held = list(ppipe.batches(0))
    np.testing.assert_array_equal(member_probabilities([member], held, (32, 32), input_scale=1 / 255.0), got)


def test_calibrate_members_over_pipeline_stops_its_producer(torch, data, splits, i3d_member):
    """calibrate_members takes the first batch of a pipeline's prefetch and
    leaves no producer thread behind; its members equal those calibrated on
    that batch held in memory (the same static probabilities)."""
    from crowded_scenes_ensemble_classification_tpu_torch.ensemble.members import (
        calibrate_members,
        member_probabilities,
    )
    from crowded_scenes_ensemble_classification_tpu_torch.models.i3d import I3D

    _, _, member = i3d_member
    _, pdf = split_tables(data, splits, "train")
    pipe = data.BatchPipeline(pdf, data.SampleSpec(FRAMES, (32, 32)), 4, shuffle=False, num_workers=2)
    first = next(iter(pipe.batches(0)))

    def calib():
        m = I3D(CLASSES, frames=FRAMES, stem_prestaged=True, quant="calib")
        m.load_state_dict(member.state_dict(), strict=False)
        return m.eval()

    before = threading.active_count()
    a = calibrate_members([calib()], pipe, (32, 32), num_batches=1, input_scale=1 / 255.0)
    assert _settled_thread_count(before) <= before
    b = calibrate_members([calib()], [first], (32, 32), num_batches=1, input_scale=1 / 255.0)
    np.testing.assert_array_equal(member_probabilities(a, [first], (32, 32), input_scale=1 / 255.0),
                                  member_probabilities(b, [first], (32, 32), input_scale=1 / 255.0))


class _Held:
    """The pipeline's batches of each epoch, decoded up front and held in
    memory, with its table for the balanced-class hook."""

    def __init__(self, pipeline, epochs):
        self.df = pipeline.df
        self._batches = {e: list(pipeline.batches(e)) for e in range(epochs)}

    def batches(self, epoch):
        return iter(self._batches[epoch])


def test_fit_over_pipeline_equals_held_batches(torch, data, splits):
    """fit of a small trainable R3D-18 over BatchPipelines (augment on,
    balanced classes, 2 epochs, a val pipeline) gives the history of fit
    over the same batches held in memory, exactly, and the same weights."""
    from crowded_scenes_ensemble_classification_tpu_torch.models import build_model
    from crowded_scenes_ensemble_classification_tpu_torch.train import fit

    _, train_df = split_tables(data, splits, "train")
    _, val_df = split_tables(data, splits, "val")
    spec = data.SampleSpec(8, (36, 36))
    train = data.BatchPipeline(train_df, spec, 4, seed=1, num_workers=2)
    val = data.BatchPipeline(val_df, spec, 4, shuffle=False, num_workers=2)
    runs = []
    for pair in ((train, val), (_Held(train, 2), _Held(val, 1))):
        gen = torch.Generator().manual_seed(0)
        bundle = build_model("R3D_18", CLASSES, device="cpu", generator=gen, trainable=True, width=0.125)
        bundle = dataclasses.replace(bundle, clip=dataclasses.replace(bundle.clip, frames=8, height=32, width=32))
        out = fit(bundle, *pair, epochs=2, seed=2, augment=True, balanced_classes=True, input_scale=1 / 255.0)
        runs.append((out["history"], {k: v.clone() for k, v in bundle.module.state_dict().items()}))
    (h1, s1), (h2, s2) = runs
    assert h1 == h2 and len(h1["loss"]) == 2 and all(np.isfinite(h1["loss"]))
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
