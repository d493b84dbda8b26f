"""The data layer: clip tables, folds and splits, decode, the clip cache, the
input pipeline and device-resident datasets (the names the JAX package's
`data/__init__.py` exports, and `ClipTable`, the port's pandas-free table)."""

from .crowd11 import build_clip_table  # noqa: F401
from .folds import (  # noqa: F401
    assign_scenes_to_folds,
    fold_class_histograms,
    generate_folds,
    make_fold_dataframes,
    scene_labels_from_dataframe,
    verify_folds_disjoint,
    write_fold_csvs,
)
from .pipeline import (  # noqa: F401
    BatchPipeline,
    ClipSource,
    SampleSpec,
    class_weights_balanced,
    expand_precomputed_augmentation,
    iterate_batches,
    prefetch_batches,
)
from .resident import ResidentClips  # noqa: F401
from .splits import build_split, load_fold_csvs, split_dir_name, write_split_matrix  # noqa: F401
from .synthetic import generate_synthetic_dataset, make_clip_array  # noqa: F401
from .table import ClipTable  # noqa: F401
from .video_io import decode_clip, decode_flow_pair, video_frame_count, write_video  # noqa: F401
