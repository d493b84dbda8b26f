"""Split-matrix builder: the k×(k−1) grid of (test, val) fold pairs.

Counterpart of `crowded_scenes_ensemble_classification_tpu/data/splits.py`
(lines 1-62), the reference launcher's loop (launch_train_ensemble.py:
117-142): for every test fold t and every val fold v ≠ t, train is the
other k−2 folds in order; `split_test{t}_val{v}/{train,val,test}.csv` are
written byte-equal to the JAX package's pandas files.  Existing split CSVs
are kept unless `overwrite` (launch_train_ensemble.py:130-142).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

from ..core.config import split_pairs
from .table import ClipTable, concat


def split_dir_name(test_index: int, val_index: int) -> str:
    return f"split_test{test_index}_val{val_index}"


def build_split(fold_dfs: Sequence[ClipTable], test_index: int, val_index: int) -> Dict[str, ClipTable]:
    k = len(fold_dfs)
    return {
        "train": concat([fold_dfs[i] for i in range(k) if i not in (test_index, val_index)]),
        "val": fold_dfs[val_index],
        "test": fold_dfs[test_index],
    }


def write_split_matrix(
    fold_dfs: Sequence[ClipTable],
    splits_folder: str,
    overwrite: bool = False,
) -> List[Tuple[int, int, str]]:
    """Write every split_test{t}_val{v} directory.  Returns [(t, v, dir)]
    for all k·(k−1) pairs."""
    out = []
    for t, v in split_pairs(len(fold_dfs)):
        d = os.path.join(splits_folder, split_dir_name(t, v))
        os.makedirs(d, exist_ok=True)
        for name, table in build_split(fold_dfs, t, v).items():
            path = os.path.join(d, f"{name}.csv")
            if overwrite or not os.path.exists(path):
                table.to_csv(path)
        out.append((t, v, d))
    return out


def load_fold_csvs(folds_folder: str, nb_folds: int) -> List[ClipTable]:
    return [ClipTable.read_csv(os.path.join(folds_folder, f"fold{i}.csv")) for i in range(nb_folds)]
