"""One process of tests/test_torch_distributed.py's gloo group.  It imports
the port and no JAX.

    python tests/torch_distributed_worker.py smoke  HOST:PORT PROCESSES RANK
    python tests/torch_distributed_worker.py fanout HOST:PORT PROCESSES RANK WORK_DIR

Both modes join the group (`parallel.distributed.initialize_distributed`),
take this process's `my_member_assignments` (5 folds for `smoke`, 3 for
`fanout`) and all-reduce rank + 1 over gloo.  `fanout` then trains its
members into the shared, prepared WORK_DIR with `orchestration.train_member`
(the counterpart of tests/_distributed_ensemble_worker.py): width-0.125
C3Ds at 16×32², 1 epoch, f32 on the CPU, each from a seeded draw.  The
process leaves the group before it exits and prints ONE JSON line:
{"process_id", "processes", "multi_process", "assignments", "all_reduce",
"trained"}.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES, FOLDS, CLIP_THW, STAGING = 3, 3, (16, 32, 32), (40, 40)


def tiny_c3d(seed: int, trainable: bool):
    """A width-0.125 C3D bundle at 16×32², weights drawn from `seed`."""
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle

    module = C3D(CLASSES, width=0.125, clip_thw=CLIP_THW, generator=torch.Generator().manual_seed(seed))
    return ModelBundle("C3D", module if trainable else module.eval(), ClipSpec(*CLIP_THW), CLASSES, False,
                       trainable=trainable)


def fanout_config():
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ExperimentConfig

    return ExperimentConfig(model_type="C3D", training_condition="_SCRATCH", folds_number=FOLDS,
                            num_classes=CLASSES, batch_size=6, epochs=1, compute_dtype="float32")


def train_assignments(work_dir: str, assignments) -> list:
    from crowded_scenes_ensemble_classification_tpu_torch import orchestration as orch

    config, layout = fanout_config(), orch.WorkLayout(work_dir)
    bundle = tiny_c3d(0, trainable=True)
    trained = []
    for t, v in assignments:
        start = tiny_c3d(1000 * t + v, trainable=True).module.state_dict()
        out = orch.train_member(config, layout, t, v, epochs=1, bundle=bundle, initial_variables=start,
                                input_scale=1 / 255.0, staging_hw=STAGING, num_workers=2, device="cpu")
        trained.append([t, v, float(out["test_loss"])])
    return trained


def main() -> None:
    mode, coordinator, processes, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from crowded_scenes_ensemble_classification_tpu_torch.parallel import distributed

    distributed.initialize_distributed(coordinator, processes, rank, timeout_s=60)
    try:
        assignments = distributed.my_member_assignments(5 if mode == "smoke" else FOLDS)
        total = torch.tensor([rank + 1.0])
        torch.distributed.all_reduce(total)
        record = {"process_id": rank, "processes": distributed.process_count_index()[0],
                  "multi_process": distributed.is_multi_process(), "assignments": assignments,
                  "all_reduce": float(total.item()), "trained": []}
        if mode == "fanout":
            record["trained"] = train_assignments(sys.argv[5], assignments)
            torch.distributed.barrier()  # both members' sets are on disk before either leaves
    finally:
        distributed.shutdown_distributed()
    print(json.dumps(record))


if __name__ == "__main__":
    main()
